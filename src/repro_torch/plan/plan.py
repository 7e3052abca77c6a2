"""Versioned, JSON-serializable deployment plans (``repro.plan.plan``).

A :class:`DeployPlan` connects the two halves of the DeepBurning-MixQ
flow: the *search* side (DSP-packing LUTs steering per-layer bit-width
selection, :mod:`repro_torch.plan.search`) and the *serving* side (the
prepacked packed-matmul kernels behind :mod:`repro_torch.serving`).  One
plan records, per layer:

  * the selected ``(w_bits, a_bits)`` pair,
  * the kernel-packing placement the serving kernel will use
    (``n_seg``/``stride``/``acc_chunk``/``overlap`` from
    :func:`repro_torch.kernels.packed_matmul.ops.choose_config`) plus the
    LUT's T_mul score,
  * the autotuned kernel K-tile (``block_k``; None = whole K),
  * predicted per-decode-step cost (mul ops, LUT-weighted DSP ops,
    packed weight bytes).

Plans validate against a schema, carry a content hash (stable across
re-serialization, and equal to the reference's for the same plan: the
payload and its canonical JSON are the reference's byte for byte), and
round-trip through JSON under ``artifacts/plans/``.
:mod:`repro_torch.plan.apply` turns a plan plus float params into a
serveable mixed-precision model.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Any

# v2: LayerPlan grew the ``overlap`` placement field (overpacked kernel
# path).  v1 artifacts fail loudly (schema + content-hash mismatch) —
# recompile with ``python -m repro_torch.plan.compile``.
PLAN_SCHEMA_VERSION = 2

# repo root when running from the source tree (src/repro_torch/plan/plan.py)
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
PLANS_DIR = _REPO_ROOT / "artifacts" / "plans"

_VALID_FAMILIES = ("attn", "ssm", "convnet")
_VALID_SOURCES = ("search", "nas", "uniform")


class PlanError(ValueError):
    """Schema violation / corrupt plan artifact."""


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's deployment decision."""

    index: int
    name: str
    w_bits: int
    a_bits: int
    # kernel-packing placement (n_seg 1 => no profitable packing; the
    # layer takes the plain integer path).  ``overlap=1``
    # marks an overpacked placement: the serving kernel runs the Fig. 3
    # LSB-recovery peel against a masked view of the packed weights.
    n_seg: int = 1
    stride: int = 0
    acc_chunk: int = 1
    overlap: int = 0
    t_mul: float = 1.0
    # autotuned kernel K-tile (None => whole K)
    block_k: int | None = None
    # predicted per-decode-step cost of this layer
    cost: dict = dataclasses.field(default_factory=dict)

    @property
    def bits(self) -> tuple[int, int]:
        return (self.w_bits, self.a_bits)


@dataclasses.dataclass
class DeployPlan:
    """A complete, serveable per-layer mixed-precision assignment."""

    arch: str  # registry key (e.g. "llama3.2-3b"); convnet spec name for NAS plans
    family: str  # attn | ssm | convnet
    source: str  # search | nas | uniform
    profile: str  # multiplier profile the packing scores came from
    layers: list[LayerPlan]
    lm_head: LayerPlan | None = None
    smoke: bool = True  # which config variant the layer shapes refer to
    budget: dict = dataclasses.field(default_factory=dict)
    predicted: dict = dataclasses.field(default_factory=dict)
    autotune: dict = dataclasses.field(default_factory=dict)
    version: int = PLAN_SCHEMA_VERSION

    # -- derived -----------------------------------------------------------

    def bit_pairs(self) -> list[tuple[int, int]]:
        return [l.bits for l in self.layers]

    @property
    def uniform(self) -> bool:
        """True when every layer shares one (bits, block) choice — the
        stacked-scan serving layout stays valid."""
        sig = {(l.w_bits, l.a_bits, l.block_k) for l in self.layers}
        return len(sig) <= 1

    @property
    def n_distinct_bit_pairs(self) -> int:
        return len(set(self.bit_pairs()))

    # -- validation --------------------------------------------------------

    def validate(self) -> "DeployPlan":
        if self.version != PLAN_SCHEMA_VERSION:
            raise PlanError(
                f"plan schema v{self.version} != supported v{PLAN_SCHEMA_VERSION}"
            )
        if self.family not in _VALID_FAMILIES:
            raise PlanError(f"unknown family {self.family!r}")
        if self.source not in _VALID_SOURCES:
            raise PlanError(f"unknown source {self.source!r}")
        if not self.layers:
            raise PlanError("plan has no layers")
        for i, l in enumerate(self.layers):
            if l.index != i:
                raise PlanError(f"layer {i} has index {l.index} (must be contiguous)")
            for tag, b in (("w_bits", l.w_bits), ("a_bits", l.a_bits)):
                if not 1 <= b <= 16:
                    raise PlanError(f"layer {i}: {tag}={b} outside [1, 16]")
            if l.n_seg < 1 or l.acc_chunk < 1:
                raise PlanError(f"layer {i}: n_seg/acc_chunk must be >= 1")
            if l.overlap not in (0, 1):
                raise PlanError(f"layer {i}: overlap={l.overlap} (only 1-bit overpacking)")
            if l.block_k is not None and l.block_k < 1:
                raise PlanError(f"layer {i}: block_k={l.block_k} must be positive or null")
        if self.lm_head is not None:
            for tag, b in (("w_bits", self.lm_head.w_bits), ("a_bits", self.lm_head.a_bits)):
                if not 1 <= b <= 16:
                    raise PlanError(f"lm_head {tag}={b} outside [1, 16]")
        return self

    # -- serialization -----------------------------------------------------

    def to_payload(self) -> dict:
        p = {
            "version": self.version,
            "arch": self.arch,
            "family": self.family,
            "source": self.source,
            "profile": self.profile,
            "smoke": self.smoke,
            "budget": self.budget,
            "predicted": self.predicted,
            "autotune": self.autotune,
            "layers": [dataclasses.asdict(l) for l in self.layers],
            "lm_head": dataclasses.asdict(self.lm_head) if self.lm_head else None,
        }
        return p

    def content_hash(self) -> str:
        """Stable digest of the plan *content* (excluding the stored hash
        itself): canonical JSON with sorted keys."""
        blob = json.dumps(self.to_payload(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    @classmethod
    def from_payload(cls, payload: dict) -> "DeployPlan":
        try:
            layers = [LayerPlan(**l) for l in payload["layers"]]
            head = payload.get("lm_head")
            plan = cls(
                arch=payload["arch"],
                family=payload["family"],
                source=payload["source"],
                profile=payload["profile"],
                layers=layers,
                lm_head=LayerPlan(**head) if head else None,
                smoke=payload.get("smoke", True),
                budget=payload.get("budget", {}),
                predicted=payload.get("predicted", {}),
                autotune=payload.get("autotune", {}),
                version=payload.get("version", -1),
            )
        except (KeyError, TypeError) as e:
            raise PlanError(f"malformed plan payload: {e}") from e
        plan.validate()
        stored = payload.get("content_hash")
        if stored is not None and stored != plan.content_hash():
            raise PlanError(
                f"content hash mismatch: stored {stored}, computed {plan.content_hash()}"
            )
        return plan

    def save(self, path: str | pathlib.Path | None = None, *, name: str | None = None) -> pathlib.Path:
        """Write the plan (with its content hash) as JSON; returns the path.

        Default location is ``artifacts/plans/<arch>-<source>-<hash>.json``.
        """
        self.validate()
        if path is None:
            stem = name or f"{self.arch.replace('.', '_')}-{self.source}-{self.content_hash()[:8]}"
            path = PLANS_DIR / f"{stem}.json"
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = self.to_payload()
        payload["content_hash"] = self.content_hash()
        path.write_text(json.dumps(payload, indent=1) + "\n")
        return path

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "DeployPlan":
        try:
            payload = json.loads(pathlib.Path(path).read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise PlanError(f"cannot read plan {path}: {e}") from e
        return cls.from_payload(payload)


def summarize(plan: DeployPlan) -> str:
    """One-paragraph human summary (CLI output, bench logs)."""
    pairs = plan.bit_pairs()
    hist: dict[tuple[int, int], int] = {}
    for p in pairs:
        hist[p] = hist.get(p, 0) + 1
    mix = ", ".join(f"w{w}a{a}x{n}" for (w, a), n in sorted(hist.items()))
    pred = plan.predicted
    extras = []
    if "weight_bytes" in pred:
        extras.append(f"{pred['weight_bytes'] / 1024:.1f} KiB packed weights")
    if "dsp_ops" in pred:
        extras.append(f"{pred['dsp_ops']:.3g} LUT-weighted ops/step")
    head = f", head w{plan.lm_head.w_bits}a{plan.lm_head.a_bits}" if plan.lm_head else ""
    n_over = sum(1 for l in plan.layers if l.overlap)
    over = f", {n_over} overpacked" if n_over else ""
    return (
        f"{plan.arch} [{plan.family}/{plan.source}] {len(plan.layers)} layers: "
        f"{mix}{head}{over}"
        + (f" ({'; '.join(extras)})" if extras else "")
        + f" hash={plan.content_hash()}"
    )
