"""Plan search (``repro.plan.search``): per-layer (w_bits, a_bits)
selection for the serving families, scored by the DSP-packing LUTs and a
serving cost model.

The paper's §V idea lifted off convnets and onto the serving stack:
serving plans come from a deterministic **beam search** over the
per-layer bit space.  Each candidate assignment is scored by

  * a *quality proxy* — depth-sensitivity-weighted log-bit utility
    (first/last layers are the classic high-sensitivity spots, so they
    resist aggressive quantization), and
  * a *cost* — packed weight bytes (footprint objective) or LUT-weighted
    multiply operations, Eq. 6's ``Op / T_mul`` applied to the decode
    step's matmuls (latency objective),

and the search maximizes quality under a cost budget.  The result equals
the reference's plan for the same inputs, content hash included.  The
NAS adapter (``plan_from_nas_result``) turns a convnet search result
(``repro_torch.core.nas``) into the same artifact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.core.packing import TPU_VPU15, MulProfile, PackingLUT, cached_luts
from repro_torch.kernels import build
from repro_torch.kernels.packed_matmul.ops import choose_config
from repro_torch.plan.plan import DeployPlan, LayerPlan

DEFAULT_BIT_CHOICES = (2, 3, 4, 5, 6, 8)
# the LUT cache lives beside the kernel builds (git-ignored): a checkout
# has none, so the first search builds the LUT in-process and writes it here
DEFAULT_LUT_PATH = build.BUILD_DIR / "packing_luts.json"


@dataclasses.dataclass(frozen=True)
class ProjShape:
    """One decode-step matmul: [m, k] @ [k, n], ``count`` instances."""

    name: str
    m: int
    k: int
    n: int
    count: int = 1

    @property
    def mul_ops(self) -> float:
        return float(self.m * self.k * self.n * self.count)

    @property
    def weights(self) -> float:
        return float(self.k * self.n * self.count)


def serving_lut(
    profile: MulProfile = TPU_VPU15, *, path=None, method: str = "runtime"
) -> PackingLUT:
    """The kernel_len=1 (pure matmul) LUT for the serving profile, via the
    single-file cache at ``path`` (default :data:`DEFAULT_LUT_PATH`): built
    in-process on a miss, loaded on later calls.

    ``method="runtime"`` scores exactly the placements the serving
    kernels execute (shared selection helper, overpacking included), so
    search T_mul and served T_mul agree.
    """
    path = DEFAULT_LUT_PATH if path is None else path
    return cached_luts(path, profile=profile, kernel_lens=(1,), method=method)[1]


def layer_matmul_shapes(cfg, n_slots: int = 8) -> list[list[ProjShape]]:
    """Per-layer decode-step matmul shapes for the serving families.

    ``m`` is the serving batch (decode feeds one token per slot).  MoE
    expert projections count ``top_k`` active experts per token (the
    routed compute; all ``n_experts`` copies still count toward weight
    footprint via :func:`layer_cost`'s storage term).
    """
    d, m = cfg.d_model, n_slots
    out: list[list[ProjShape]] = []
    if cfg.family == "attn":
        H, G, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
        for _ in range(cfg.n_layers):
            projs = [
                ProjShape("attn_q", m, d, H * hd),
                ProjShape("attn_k", m, d, G * hd),
                ProjShape("attn_v", m, d, G * hd),
                ProjShape("attn_o", m, H * hd, d),
            ]
            if cfg.is_moe:
                f = cfg.expert_d_ff
                k_active = max(1, cfg.top_k)
                n_proj = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
                projs += [
                    ProjShape("moe_up", m, d, f, count=k_active),
                    ProjShape("moe_down", m, f, d, count=k_active),
                ]
                if n_proj == 3:
                    projs.append(ProjShape("moe_gate", m, d, f, count=k_active))
            else:
                projs += [
                    ProjShape("mlp_up", m, d, cfg.d_ff),
                    ProjShape("mlp_down", m, cfg.d_ff, d),
                ]
                if cfg.mlp_kind in ("swiglu", "geglu"):
                    projs.append(ProjShape("mlp_gate", m, d, cfg.d_ff))
            out.append(projs)
    elif cfg.family == "ssm":
        s = cfg.ssm_spec()
        conv_dim = s.d_inner + 2 * s.d_state
        for _ in range(cfg.n_layers):
            out.append(
                [
                    ProjShape("ssm_in_z", m, d, s.d_inner),
                    ProjShape("ssm_in_xbc", m, d, conv_dim),
                    ProjShape("ssm_out", m, s.d_inner, d),
                ]
            )
    else:
        raise NotImplementedError(
            f"plan search covers attn/ssm serving families, not {cfg.family!r}"
        )
    return out


def packed_word_count(k: int, n: int, w_bits: int, a_bits: int) -> float:
    """int32 words the serving kernel actually stores for a [k, n] weight:
    ``k * ceil(n / n_seg)`` packed (N pads up to a segment multiple), or
    ``k * n`` for the plain-int fallback when no placement exists."""
    cfg = choose_config(w_bits, a_bits)
    if cfg is None:
        return float(k * n)
    return float(k * (-(-n // cfg.n_seg)))


def layer_cost(
    cfg, projs: list[ProjShape], w_bits: int, a_bits: int, lut: PackingLUT
) -> dict:
    """Predicted per-decode-step cost of one layer at one bit pair."""
    mul_ops = sum(p.mul_ops for p in projs)
    t_mul = lut.t_mul(w_bits, a_bits)
    bytes_ = 0.0
    for p in projs:
        count = cfg.n_experts if p.name.startswith("moe_") else p.count
        bytes_ += 4.0 * packed_word_count(p.k, p.n, w_bits, a_bits) * count
    return {
        "mul_ops": mul_ops,
        "t_mul": t_mul,
        "dsp_ops": mul_ops / t_mul,
        "weight_bytes": bytes_,
    }


def layer_sensitivity(n_layers: int) -> list[float]:
    """Depth-sensitivity prior: the stack's ends carry the embedding /
    logit interfaces and are the classic high-sensitivity layers; the
    middle tolerates aggressive bits (mirrors the paper's Fig. 6 NAS
    selections, which keep boundary layers wide).  A mild monotone ramp
    breaks the front/back symmetry — layers feeding the logits are a bit
    less forgiving than their mirror images near the embedding."""
    if n_layers == 1:
        return [2.0]
    out = []
    for i in range(n_layers):
        edge = min(i, n_layers - 1 - i) / max(1, (n_layers - 1) / 2)
        out.append(1.0 + (1.0 - edge) ** 2 + 0.3 * i / (n_layers - 1))
    return out


def _quality(w_bits: int, a_bits: int, sens: float) -> float:
    # diminishing-returns bit utility; weights matter ~2x activations for
    # LM decode quality (weight-only quant literature)
    return sens * (2.0 * math.log2(w_bits) + math.log2(a_bits))


def _packing_fields(w_bits: int, a_bits: int, lut: PackingLUT) -> dict:
    kcfg = choose_config(w_bits, a_bits)
    return {
        "n_seg": kcfg.n_seg if kcfg else 1,
        "stride": kcfg.stride if kcfg else 0,
        "acc_chunk": kcfg.acc_chunk if kcfg else 1,
        "overlap": kcfg.overlap if kcfg else 0,
        "t_mul": lut.t_mul(w_bits, a_bits),
    }


def search_plan(
    cfg,
    *,
    arch: str,
    objective: str = "footprint",  # footprint | latency
    budget_frac: float = 0.85,  # of the uniform-w4a4 cost
    bit_choices: Sequence[int] = DEFAULT_BIT_CHOICES,
    beam: int = 8,
    n_slots: int = 8,
    head_bits: tuple[int, int] = (8, 8),
    lut: PackingLUT | None = None,
    pair_times: Mapping[tuple[int, int], float] | None = None,
    latency_weight: float = 2.0,
    smoke: bool = True,
) -> DeployPlan:
    """Beam search for the best per-layer bit assignment under a budget.

    The budget is relative to uniform w4a4 (the global ``--packed``
    default this plan replaces): ``budget_frac=0.85`` asks for a plan at
    most 85% of global-4bit's cost under ``objective``, with quality
    (sensitivity-weighted bit utility) maximized inside that envelope.

    ``pair_times`` (from :func:`repro_torch.plan.autotune.measure_pair_times`)
    regularizes quality by *measured* per-layer kernel time relative to
    w4a4, weighted by ``latency_weight`` — so two pairs in the same
    footprint tier resolve to the one the serving device actually runs
    faster, not the one the analytic model prefers.
    """
    if objective not in ("footprint", "latency"):
        raise ValueError(f"unknown objective {objective!r}")
    lut = serving_lut() if lut is None else lut
    shapes = layer_matmul_shapes(cfg, n_slots)
    L = len(shapes)
    sens = layer_sensitivity(L)
    cost_key = "weight_bytes" if objective == "footprint" else "dsp_ops"

    lut_bits = {b for pair in lut.table for b in pair}
    bad = [b for b in bit_choices if b not in lut_bits]
    if bad:
        raise ValueError(
            f"bit choices {bad} outside the packing LUT's range {sorted(lut_bits)}"
        )
    pairs = [(w, a) for w in bit_choices for a in bit_choices]
    if pair_times is not None:
        t_base = pair_times.get((4, 4)) or max(pair_times.values())
        missing = [p for p in pairs if p not in pair_times]
        if missing:
            raise ValueError(f"pair_times missing measurements for {missing}")
    # per layer: cost and quality of every candidate pair
    cand = []
    for i in range(L):
        row = {}
        for w, a in pairs:
            c = layer_cost(cfg, shapes[i], w, a, lut)
            q = _quality(w, a, sens[i])
            if pair_times is not None:
                q -= latency_weight * pair_times[(w, a)] / t_base
            row[(w, a)] = (c[cost_key], q, c)
        cand.append(row)

    # budget baseline: uniform w4a4 cost, independent of bit_choices
    base = sum(layer_cost(cfg, shapes[i], 4, 4, lut)[cost_key] for i in range(L))
    budget = budget_frac * base
    # feasibility bound for pruning: cheapest possible completion per suffix
    min_tail = [0.0] * (L + 1)
    for i in range(L - 1, -1, -1):
        min_tail[i] = min_tail[i + 1] + min(c for c, _, _ in cand[i].values())
    if min_tail[0] > budget:
        raise ValueError(
            f"budget {budget:.3g} infeasible: cheapest assignment costs {min_tail[0]:.3g}"
        )

    # beam over layers: states = (cost, -quality, assignment)
    states: list[tuple[float, float, tuple]] = [(0.0, 0.0, ())]
    for i in range(L):
        nxt = []
        for cost, negq, asg in states:
            for (w, a), (c, q, _) in cand[i].items():
                nc = cost + c
                if nc + min_tail[i + 1] <= budget + 1e-9:
                    nxt.append((nc, negq - q, asg + ((w, a),)))
        # keep the `beam` highest-quality states (ties -> cheaper first)
        nxt.sort(key=lambda s: (s[1], s[0]))
        states = nxt[:beam]
        if not states:
            raise RuntimeError("beam emptied despite feasible budget")  # pragma: no cover

    best_cost, best_negq, best_asg = min(states, key=lambda s: (s[1], s[0]))
    return plan_from_bits(
        cfg, arch=arch, bits=list(best_asg), n_slots=n_slots,
        head_bits=head_bits, lut=lut, smoke=smoke, source="search",
        budget={
            "objective": objective,
            "budget_frac": budget_frac,
            "budget": budget,
            "baseline_w4a4": base,
            "achieved": best_cost,
            "quality": -best_negq,
            "n_slots": n_slots,
            "bit_choices": list(bit_choices),
            "beam": beam,
            "measured_pair_times": pair_times is not None,
            "latency_weight": latency_weight if pair_times is not None else 0.0,
        },
    )


def uniform_plan(
    cfg,
    *,
    arch: str,
    w_bits: int,
    a_bits: int,
    n_slots: int = 8,
    head_bits: tuple[int, int] | None = None,
    lut: PackingLUT | None = None,
    smoke: bool = True,
) -> DeployPlan:
    """Global single-bit-pair plan — the baseline ``--packed`` flags as a
    plan artifact (and the bit-exactness bridge to
    ``quantize_params_packed``)."""
    n_layers = cfg.n_layers
    return plan_from_bits(
        cfg, arch=arch, bits=[(w_bits, a_bits)] * n_layers, n_slots=n_slots,
        head_bits=head_bits or (w_bits, a_bits), lut=lut, smoke=smoke,
        source="uniform", budget={"n_slots": n_slots},
    )


def plan_from_bits(
    cfg,
    *,
    arch: str,
    bits: Sequence[tuple[int, int]],
    n_slots: int = 8,
    head_bits: tuple[int, int] = (8, 8),
    lut: PackingLUT | None = None,
    smoke: bool = True,
    source: str = "search",
    budget: dict | None = None,
) -> DeployPlan:
    """Plan from an explicit per-layer bit list — the one assembler every
    plan constructor (search, uniform, fixtures) funnels through."""
    lut = serving_lut() if lut is None else lut
    shapes = layer_matmul_shapes(cfg, n_slots)
    if len(bits) != len(shapes):
        raise ValueError(f"{len(bits)} bit pairs for {len(shapes)} layers")
    layers, totals = [], {"mul_ops": 0.0, "dsp_ops": 0.0, "weight_bytes": 0.0}
    for i, ((w, a), projs) in enumerate(zip(bits, shapes)):
        c = layer_cost(cfg, projs, w, a, lut)
        for k in totals:
            totals[k] += c[k]
        layers.append(
            LayerPlan(
                index=i, name=f"layer_{i}", w_bits=w, a_bits=a,
                **_packing_fields(w, a, lut),
                cost={k: c[k] for k in ("mul_ops", "dsp_ops", "weight_bytes")},
            )
        )
    head = LayerPlan(index=0, name="lm_head", w_bits=head_bits[0], a_bits=head_bits[1],
                     **_packing_fields(head_bits[0], head_bits[1], lut))
    if budget is None:
        budget = {"n_slots": n_slots, "explicit_bits": True}
    return DeployPlan(
        arch=arch, family=cfg.family, source=source, profile=lut.profile,
        layers=layers, lm_head=head, smoke=smoke,
        budget=budget, predicted=totals,
    ).validate()


def plan_from_nas_result(
    result,
    spec,
    luts: Mapping[int, PackingLUT],
    *,
    arch: str,
) -> DeployPlan:
    """Adapter: a ``repro_torch.core.nas.SearchResult`` (convnet NAS) becomes the
    same :class:`DeployPlan` artifact the serving searches emit, so the
    paper's NAS path plugs into the one deployment format."""
    bits = list(result.bits)
    if len(bits) != len(spec.layers):
        raise ValueError(
            f"NAS result has {len(bits)} layers, spec has {len(spec.layers)}"
        )
    # NB: convnet plans report *ideal* bit-packed bytes (FPGA BRAM has no
    # int32-word storage constraint) under a distinct key so the field is
    # never confused with serving plans' actual packed-word `weight_bytes`
    layers, totals = [], {"mul_ops": 0.0, "dsp_ops": 0.0, "ideal_weight_bytes": 0.0}
    profile = None
    for i, ((w, a), lspec) in enumerate(zip(bits, spec.layers)):
        lut = luts[lspec.kernel if lspec.kernel in luts else max(luts)]
        profile = profile or lut.profile
        ops = float(spec.op_mul(i))
        t = lut.t_mul(w, a)
        kcfg = lut.config(w, a)
        cost = {
            "mul_ops": ops,
            "dsp_ops": ops / t,
            "ideal_weight_bytes": w / 8.0 * lspec.kernel * lspec.kernel * lspec.cin * lspec.cout,
        }
        for k in totals:
            totals[k] += cost[k]
        layers.append(
            LayerPlan(
                index=i, name=f"conv_{i}", w_bits=w, a_bits=a,
                n_seg=kcfg.n_w, stride=kcfg.stride, acc_chunk=1,
                overlap=kcfg.overlap, t_mul=t,
                cost=cost,
            )
        )
    return DeployPlan(
        arch=arch, family="convnet", source="nas", profile=profile or "dsp48e2",
        layers=layers, lm_head=None,
        predicted={**totals, "op_dsp": getattr(result, "op_dsp", None),
                   "final_metric": getattr(result, "final_metric", None)},
    ).validate()
