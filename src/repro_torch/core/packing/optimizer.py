"""DSP Packing Optimizer (``repro.core.packing.optimizer``, DeepBurning-MixQ §IV).

For every (weight_bits, activation_bits) combination the optimizer
traverses all feasible placements of all strategies and enhancements and
keeps the best one under the paper's lexicographic objective (maximize
T_mul, then E_g).  The lookup tables it builds steer plan search's
per-layer bit choices (:mod:`repro_torch.plan.search`).

Baselines for the paper's Fig. 4 comparison: ``hikonv`` (Filter Packing
only, no overpacking or separation) and ``xilinx`` (vendor-style Kernel
Packing only, no overpacking, separation or filter strategy).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
from typing import Mapping

from .profiles import DSP48E2, MulProfile
from .select import select_filter_placement, select_kernel_placement, trivial_placement
from .strategies import PackingConfig, all_placements, filter_placements, kernel_placements

DEFAULT_BITS = tuple(range(2, 9))  # the paper's 2..8-bit search space


def best_packing(
    profile: MulProfile,
    w_bits: int,
    a_bits: int,
    *,
    kernel_len: int = 3,
    seq_len: int = 32,
    method: str = "mixq",
) -> PackingConfig:
    """Best placement for one bit-width combination under ``method``.

    ``method="runtime"`` scores only what the serving kernels execute (the
    selection helpers of :mod:`.select`: kernel packing with scalar
    activations, int32-safe filter packing, 1-bit overpacking, no operand
    separation), so LUTs built with it promise exactly the density the
    runtime delivers; pairs with no multi-segment placement fall back to
    the trivial n_seg=1 config (T_mul = 1, the plain integer path).
    """
    if method == "runtime":
        cands = []
        sel = select_kernel_placement(profile, w_bits, a_bits)
        if sel is not None:
            cands.append(sel[0])
        if kernel_len > 1:
            fsel = select_filter_placement(profile, w_bits, a_bits, kernel_len)
            if fsel is not None:
                cands.append(fsel[0])
        if not cands:
            cands = [trivial_placement(w_bits, a_bits)]
    elif method == "mixq":
        cands = all_placements(profile, w_bits, a_bits, kernel_len, seq_len)
    elif method == "no_enhance":  # Mixed Packing without §IV-B enhancements
        cands = all_placements(
            profile, w_bits, a_bits, kernel_len, seq_len,
            allow_overpack=False, allow_separation=False,
        )
    elif method == "hikonv":
        cands = list(
            filter_placements(profile, w_bits, a_bits, kernel_len, seq_len, allow_overpack=False)
        ) or list(kernel_placements(profile, w_bits, a_bits, allow_overpack=False))
    elif method == "xilinx":
        cands = list(kernel_placements(profile, w_bits, a_bits, allow_overpack=False))
    else:
        raise ValueError(f"unknown method {method!r}")
    if not cands:
        raise ValueError(f"no feasible packing for w{w_bits}a{a_bits} on {profile.name}")
    return max(cands, key=lambda c: c.key)


@dataclasses.dataclass
class PackingLUT:
    """T_mul / E_g lookup table for one conv-kernel geometry:
    ``table[(w_bits, a_bits)]`` holds the winning :class:`PackingConfig`."""

    profile: str
    kernel_len: int
    seq_len: int
    method: str
    table: Mapping[tuple[int, int], PackingConfig]

    def t_mul(self, w_bits: int, a_bits: int) -> float:
        return self.table[(w_bits, a_bits)].t_mul

    def e_g(self, w_bits: int, a_bits: int) -> int:
        return self.table[(w_bits, a_bits)].e_g

    def config(self, w_bits: int, a_bits: int) -> PackingConfig:
        return self.table[(w_bits, a_bits)]

    def to_payload(self) -> dict:
        return {
            "profile": self.profile,
            "kernel_len": self.kernel_len,
            "seq_len": self.seq_len,
            "method": self.method,
            "table": {
                f"{w},{a}": dataclasses.asdict(cfg) for (w, a), cfg in self.table.items()
            },
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "PackingLUT":
        table = {
            tuple(map(int, key.split(","))): PackingConfig(**cfg)
            for key, cfg in payload["table"].items()
        }
        return cls(
            profile=payload["profile"],
            kernel_len=payload["kernel_len"],
            seq_len=payload["seq_len"],
            method=payload["method"],
            table=table,
        )

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(json.dumps(self.to_payload(), indent=1))

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "PackingLUT":
        return cls.from_payload(json.loads(pathlib.Path(path).read_text()))


def build_lut(
    profile: MulProfile = DSP48E2,
    *,
    kernel_len: int = 3,
    seq_len: int = 32,
    bits: tuple[int, ...] = DEFAULT_BITS,
    method: str = "mixq",
) -> PackingLUT:
    table = {
        (w, a): best_packing(
            profile, w, a, kernel_len=kernel_len, seq_len=seq_len, method=method
        )
        for w in bits
        for a in bits
    }
    return PackingLUT(
        profile=profile.name, kernel_len=kernel_len, seq_len=seq_len, method=method, table=table
    )


def compare_luts(ours: PackingLUT, baseline: PackingLUT) -> dict:
    """Fig. 4-style comparison: count cells where ours beats the baseline."""
    better, equal, worse = 0, 0, 0
    cells = {}
    for key in ours.table:
        o, b = ours.table[key].t_mul, baseline.table[key].t_mul
        cells[f"{key[0]},{key[1]}"] = (o, b)
        if o > b + 1e-9:
            better += 1
        elif o < b - 1e-9:
            worse += 1
        else:
            equal += 1
    return {"better": better, "equal": equal, "worse": worse, "cells": cells}


def lut_overhead_estimate(cfg: PackingConfig) -> float:
    """Extra LUT logic for decode/correction, for the resource model:
    segment extraction, the overpacking correction's AND/XOR tree and
    adder (Fig. 3), and the separation's recombination, per multiplier."""
    if cfg.strategy == "kernel":
        segments = cfg.n_w * cfg.n_a
        products_per_seg = 1.0
    else:
        segments = cfg.n_w + cfg.n_a - 1
        products_per_seg = min(cfg.n_w, cfg.n_a)
    base = 2.0 * segments  # segment extraction / shift-add plumbing
    if cfg.overlap:
        base += segments * (1.0 + products_per_seg)  # AND/XOR tree + add
    if cfg.separated:
        base += 4.0  # recombination shift-add
    return base * cfg.dsps


def _profile_fingerprint(profile: MulProfile) -> dict:
    """What the LUT result depends on: the multiplier port geometry."""
    return {"name": profile.name, "port_big": profile.port_big,
            "port_small": profile.port_small}


def cached_luts(
    path: str | pathlib.Path,
    *,
    profile: MulProfile = DSP48E2,
    kernel_lens: tuple[int, ...] = (1, 3, 5),
    seq_len: int = 32,
    bits: tuple[int, ...] = DEFAULT_BITS,
    method: str = "mixq",
) -> dict[int, PackingLUT]:
    """Single-file LUT cache: build on a miss, load on later calls.

    All (profile, method, kernel_len) entries share the JSON file at
    ``path``.  Each entry records the profile's port fingerprint, so a
    changed profile definition invalidates exactly the entries built from
    it; corrupt or unreadable files are rebuilt, never trusted.  The file
    is replaced whole (written beside it, then renamed), so a concurrent
    reader sees the old file or the new one.
    """
    path = pathlib.Path(path)
    try:
        payload = json.loads(path.read_text()) if path.exists() else {}
        if not isinstance(payload, dict):
            payload = {}
    except (OSError, json.JSONDecodeError):
        payload = {}
    fp = _profile_fingerprint(profile)
    out: dict[int, PackingLUT] = {}
    dirty = False
    bits_tag = "-".join(str(b) for b in bits)
    for k in kernel_lens:
        key = f"{profile.name}|{method}|k{k}|n{seq_len}|b{bits_tag}"
        entry = payload.get(key)
        if entry and entry.get("fingerprint") == fp:
            try:
                out[k] = PackingLUT.from_payload(entry["lut"])
                continue
            except (KeyError, TypeError):
                pass  # malformed entry: rebuild below
        lut = build_lut(profile, kernel_len=k, seq_len=seq_len, bits=bits, method=method)
        payload[key] = {"fingerprint": fp, "lut": lut.to_payload()}
        out[k] = lut
        dirty = True
    if dirty:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=path.name, suffix=".tmp", dir=path.parent)
        try:
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(payload, indent=1))
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
    return out


def default_lut_cache(
    cache_dir: str | pathlib.Path,
    *,
    profile: MulProfile = DSP48E2,
    kernel_lens: tuple[int, ...] = (1, 3, 5),
    seq_len: int = 32,
    method: str = "mixq",
) -> dict[int, PackingLUT]:
    """:func:`cached_luts` in ``<cache_dir>/packing_luts.json``."""
    return cached_luts(
        pathlib.Path(cache_dir) / "packing_luts.json",
        profile=profile, kernel_lens=kernel_lens, seq_len=seq_len, method=method,
    )
