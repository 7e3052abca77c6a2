"""Analytical stand-in for post-synthesis reports (Vivado not available;
a copy of ``repro.core.customize.resource_model``).

Produces per-stage DSP/LUT/BRAM/WNS numbers for a pipelined stage built
from ``pf_dsp`` packed DSP units (each worth T_mul MACs/cycle) plus
``pf_lut`` LUT-fabric MAC units.  Calibrated against the magnitudes in
the paper's Table I (Ultra96-V2: 360 DSPs, 70k LUTs, 216 BRAM36) and the
reported ~16.4 extra LUTs per packed DSP.  The Bayesian-ridge predictors
are trained on *noisy samples* of this model, mirroring the paper's
predictor-on-synthesis-samples methodology.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.packing import DSP48E2, MulProfile, PackingConfig, best_packing, lut_overhead_estimate

ULTRA96 = {"dsp": 360, "lut": 70_560, "bram": 216, "freq_mhz": 250.0}


def runtime_packing(
    w_bits: int, a_bits: int, kernel_len: int = 1, profile: MulProfile = DSP48E2
) -> PackingConfig:
    """The placement the kernel runtime would actually execute for this
    stage — routed through the same selection helper as the kernel
    wrappers (``core.packing.select`` via ``best_packing(method=
    "runtime")``), overpacking included.  Build a :class:`StageConfig`
    from this instead of a raw ``mixq`` LUT cell when the stage must
    score exactly what the kernels deliver (``mixq`` also admits operand
    separation / filter densities the matmul runtime has no path for);
    ``benchmarks/packing_efficiency.py`` records both selections per bit
    pair so the gap stays visible."""
    return best_packing(profile, w_bits, a_bits, kernel_len=kernel_len, method="runtime")


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """One candidate implementation of one pipeline stage."""

    pf_dsp: int  # packed DSP multipliers
    pf_lut: int  # LUT-fabric MAC units
    w_bits: int
    a_bits: int
    packing: PackingConfig
    op_mul: float  # MACs per frame in this stage
    weight_bits_total: int  # for BRAM estimate

    @property
    def macs_per_cycle(self) -> float:
        return self.pf_dsp * self.packing.t_mul + self.pf_lut

    @property
    def latency_cycles(self) -> float:
        return self.op_mul / max(self.macs_per_cycle, 1e-9)


def stage_resources(cfg: StageConfig, rng: np.random.Generator | None = None) -> dict:
    """DSP/LUT/BRAM/WNS of one stage implementation (the 'synthesis oracle')."""
    noise = (lambda s: rng.normal(0.0, s)) if rng is not None else (lambda s: 0.0)
    dsp = cfg.pf_dsp * cfg.packing.dsps + 3  # +BN/bias mul-adds on DSP
    lut = (
        620.0  # stage control / FIFO plumbing
        + cfg.pf_dsp * (lut_overhead_estimate(cfg.packing) + 6.0)  # decode + routing
        + cfg.pf_lut * (1.15 * cfg.w_bits * cfg.a_bits + 14.0)  # fabric MACs
        + noise(35.0)
    )
    bram = 2 + int(np.ceil(cfg.weight_bits_total / 36_864))
    util = lut / ULTRA96["lut"]
    # 4 ns clock @250 MHz; congestion grows superlinearly with LUT utilization
    wns = (
        4.0
        - 2.25
        - 1.45 * util**2
        - 0.08 * (cfg.pf_lut > 0) * (cfg.w_bits * cfg.a_bits / 16.0)
        - 0.0009 * cfg.pf_dsp
        + noise(0.05)
    )
    return {"dsp": float(dsp), "lut": float(lut), "bram": float(bram), "wns": float(wns)}


def stage_features(cfg: StageConfig) -> list[float]:
    """Predictor features for one stage configuration."""
    return [
        cfg.pf_dsp,
        cfg.pf_lut,
        cfg.w_bits,
        cfg.a_bits,
        cfg.w_bits * cfg.a_bits,
        cfg.packing.t_mul,
        cfg.packing.dsps,
        float(cfg.packing.overlap),
        cfg.pf_dsp * cfg.packing.t_mul,
        np.log1p(cfg.op_mul),
    ]
