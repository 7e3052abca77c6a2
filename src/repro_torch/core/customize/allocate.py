"""Accelerator customization (§VI, Algorithm 1; a copy of
``repro.core.customize.allocate``).

Picks one implementation per pipeline stage minimizing the pipeline
initiation interval  II = max_l Op_dsp^l / Pf^l  subject to DSP/LUT
budgets and WNS > 0, with per-stage resources/WNS estimated by
Bayesian-ridge predictors trained on sampled 'synthesis' results.

Implementation note: Algorithm 1 in the paper memoizes
Lat[l][R_dsp][R_lut].  Because the objective is a bottleneck (max), the
same optimum is computed by parameterizing on the II value: for a fixed
II each stage independently keeps only configs with latency <= II, and a
1-D resource DP (min total LUTs for every DSP sub-budget) decides
feasibility; binary search over the O(L * |configs|) distinct candidate
latencies yields the minimal feasible II.  This is the identical
recurrence evaluated lazily, is exactly optimal w.r.t. the candidate
sets, and gives exact backtracking.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.packing import PackingLUT
from repro_torch.models import convnets

from .bayes import BayesianRidge
from .resource_model import ULTRA96, StageConfig, stage_features, stage_resources


@dataclasses.dataclass
class Predictors:
    dsp: BayesianRidge
    lut: BayesianRidge
    wns: BayesianRidge
    r2: dict

    def estimate_batch(self, cfgs: Sequence[StageConfig]) -> list[dict]:
        X = np.asarray([stage_features(c) for c in cfgs])
        d = self.dsp.predict(X)
        u = self.lut.predict(X)
        w = self.wns.predict(X)
        return [{"dsp": float(a), "lut": float(b), "wns": float(c)} for a, b, c in zip(d, u, w)]


def train_predictors(sample_configs: Sequence[StageConfig], seed: int = 0) -> Predictors:
    """Pre-train the Bayesian ridge predictors on sampled synthesis runs."""
    rng = np.random.default_rng(seed)
    X = np.asarray([stage_features(c) for c in sample_configs])
    ys = {k: np.asarray([stage_resources(c, rng)[k] for c in sample_configs]) for k in ("dsp", "lut", "wns")}
    # note: one rng stream per call keeps the 'synthesis noise' reproducible
    models = {k: BayesianRidge().fit(X, y) for k, y in ys.items()}
    r2 = {k: models[k].r2(X, ys[k]) for k in ys}
    return Predictors(dsp=models["dsp"], lut=models["lut"], wns=models["wns"], r2=r2)


def sample_space(
    spec: convnets.ConvNetSpec,
    bits: Sequence[tuple[int, int]],
    luts: Mapping[int, PackingLUT],
    *,
    pf_dsp_choices: Sequence[int] = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128),
    pf_lut_choices: Sequence[int] = (0, 16, 32, 64, 128, 144),
) -> list[list[StageConfig]]:
    """Candidate implementations per stage for one bit-width assignment."""
    per_stage = []
    for i, layer in enumerate(spec.layers):
        wb, ab = bits[i]
        lut = luts[layer.kernel if layer.kernel in luts else max(luts)]
        packing = lut.config(wb, ab)
        cin = 1 if layer.depthwise else layer.cin
        wbits_total = layer.kernel * layer.kernel * cin * layer.cout * wb
        cands = [
            StageConfig(
                pf_dsp=pd,
                pf_lut=pl,
                w_bits=wb,
                a_bits=ab,
                packing=packing,
                op_mul=float(spec.op_mul(i)),
                weight_bits_total=wbits_total,
            )
            for pd, pl in itertools.product(pf_dsp_choices, pf_lut_choices)
        ]
        per_stage.append(cands)
    return per_stage


@dataclasses.dataclass
class Allocation:
    latency_cycles: float
    fps: float
    configs: list[StageConfig]
    dsp_used: float
    lut_used: float
    bram_used: float
    pf_dsp: int
    pf_lut: int
    min_wns: float


def _feasible(stage_ests, ii, max_dsp, max_lut):
    """Resource DP at fixed II: min total LUT for every DSP sub-budget.

    Returns the chosen per-stage config indices, or None.
    """
    n_d = max_dsp + 1
    INF = float("inf")
    min_lut = np.zeros(n_d)
    picks: list[np.ndarray] = []
    for ests in stage_ests:
        new = np.full(n_d, INF)
        pick = np.full(n_d, -1, np.int32)
        for ci, (c, d_c, u_c, l_c) in enumerate(ests):
            if l_c > ii + 1e-9 or d_c >= n_d:
                continue
            cand = min_lut[: n_d - d_c] + u_c
            window = new[d_c:]
            better = cand < window
            window[better] = cand[better]
            pick[d_c:][better] = ci
        # monotone pass: bigger DSP budget never hurts
        for i in range(1, n_d):
            if new[i] > new[i - 1]:
                new[i] = new[i - 1]
                pick[i] = -2  # inherit: resolved during backtrack
        min_lut = new
        picks.append(pick)
        if not np.isfinite(min_lut[-1]):
            return None
    if min_lut[-1] > max_lut:
        return None
    # backtrack
    chosen = []
    d_rem = n_d - 1
    for ests, pick in zip(reversed(stage_ests), reversed(picks)):
        ci = pick[d_rem]
        while ci == -2:
            d_rem -= 1
            ci = pick[d_rem]
        assert ci >= 0
        chosen.append(ci)
        d_rem -= ests[ci][1]
    chosen.reverse()
    return chosen


def allocate(
    per_stage: list[list[StageConfig]],
    predictors: Predictors,
    *,
    max_dsp: int = ULTRA96["dsp"],
    max_lut: int = ULTRA96["lut"],
    allow_lut_arith: bool = False,
    freq_mhz: float = ULTRA96["freq_mhz"],
) -> Allocation | None:
    """Minimize pipeline II over per-stage configs within (DSP, LUT) budget."""
    stage_ests = []
    for cands in per_stage:
        cands = [c for c in cands if allow_lut_arith or c.pf_lut == 0]
        ests_raw = predictors.estimate_batch(cands)
        ests = []
        for c, e in zip(cands, ests_raw):
            if e["wns"] <= 0.0:
                continue  # predicted timing violation at the target clock
            ests.append((c, int(np.ceil(max(e["dsp"], 1.0))), max(e["lut"], 0.0), c.latency_cycles))
        if not ests:
            return None
        stage_ests.append(ests)

    # candidate II values = distinct stage latencies (the optimum is one)
    lats = sorted({l for ests in stage_ests for (_, _, _, l) in ests})
    lo, hi, best = 0, len(lats) - 1, None
    while lo <= hi:
        mid = (lo + hi) // 2
        chosen = _feasible(stage_ests, lats[mid], max_dsp, max_lut)
        if chosen is not None:
            best = (lats[mid], chosen)
            hi = mid - 1
        else:
            lo = mid + 1
    if best is None:
        return None
    ii_bound, chosen = best
    configs = [stage_ests[i][ci][0] for i, ci in enumerate(chosen)]
    ii = max(c.latency_cycles for c in configs)
    res = [stage_resources(c) for c in configs]
    return Allocation(
        latency_cycles=float(ii),
        fps=float(freq_mhz * 1e6 / ii),
        configs=configs,
        dsp_used=float(sum(r["dsp"] for r in res)),
        lut_used=float(sum(r["lut"] for r in res)),
        bram_used=float(sum(r["bram"] for r in res)),
        pf_dsp=int(sum(c.pf_dsp for c in configs)),
        pf_lut=int(sum(c.pf_lut for c in configs)),
        min_wns=float(min(r["wns"] for r in res)),
    )
