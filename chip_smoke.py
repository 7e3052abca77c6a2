#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py   # every phase; exits non-zero if any fails

Phases, all on the card:

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the card's name and power limit.
2. K1 (``packed_dense_fused``) and K2 (``packed_matmul``, block_k=512)
   against their plain versions at every full-width llama3.2-3b matmul
   shape of a decode step (M = 8 slots), the 128256-wide LM head
   included, overpacked w4a4 and one no-overpack placement: bit-exact.
3. K3 (``paged_gather``) against its plain version at the engine's
   geometry: a bf16 pool with null pages, with and without a sliding
   window, and an int8 pool: bit-exact.
4. The engine: llama3.2-3b at full width (28 layers, d 3072, vocab
   128256), w4a4 packed projections, the packed (4, 4) LM head and the
   kernel gather, built with ``build_engine`` from random weights (seed
   0), serving 8 requests (prompts of 16-64 tokens, 32 new tokens each).
   Every request must end ``ok`` with finite logits, and the launch
   counters must equal the per-step counts times the steps.  A short
   traced run of the same weights (``torch.profiler``) gives the device's
   busy share and its time by kernel.  A last run serves the same
   weights with ``block_k=512``, the K-blocked path (K2), and must give
   the same tokens.  Each path's launch counts come from its own run.
5. Whole-path cross-check: a 2-layer model of the same width, float32,
   on the card (kernels) and on the CPU (plain versions) from the same
   packed words, a few decode steps; logits within the stated tolerance.

Times come from CUDA events (median over launches, L2 flushed before
each).  The line before the last is the kernels JSON, the one before it
the card's ``nvidia-smi`` name and power limit, and the last line is
``{"ok": true, "device": {...}}``.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT32_LANES_PER_SM = 64  # IMAD lanes per Hopper SM and clock

# phase 5 tolerance.  Both sides run float32 on the same packed words, so a
# slot's logits differ only by float sum order (cuBLAS against the CPU)
# unless one of its activations sits within an ulp of a 4-bit rounding
# boundary and flips a level, which then cascades through the later
# quantized layers (on an H100 at full width, one row in eight showed a
# flip at the first step, about 3 % off).  The phase records every packed
# matmul's activation levels on both sides: a slot whose levels never
# differed must agree to CROSS_CLEAN_ABS_TOL per logit, and its greedy
# token must agree wherever the CPU's top-2 gap exceeds twice its largest
# |difference|; a slot with a flip must stay within CROSS_FLIP_REL_TOL
# relative L2; and flips must stay rare (at least half the slots without
# one).
CROSS_CLEAN_ABS_TOL = 1e-3
CROSS_FLIP_REL_TOL = 0.2


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of one call, the L2 cache flushed before each."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(128 << 20, dtype=torch.int8, device="cuda")

    def __call__(self, fn, reps: int, warmup: int = 1) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            times.append((e0, e1))
        torch.cuda.synchronize()
        vals = sorted(a.elapsed_time(b) for a, b in times)
        return vals[len(vals) // 2]


@dataclasses.dataclass
class Card:
    name: str
    power_limit: str
    sms: int
    clock_mhz: float

    @property
    def int32_ops_per_s(self) -> float:
        return self.sms * INT32_LANES_PER_SM * self.clock_mhz * 1e6

    def bound(self, n_bytes: float, ops: float) -> tuple[float, str, float, float]:
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / self.int32_ops_per_s * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops


def decode_matmul_shapes(cfg) -> dict[str, tuple[int, int, int]]:
    """name -> (K, N, launches per decode step) for every packed matmul."""
    d, hd, L = cfg.d_model, cfg.hd, cfg.n_layers
    return {
        "wq|wo": (d, cfg.n_heads * hd, 2 * L),
        "wk|wv": (d, cfg.kv_heads * hd, 2 * L),
        "w_up|w_gate": (d, cfg.d_ff, 2 * L),
        "w_down": (cfg.d_ff, d, L),
        "head": (d, cfg.vocab, 1),
    }


# -- phase 2 -------------------------------------------------------------------


def phase_matmul(torch, card, timer, cfg, M: int, report: dict) -> dict:
    from repro_torch.kernels.packed_matmul import ref as pm
    from repro_torch.kernels.packed_matmul.kernel import (
        packed_dense_fused_plain, packed_dense_fused_raw, packed_matmul_plain, packed_matmul_raw,
    )
    from repro_torch.kernels.packed_matmul.ops import choose_config

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    over, plain_cfg = choose_config(4, 4), choose_config(4, 4, allow_overpack=False)
    check(over.overlap == 1 and plain_cfg.overlap == 0, f"unexpected w4a4 placements {over} {plain_cfg}")
    rows, max_err = [], 0.0
    for name, (K, N, per_step) in decode_matmul_shapes(cfg).items():
        for cfg_p, label in ((over, "w4a4 overlap=1"), (plain_cfg, "w4a4 overlap=0")):
            if cfg_p is plain_cfg and name not in ("wq|wo", "w_down"):
                continue
            x = torch.rand((M, K), generator=g, device="cuda") * 1.2 - 0.1
            w_lvl = torch.randint(0, 16, (K, N), generator=g, device="cuda", dtype=torch.int32)
            wp = pm.pack_weights(w_lvl, cfg_p.n_seg, cfg_p.stride)
            del w_lvl
            kw = dict(n_seg=cfg_p.n_seg, stride=cfg_p.stride, acc_chunk=cfg_p.acc_chunk,
                      overlap=cfg_p.overlap)
            acc, a_sum = packed_dense_fused_raw(x, wp, a_bits=4, **kw)
            p_acc, p_sum = packed_dense_fused_plain(x, wp, a_bits=4, **kw)
            torch.cuda.synchronize()
            err = max((acc - p_acc).abs().max().item(), (a_sum - p_sum).abs().max().item())
            check(torch.equal(acc, p_acc) and torch.equal(a_sum, p_sum),
                  f"K1 differs from its plain version at {name} K={K} N={N} {label}: max {err}")
            a_lvl = torch.round(torch.clamp(x, 0, 1) * 15).to(torch.int32)
            acc2 = packed_matmul_raw(a_lvl, wp, block_k=512, **kw)
            p_acc2 = packed_matmul_plain(a_lvl, wp, block_k=512, **kw)
            torch.cuda.synchronize()
            check(torch.equal(acc2, p_acc2) and torch.equal(acc2, acc),
                  f"K2 (block_k=512) differs at {name} K={K} N={N} {label}")
            max_err = max(max_err, err, (acc2 - p_acc2).abs().max().item())
            Np = wp.shape[1]
            nbytes = M * K * 4 + K * Np * 4 + M * N * 4 + M * 4
            ops = M * K * Np * (2 if cfg_p.overlap else 1)  # packed + parity IMADs
            b_ms, b_by, _, _ = card.bound(nbytes, ops)
            w_bf16 = torch.randn((K, N), generator=g, device="cuda", dtype=torch.bfloat16)
            x_bf16 = x.to(torch.bfloat16)
            row = dict(
                shape=name, K=K, N=N, M=M, placement=label, per_step=per_step,
                k1_ms=timer(lambda: packed_dense_fused_raw(x, wp, a_bits=4, **kw), reps=20),
                k2_ms=timer(lambda: packed_matmul_raw(a_lvl, wp, block_k=512, **kw), reps=20),
                plain_ms=timer(lambda: packed_dense_fused_plain(x, wp, a_bits=4, **kw), reps=3),
                library_ms=timer(lambda: torch.matmul(x_bf16, w_bf16), reps=20),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, int32_ops=ops,
            )
            rows.append(row)
            print(f"  {name:12s} K={K:5d} N={N:6d} {label}: K1 {row['k1_ms']:.4f} ms, "
                  f"K2 {row['k2_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, bf16 matmul "
                  f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); bit-exact", flush=True)
            del x, wp, acc, p_acc, acc2, p_acc2, w_bf16, x_bf16, a_lvl
    report["matmul"] = rows
    return {"max_err": max_err, "rows": rows}


# -- phase 3 -------------------------------------------------------------------


def _gather_geometry(torch, S, nb, ps, n_pages, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    table = np.zeros((S, nb), np.int32)
    pos = np.zeros((S,), np.int32)
    free = list(range(1, n_pages))
    rng.shuffle(free)
    for s in range(S - 1):  # the last slot stays inactive: an all-null row
        length = int(rng.integers(17, 96))
        n_live = length // ps + 1
        table[s, :n_live] = [free.pop() for _ in range(n_live)]
        pos[s] = length
    return torch.from_numpy(table).cuda(), torch.from_numpy(pos).cuda(), int(np.count_nonzero(table))


def phase_gather(torch, card, timer, cfg, ecfg, report: dict) -> dict:
    from repro_torch.kernels.paged_gather.kernel import paged_gather_plain, paged_gather_raw

    S, nb, ps = ecfg.n_slots, ecfg.blocks_per_slot, ecfg.page_size
    P, D = ecfg.pool_pages(), cfg.kv_heads * cfg.hd
    table, pos, n_live = _gather_geometry(torch, S, nb, ps, P, seed=1)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    fp = torch.randn((2, P, ps, D), generator=g, device="cuda")
    fp[:, 0] = float("nan")  # the null page holds garbage; the views must read zeros
    bf = fp.to(torch.bfloat16)
    sc = fp.abs().amax(-1, keepdim=True).nan_to_num(1.0) / 127 + 1e-12
    lv = torch.clamp(torch.round(fp.nan_to_num(0.0) / sc), -127, 127).to(torch.int8)
    cases = [
        ("bf16 pool, full causal", (bf[0], bf[1]), (None, None), 0),
        ("bf16 pool, window 40", (bf[0], bf[1]), (None, None), 40),
        ("int8 pool -> bf16, full causal", (lv[0], lv[1]), (sc[0], sc[1]), 0),
        ("int8 pool -> bf16, window 40", (lv[0], lv[1]), (sc[0], sc[1]), 40),
    ]
    rows, max_err = [], 0.0
    for label, pools, scales, window in cases:
        args = (table, pos, window, *pools, *scales)
        got = paged_gather_raw(*args, chunk=1, out_dtype=torch.bfloat16)
        want = paged_gather_plain(*args, chunk=1, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            check(a.dtype == b.dtype and torch.equal(a, b), f"K3 differs from its plain version: {label}")
            max_err = max(max_err, (a.float() - b.float()).abs().max().item())
        elem = pools[0].element_size()
        nbytes = (2 * n_live * ps * D * elem + 2 * S * nb * ps * D * 2 + S * nb * ps
                  + S * nb * 4 + S * 4 + (2 * n_live * ps * 4 if scales[0] is not None else 0))
        b_ms, b_by, _, _ = card.bound(nbytes, 0)
        tl = table.long()
        row = dict(
            case=label, S=S, n_blocks=nb, page_size=ps, D=D, live_pages=n_live, per_step=cfg.n_layers,
            k3_ms=timer(lambda: paged_gather_raw(*args, chunk=1, out_dtype=torch.bfloat16), reps=20),
            plain_ms=timer(lambda: paged_gather_plain(*args, chunk=1, out_dtype=torch.bfloat16), reps=10),
            library_ms=timer(lambda: (pools[0][tl], pools[1][tl]), reps=20),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
        )
        rows.append(row)
        print(f"  {label}: K3 {row['k3_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"pool[table] {row['library_ms']:.4f} ms, bound {b_ms:.4f} ms; bit-exact", flush=True)
    report["gather"] = rows
    return {"max_err": max_err, "rows": rows}


# -- phase 4 -------------------------------------------------------------------


def _serve(torch, eng, prompts, max_new: int) -> tuple[dict, dict, float]:
    from repro_torch.kernels import build

    for p in prompts:
        eng.submit(p, max_new)
    eng.warmup()
    torch.cuda.synchronize()
    build.reset_counts()  # the main path's run starts here
    t0 = time.monotonic()
    metrics = eng.run(realtime=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return metrics, build.counts(), wall


def phase_engine(torch, cfg, ecfg, report: dict) -> dict:
    import numpy as np

    from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, build_engine

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(16, 65))).tolist() for _ in range(8)]
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    eng = build_engine(cfg, ecfg, quant="packed", w_bits=4, a_bits=4, seed=0)
    torch.cuda.synchronize()
    t_build = time.monotonic() - t0
    m, counts, wall = _serve(torch, eng, prompts, 32)
    steps = m["steps"]
    per_step = {"packed_dense_fused": cfg.n_layers * 7 + 1, "packed_matmul": 0,
                "paged_gather": cfg.n_layers}
    check(m["statuses"] == {"ok": len(prompts)}, f"engine statuses {m['statuses']}")
    check(all(len(r.out_tokens) == 32 for r in eng.finished), "a request ended short")
    check(counts == {k: v * steps for k, v in per_step.items()},
          f"launch counters {counts} != {per_step} x {steps} steps")
    step_ms = [1e3 * s for s in eng.step_seconds]
    run_a = dict(
        build_s=t_build, steps=steps, wall_s=wall, tokens=m["generated_tokens"],
        tokens_per_s=m["tokens_per_s"], step_ms_p50=float(np.median(step_ms)),
        step_ms_min=min(step_ms), counts=counts, per_step=per_step,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    print(f"  K1 path: {steps} steps, {m['generated_tokens']} tokens in {wall:.2f} s: "
          f"{m['tokens_per_s']:.1f} tok/s, step p50 {run_a['step_ms_p50']:.2f} ms "
          f"(min {run_a['step_ms_min']:.2f}); launches {counts}; build {t_build:.1f} s; "
          f"peak memory {run_a['peak_mem_gb']:.1f} GB", flush=True)
    tokens_a = {r.rid: list(r.out_tokens) for r in eng.finished}
    profile_engine(torch, Engine(cfg, eng.params, ecfg, head=eng._head), cfg, report)

    # the K-blocked path: the same packed words with block_k=512 (as a
    # deployment plan with an autotuned block_k sets); the head stays K1
    blocked = T.map_leaves(
        eng.params,
        lambda a: dataclasses.replace(a, block_k=512) if isinstance(a, PackedDenseParams) else a,
    )
    eng_b = Engine(cfg, blocked, ecfg, head=eng._head)
    max_new_b = 8
    m_b, counts_b, wall_b = _serve(torch, eng_b, prompts, max_new_b)
    per_step_b = {"packed_dense_fused": 1, "packed_matmul": cfg.n_layers * 7,
                  "paged_gather": cfg.n_layers}
    check(m_b["statuses"] == {"ok": len(prompts)}, f"blocked engine statuses {m_b['statuses']}")
    check(counts_b == {k: v * m_b["steps"] for k, v in per_step_b.items()},
          f"blocked launch counters {counts_b} != {per_step_b} x {m_b['steps']} steps")
    same = all(r.out_tokens == tokens_a[r.rid][:max_new_b] for r in eng_b.finished)
    check(same, "the K-blocked path gave other tokens than the fused path")
    step_ms_b = [1e3 * s for s in eng_b.step_seconds]
    run_b = dict(steps=m_b["steps"], wall_s=wall_b, tokens=m_b["generated_tokens"],
                 tokens_per_s=m_b["tokens_per_s"], step_ms_p50=float(np.median(step_ms_b)),
                 counts=counts_b, per_step=per_step_b)
    print(f"  K2 path: {m_b['steps']} steps, {m_b['tokens_per_s']:.1f} tok/s, step p50 "
          f"{run_b['step_ms_p50']:.2f} ms; launches {counts_b}; tokens equal the K1 path's", flush=True)
    report["engine"] = {"fused": run_a, "blocked": run_b}
    del eng, eng_b, blocked
    return {"fused": run_a, "blocked": run_b}


def profile_engine(torch, eng, cfg, report: dict) -> None:
    """Trace a short run of a fresh engine: device busy share and kernel
    time by name.  Its launches are not counted against any path."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(2)
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab, 16).tolist(), 8)
    eng.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        m = eng.run(realtime=True)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    # device-side events only (kernels, copies, memsets): the CPU-side op rows
    # carry the device time of the kernels they launched a second time
    rows = [{"name": ev.key, "device_ms": ev.self_device_time_total / 1e3, "count": ev.count}
            for ev in prof.key_averages()
            if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    groups = {"K1 packed_kernel": "packed_kernel", "K3 gather": "gather_", "memcpy": "Memcpy",
              "memset": "Memset"}
    by_group = {g: sum(r["device_ms"] for r in rows if key in r["name"]) for g, key in groups.items()}
    by_group["other kernels (PyTorch)"] = busy - sum(by_group.values())
    report["profile"] = {"wall_ms": wall * 1e3, "steps": m["steps"], "device_busy_ms": busy,
                         "device_busy_share": busy / (wall * 1e3), "by_group_ms": by_group,
                         "top": rows[:25]}
    (OUT_DIR / "profile.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    print(f"  profile: {m['steps']} steps in {wall * 1e3:.1f} ms (traced), device busy "
          f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f} %): "
          + ", ".join(f"{g} {v:.1f} ms" for g, v in by_group.items()), flush=True)
    for r in rows[:8]:
        print(f"    {r['device_ms']:9.3f} ms  x{r['count']:5d}  {r['name'][:90]}", flush=True)


# -- phase 5 -------------------------------------------------------------------


def phase_crosscheck(torch, cfg, report: dict, steps: int = 3) -> dict:
    import numpy as np

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving.api import quantize_params_packed

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = T.init_params(cfg2, seed=1, device="cuda")
    head = L.prepack_lm_head(params["embed"], w_bits=4, a_bits=4, device="cuda")
    packed = quantize_params_packed(params, w_bits=4, a_bits=4, device="cuda")
    del params
    cpu_packed = T.map_leaves(packed, lambda a: a.to("cpu"))
    cpu_head = head.to("cpu")
    S, ps, nb = 8, 16, 4
    n_pages = S * nb + 1
    states = {dev: T.init_paged_state(cfg2, S, n_pages, ps, dtype=torch.float32, device=dev)
              for dev in ("cuda", "cpu")}
    table = torch.arange(1, n_pages, dtype=torch.int32).reshape(S, nb)
    rng = np.random.default_rng(5)

    # record the activation levels every packed matmul quantizes, per slot
    levels: list = []
    inner = L.packed_dense

    def recording(x, w, **kw):
        n = (1 << w.a_bits) - 1
        levels.append(torch.round(torch.clamp(x.float(), 0.0, 1.0) * n).to(torch.int16).cpu())
        return inner(x, w, **kw)

    flipped = torch.zeros(S, dtype=torch.bool)  # a level differed at this or an earlier step
    results = []
    L.packed_dense = recording
    try:
        for t in range(steps):
            tokens = torch.from_numpy(rng.integers(0, cfg2.vocab, (S, 1)).astype(np.int32))
            pos = torch.full((S,), t, dtype=torch.int32)
            levels.clear()
            g_log, _ = T.forward_decode_paged(packed, cfg2, states["cuda"], table.cuda(),
                                              tokens.cuda(), pos.cuda(), head=head, gather="kernel")
            g_levels = list(levels)
            levels.clear()
            c_log, _ = T.forward_decode_paged(cpu_packed, cfg2, states["cpu"], table, tokens, pos,
                                              head=cpu_head, gather="kernel")
            check(len(levels) == len(g_levels) == 7 * cfg2.n_layers + 1, "packed matmul count")
            for g, c in zip(g_levels, levels):
                flipped |= (g != c).any(dim=1)
            g_log = g_log.cpu()
            check(bool(torch.isfinite(g_log).all()), f"non-finite logits at cross-check step {t}")
            diff = (g_log - c_log).abs()
            row_max = diff.max(dim=1).values
            row_rel = (torch.linalg.vector_norm(g_log - c_log, dim=1)
                       / torch.linalg.vector_norm(c_log, dim=1))
            clean = ~flipped
            top2 = torch.topk(c_log, 2, dim=1).values
            agree = torch.argmax(g_log, 1) == torch.argmax(c_log, 1)
            decided = (top2[:, 0] - top2[:, 1]) > 2 * row_max
            results.append(dict(
                step=t, clean_rows=int(clean.sum()),
                clean_max_abs=float(row_max[clean].max()) if clean.any() else None,
                flipped_max_rel=float(row_rel[flipped].max()) if flipped.any() else None,
                tokens_agree=int(agree.sum()), tokens_decided=int(decided.sum())))
            r = results[-1]
            print(f"  step {t}: {r['clean_rows']}/{S} rows with identical activation levels, their "
                  f"max|d| {r['clean_max_abs']}; rows with a level flip: max rel L2 "
                  f"{r['flipped_max_rel']}; greedy tokens agree {r['tokens_agree']}/{S}", flush=True)
            check(bool((row_max[clean] <= CROSS_CLEAN_ABS_TOL).all()),
                  f"cross-check step {t}: a row without level flips differs by more than "
                  f"{CROSS_CLEAN_ABS_TOL}")
            check(bool((row_rel[flipped] <= CROSS_FLIP_REL_TOL).all()),
                  f"cross-check step {t}: a row with level flips differs by more than "
                  f"{CROSS_FLIP_REL_TOL} relative")
            check(bool((agree | ~decided | flipped).all()),
                  f"cross-check step {t}: greedy token differs past the gap bound")
            check(int(clean.sum()) >= S // 2, f"cross-check step {t}: level flips in most rows")
    finally:
        L.packed_dense = inner
    report["crosscheck"] = results
    return {"steps": results}


# -- main ------------------------------------------------------------------------


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.serving import EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    report: dict = {}
    t_start = time.monotonic()

    print("phase 1: build", flush=True)
    t0 = time.monotonic()
    reports = build.build_all()
    for name in build.SOURCES:
        build.library(name)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}", flush=True)
    smi_line = smi("name,power.limit")
    clock = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    card = Card(name=torch.cuda.get_device_name(0), power_limit=smi_line.split(",")[-1].strip(),
                sms=props.multi_processor_count, clock_mhz=clock)
    report["build_s"] = time.monotonic() - t0
    report["card"] = dict(smi=smi_line, sms=card.sms, clock_max_sm_mhz=clock,
                          int32_ops_per_s=card.int32_ops_per_s, hbm_bytes_per_s=HBM_BYTES_PER_S,
                          torch=torch.__version__, cuda=torch.version.cuda)
    print(f"  built in {report['build_s']:.1f} s on {smi_line}; {card.sms} SMs, max SM clock "
          f"{clock:.0f} MHz -> int32 IMAD peak {card.int32_ops_per_s / 1e12:.2f} Tops/s", flush=True)

    cfg = get_config("llama3.2-3b")
    ecfg = EngineConfig(n_slots=8, page_size=16, max_len=256, chunk_tokens=1, admit="reserve",
                        packed_head=True, head_bits=(4, 4), gather_backend="kernel")
    timer = Timer(torch)

    print("phase 2: K1/K2 vs plain at the full-width decode shapes", flush=True)
    mm = phase_matmul(torch, card, timer, cfg, ecfg.n_slots, report)
    print("phase 3: K3 vs plain at the engine geometry", flush=True)
    ga = phase_gather(torch, card, timer, cfg, ecfg, report)
    del timer
    torch.cuda.empty_cache()
    print("phase 4: engine, llama3.2-3b full width, w4a4 packed, packed (4,4) head, kernel gather",
          flush=True)
    en = phase_engine(torch, cfg, ecfg, report)
    torch.cuda.empty_cache()
    print("phase 5: whole-path cross-check, 2 layers at full width, card vs CPU", flush=True)
    phase_crosscheck(torch, cfg, report)

    # per-decode-step totals per kernel: the sum over the launches of one step
    def step_sum(rows, key):
        return sum(r[key] * r["per_step"] for r in rows)

    served = [r for r in mm["rows"] if r["placement"] == "w4a4 overlap=1"]
    layers = [r for r in served if r["shape"] != "head"]
    head = [r for r in served if r["shape"] == "head"]
    gather = [r for r in ga["rows"] if r["case"] == "bf16 pool, full causal"]

    def by(rows, bytes_key="bytes"):
        t_b = sum(r[bytes_key] * r["per_step"] for r in rows) / HBM_BYTES_PER_S * 1e3
        t_o = sum(r.get("int32_ops", 0) * r["per_step"] for r in rows) / card.int32_ops_per_s * 1e3
        return "bytes" if t_b >= t_o else "operations"

    # each kernel's launches come from the run of the path it serves: K1 and
    # K3 from the fused (whole-K) run, K2 from the block_k=512 run
    fused, blocked = en["fused"], en["blocked"]
    kernels = [
        dict(name="packed_dense_fused", route="cuda", source="src/repro_torch/csrc/packed_matmul.cu",
             replaces="src/repro/kernels/packed_matmul/kernel.py:111",
             launches=fused["counts"]["packed_dense_fused"], max_abs_err=mm["max_err"],
             ms=step_sum(served, "k1_ms"), plain_ms=step_sum(served, "plain_ms"),
             bound_ms=step_sum(served, "bound_ms"), bound_by=by(served),
             library_ms=step_sum(served, "library_ms"), path="fused", path_steps=fused["steps"],
             per="decode step"),
        dict(name="packed_matmul", route="cuda", source="src/repro_torch/csrc/packed_matmul.cu",
             replaces="src/repro/kernels/packed_matmul/kernel.py:168",
             launches=blocked["counts"]["packed_matmul"], max_abs_err=mm["max_err"],
             ms=step_sum(layers, "k2_ms"), plain_ms=step_sum(layers, "plain_ms"),
             bound_ms=step_sum(layers, "bound_ms"), bound_by=by(layers),
             library_ms=step_sum(layers, "library_ms"), path="block_k=512",
             path_steps=blocked["steps"], per="decode step"),
        dict(name="paged_gather", route="cuda", source="src/repro_torch/csrc/paged_gather.cu",
             replaces="src/repro/kernels/paged_gather/kernel.py:121",
             launches=fused["counts"]["paged_gather"], max_abs_err=ga["max_err"],
             ms=step_sum(gather, "k3_ms"), plain_ms=step_sum(gather, "plain_ms"),
             bound_ms=step_sum(gather, "bound_ms"), bound_by="bytes",
             library_ms=step_sum(gather, "library_ms"), path="fused", path_steps=fused["steps"],
             per="decode step"),
    ]
    report["kernels"] = kernels
    report["head"] = head
    report["total_s"] = time.monotonic() - t_start
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(f"all phases passed in {report['total_s']:.1f} s on {card.name} ({card.power_limit})")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
