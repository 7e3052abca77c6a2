#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py   # every phase; exits non-zero if any fails

Phases, all on the card:

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the card's name and power limit, and
   each K1/K2, K4, K5 and K6 instantiation's registers, shared memory and
   spills (the served K1, n_seg 2 overpacked and fused, the K4 and K5
   instantiations that phase 6 launches and the K6 ones phase 7 launches
   must not spill).
2. K1 (``packed_dense_fused``) and K2 (``packed_matmul``, block_k=512)
   against their plain versions at every full-width llama3.2-3b matmul
   shape of a decode step (M = 8 slots), the 128256-wide LM head
   included, overpacked w4a4 and one no-overpack placement: bit-exact.
   One call of each, captured in a CUDA graph, must be their two kernel
   nodes and nothing else (no memset).  Yardsticks: ``torch._int_mm`` on
   the int8 levels (the same function; M padded to 32) and a bf16 matmul;
   achieved GB/s per shape.  Then K1 at a chunked step's rows (M = 8 slots
   x 16 lanes = 128) at every layer shape: bit-exact, timed beside its
   bound and ``torch._int_mm``.
3. K3 (``paged_gather``) against its plain version at the engine's
   geometry and at a long-context one (``LONG_GATHER``: 32 slots of 4096
   tokens, 1024-4095 live a slot, D 1024, page 16): a bf16 pool with null
   pages, and an int8 pool, each with and without a sliding window, at one
   lane and at the chunk width (at the engine's geometry 16 lanes that
   cross a page boundary and run past the live pages): bit-exact.
   Yardsticks: ``pool[table]``, and for the int8 pool the same function,
   ``pool[table].to(bf16) * scale[table].to(bf16)``.
4. The engine: llama3.2-3b at full width (28 layers, d 3072, vocab
   128256), w4a4 packed projections, the packed (4, 4) LM head and the
   kernel gather, built with ``build_engine`` from random weights (seed
   0), serving 8 requests (prompts of 16-64 tokens, 32 new tokens each)
   with its step captured as one CUDA graph (the engine's default on the
   card).  Every request must end ``ok`` with finite logits, the launch
   counters (a replay adds the launches its capture counted) must equal
   the per-step counts times the steps, and the graph's own kernel nodes
   (``cuGraphGetNodes``) must be those per-step counts with no memset.
   The timed run sets no hook; an untimed run of the same weights records
   every sampled logits row and its top-2 gap, and must give the same
   tokens; the device time of one replay of its graph is read beside the
   step time.  A short traced run of the same weights (``torch.profiler``)
   gives the device's busy share and its time by kernel.  A last run
   serves the same weights with ``block_k=512``, the K-blocked path (K2),
   and must give the same tokens.  Each path's launch counts come from its
   own run.
5. Whole-path cross-check: a 2-layer model of the same width, float32,
   on the card (kernels) and on the CPU (plain versions) from the same
   packed words, a few decode steps and one chunked step of 16 lanes (an
   inactive slot, decoding slots, partial and full chunks); logits within
   the stated tolerance, and activation-level flips rare among the rows
   whose inputs no earlier flip moved.
6. The int8-lane entry points ``quant_dense`` (K4) and
   ``quant_packed_dense`` (K5 at w2a2 and w2a3; w4a4 takes the plain
   integer path) from float inputs at every full-width decode shape (M =
   8) and one M = 128 shape; their launch counts; two shapes against the
   CPU.  Then K4 and K5 against their plain versions on the same integer
   operands at every shape: bit-exact; one K4 call and one K5 call, each
   captured in a CUDA graph, must be one kernel node and nothing else (no
   memset).  Last, K1, K5 and K4 at shapes that split K, launched in turns
   on two streams with no synchronisation between them, must each equal
   their plain versions (each stream has its own split-K counters).
7. The Filter-Packing entry point ``packed_conv1d`` (K6) at UltraNet's
   five 3x3 layers split into row convolutions, at w2a2, w3a4 and w4a4,
   and one 7-tap case; its launch count; K6 against its plain version and
   the plain convolution: bit-exact; one call, captured in a CUDA graph,
   must be one kernel node and nothing else (no memset).
8. ``build_engine`` at its default bits (w4a8 projections, the packed (8,
   8) head), 2 layers at full width, float32: no placement exists, so
   every matmul takes the plain integer path on the card, captured in the
   step's graph like any other op.  8 requests must end ``ok``; then the
   same weights on the card and the CPU, a few decode steps, logits within
   the stated tolerance.
9. Chunked prefill, the slice's path: phase 4's weights, prompts and
   engine settings at ``chunk_tokens=16``, once under reserve admission and
   once on demand with a pool of about 60 % of the requests' summed worst
   case, each step one replay of the engine's captured graph (preemption
   rewrites the block table between replays).  Every request must end
   ``ok``, the on-demand run must preempt and leak nothing, the launch
   counters and the graph's kernel nodes must equal the per-step counts
   (times the steps), and every sampled logits row and token must agree
   with phase 4's within the stated tolerances (rows recorded by an
   untimed repeat of each run).  A planted fault, the head fed each
   slot's last lane instead of its last valid one, must fail those
   checks.  Prints steps, tokens fed, TTFT, step time and tok/s of phase
   4 and both runs.
10. The captured step against the eager one (``capture=False``, the
   reference's ``jax.disable_jit()``): after a warm-up, an eager step at
   C = 1 and at C = 16 must make no synchronising call
   (``torch.cuda.set_sync_debug_mode("error")``); phase 4's cell and
   phase 9's reserve cell, each served eagerly and captured by an untimed
   recording run, must give bit-identical sampled rows and equal tokens;
   then each cell is served in alternating timed turns (eager, captured,
   captured, eager, ...; 4 pairs), every turn with the recorded tokens,
   printing step p50, tok/s and TTFT of every turn and the device time
   of one replay of each captured turn's graph.  Traces of the eager C = 1
   run and of both C = 16 runs give each one's device busy share and time
   by kernel.
11. Deployment plans: ``search_plan`` for llama3.2-3b at full width
   (footprint objective, budget 0.85 of w4a4; the LUT built in-process
   when the cache under ``build/`` is missing) must give the CPU's content
   hash (``PLAN_HASH``: layers 0-2 w8a8, 3-5 w5a4, 6-27 w3a2, head (8,
   8)); ``autotune_plan`` times every ``block_k`` candidate on the card
   (printed with the layers it moves to K2), ``measure_pair_times`` every
   pair of the search's bit choices, and the search runs again with those
   measured times (printed, not served).  K1 and K2 at every (pair, shape, block_k) the tuned
   plan serves against their plain versions: bit-exact, timed by graph
   beside the bound and ``torch._int_mm``.  The tuned plan served at full
   width through ``build_engine(plan=...)`` with phase 4's settings and
   prompts: every request ``ok``, the projection weight bytes on the card
   equal to the plan's prediction, the launch counters and the graph's
   port kernel nodes equal to the per-step counts the plan implies (times
   the steps); then timed in alternating turns with phase 4's w4a4 cell
   (plan, w4a4, w4a4, plan, ...; 3 pairs), each turn giving the tokens of
   its cell's first run, and traced once.  The same pairs at 3 layers
   (w8a8, w5a4, w3a2 at their tuned ``block_k``, the (8, 8) head) on the
   card and the CPU from the same packed words, within phase 5's and
   phase 8's tolerances (see ``_plan_cross_check``).  Last, a uniform (4,
   4) plan through ``build_engine(plan=...)``: sampled rows bit-identical
   to phase 4's ``quant="packed"`` engine.

12. int8 KV pools and int8 serving weights: (a) phase 4's cell with
   ``kv_dtype="int8"``, every turn ``ok`` with its census (197 K1 and 28
   K3, every K3 node ``gather_i8``, no memset) and counters checked, timed
   in alternating turns with phase 4's bf16 pools (int8, bf16, bf16, int8;
   2 pairs), its sampled rows and tokens read against phase 4's (not a
   gate); (b) phase 9's on-demand cell on int8 pools at phase 9's page
   count (it must preempt and leak nothing) and at phase 9's pool bytes
   (levels and scales counted, about 1.99x the pages); (c) phase 5's
   card-vs-CPU check on int8 pools under both gathers, with phase 5's
   rules and the KV levels that differ counted; (d) ``build_engine(
   quant="int8")`` with the float head: int8 levels and scales on the card
   equal to the projections' sizes, 28 K3 and no other port kernel a
   step, timed in alternating turns with ``quant=None`` on the same float
   weights, then 2 layers of it on int8 pools against the CPU within the
   stated tolerance (``INT8_W_REL_TOL``).
13. The request lifecycle, on phase 4's weights and engine settings, each
   engine's step one captured graph: (a) ``lifecycle_schedule``'s 20
   requests (phase 4's 8 and 12 later arrivals; interactive and batch
   SLOs, explicit deadlines, a cancel while waiting and one mid-decode,
   ``max_waiting=6``) on the virtual clock must give every outcome of
   ``LIFE_OUTCOMES`` and, per request, the status, shed reason, token
   count, first-token and finish steps (and the run's steps) of the same
   schedule on the CPU at the smoke size; phase 4's requests that sampled
   must match phase 4's rows and tokens within phase 9's tolerances (the
   bit-identical rows are counted); counters and graph as in phase 4, one
   capture, no leaks; (b) 16 requests with one straggler in each gang of 8
   under ``policy="static"`` and ``"continuous"``: steps equal to the
   CPU's, static taking more; (c) (a)'s schedule on the wall clock, every
   time scaled by phase 4's step p50: terminal statuses, shed reasons in
   the reference's set, no ``ok`` request past its deadline plus the
   longest step, the step-time EWMA within 0.5-2x the run's step p50;
   prints goodput (``ok`` tokens a wall second) and TTFT.
14. gemma3-1b at full width (26 layers, 21 of them with a 1024-token
   sliding window, one KV head of width 256, geglu, vocab 262144), bf16,
   random weights from seed 0, nothing cut, served past its window: w4a4
   projections, the packed (4, 4) head and the kernel gather, 8 slots,
   page 16, ``max_len`` 2048 (128 blocks a slot), ``chunk_tokens=16``,
   reserve admission, 8 requests of 1135-1444 prompt and 32 new tokens.
   First K1 at the engine's per-step shapes (the layers at 128 rows, the
   head at 8) against its plain version, timed by graph beside its bound
   and ``torch._int_mm``.  (a) The serve, one capture: every request
   ``ok``, no leaks, counters and graph nodes 26 x 7 + 1 K1 and 26 K3 a
   step, no memset; step p50, one replay's device time, tok/s, TTFT; an
   untimed repeat records every sampled row and each step's batch, and
   traces 10 decode steps.  (b) The same on int8 KV pools, its rows and
   tokens read against (a)'s (not a gate).  (c) K3 on (a)'s and (b)'s
   layer-0 pools and block tables against its plain version, bit-exact
   (window 1024 and 0, chunk 1 and 16), timed beside its bytes bound and
   ``pool[table]``; at every step of (a), the live keys K3's window mask
   drops for each decoding slot must be ``pos + 1 - 1024`` > 0.  (d)
   Phase 5's card-vs-CPU check at 2 layers (both windowed, float MLP
   projections, packed attention projections and head) from position
   1500, and a planted fault it must reject: the CPU side run with
   ``window_pattern=(0,)``; beside it, not a gate, the w_down input levels
   that differ between the card and the CPU when the MLP is packed.

15. mamba2-130m at full width (24 layers, d 768, d_inner 1536, 24 heads of
   64, state 128, conv width 4, vocab 50432), bf16, random weights from
   seed 0, nothing cut: the SSM family's path, which runs K1 (three
   projections a layer and lane, and the head) and no K3, its float32
   recurrent state written in place by the captured step and zeroed per
   slot on every (re-)admission, between steps.  (a) K1 at its four shapes
   at M = 16 against its plain version, timed by graph beside its bound and
   ``torch._int_mm``.  (b) The serve, w4a4 and the packed (4, 4) head, 16
   slots, page 16, ``max_len`` 2048, on demand: at C = 16 16 prompts of
   512-1536 tokens and at C = 1 16 of 64-128, 64 new tokens each; every
   request ``ok``, one capture, no leaks, counters and graph nodes 3 x 24
   x C + 1 K1 a step; step p50, one replay's device time, tok/s, TTFT, the
   step's bytes bound (the state read and written once, or once a lane as
   the chunk loop does), a trace of a short run.  (c) 16 prompts of 2-8
   tokens in pages of 4 with a pool that forces at least 8 preemptions,
   against the same requests with none: every sampled row bit-identical;
   with the reset skipped on re-admission (a planted fault) rows must
   differ.  (d) The card against the CPU at 2 layers (float: rows and
   states within 1e-4 relative L2; w4a4: phase 5's rules) over decode
   steps, chunked steps and a re-admission, and the planted fault (the
   card keeps a re-admitted slot's state) that the float check must reject.

16. qwen3-moe-30b-a3b at full width (d 2048, 32 heads of 64, 4 KV heads,
   128 experts, top-8, expert d_ff 768, vocab 151936, capacity 1.25), bf16,
   random weights from seed 0, 12 of its 48 layers (a cut forced by memory:
   float32 experts are 2.42 GB a layer at build): MoE with packed experts,
   K1 over an expert grid axis.  (a) K1 and K2 (block_k 512) over the 128
   experts in one launch at w_up|w_gate (2048x768) and w_down (768x2048), M
   = 1 and 12 rows a bucket: bit-exact against their plain versions, one
   captured call one kernel node, timed by graph beside the bytes bound and
   a bf16 ``torch.bmm``.  (b) The serve: w4a4 projections and experts, the
   packed (4, 4) head, the kernel gather, 8 slots, page 16, ``max_len``
   512, reserve, at C = 16 on 8 prompts of 128-384 tokens and at C = 1 on
   phase 4's prompt lengths, 32 new each: every request ``ok`` with finite
   logits, one capture, no leaks, counters and graph nodes 12 x 7 + 1 = 85
   K1 and 12 K3 a step, memset nodes only where a PyTorch op puts them
   (named); step p50, one replay's device time, tok/s, TTFT, a one-step
   trace by kernel group, the step's bytes bound; an eager step reads
   nothing back to the host, and ``capture=False`` on the same weights
   samples the captured rows bit for bit and counts the copies the
   dispatch drops a step.  (c) The card against the CPU at 2 layers,
   float32, float and w4a4: routing flips and activation-level flips
   counted, clean rows within 1e-4 relative L2 (float) or equal (w4a4).

17. Chaos and snapshots: the engine's fault layer at full width, each
   engine's step one captured graph.  Every fault family (step, allocation,
   NaN) at rate 0.2 (seed 3), 64 strikes a request, and hard faults planted
   by wrapping the step program's run, before a step or after its replay
   has written the state, each restored from a snapshot, written into the
   state's tensors in place.  (a) Phase 9's on-demand cell (phase 4's
   weights and prompts, C = 16, 0.60 of the worst case), fault-free, with
   snapshots every 4 steps only, and under chaos with two hard faults
   (steps 6 and 20); the step p50 of each.  (b) mamba2-130m at full width,
   C = 1, 16 slots, phase 15 (c)'s 16 prompts of 2-8 tokens, 16 new,
   fault-free and under chaos with one hard fault (snapshots every 16
   steps).  Every run: every request ``ok``, the launch counters the
   per-step counts times the replays, the graph's kernel nodes those
   counts, one capture, the state's ``data_ptr``s unchanged, no leaks.
   Under chaos: every sampled row bit-identical to the fault-free run's,
   every fault family, quarantines and retries seen, the hard recoveries
   restored from snapshots, and the decisions (counters, statuses, each
   request's strikes, preemptions and tokens) equal to the same runs'
   on the CPU at the smoke size, which the phase makes itself.  A planted
   fault, a restore that rebinds the state, must fail: in (a) on the
   state's addresses, in (b) on its rows (the step keeps the stale
   recurrent state).
18. Observability at full width, on phase 4's weights (built again from
   seed 0).  (a) Phase 4's cell (C = 1, 8 requests, 32 new tokens each),
   traced, with ``ObsConfig(attrib_every=8)``: the sampled rows
   bit-identical to an untraced, unattributed run's; the step's graph
   captured once and the launch counters its kernel nodes times the
   steps (the attribution's segment graphs count apart); the reference's
   trace gate (``benchmarks/check_invariants.py``, stdlib only, loaded
   by path) returns no error; one ``dispatch``, ``device_wait`` and
   ``step`` span a step; a sample every 8 steps, each with 28 layer rows
   whose shares sum to 1 and whose segments' summed device time (embed,
   layers, head) lies within ``ATTRIB_GRAPH_TOL`` of one replay of the
   step's graph at that step; at the first sample, the head segment's
   rows equal the step's logits bit for bit (the segments ran on the
   attributor's copy of that step's pre-step state); the exposition
   conforms.  Each layer's mean device time and share and the per-pair
   totals are printed.  (b) Phase 17 (a)'s chaos run (phase 9's
   on-demand cell, every family at 0.2, seed 3, the two hard faults),
   traced with ``attrib_every=16``: the gate reconciles one ``inject_*``
   instant with each counted fault and finds one terminal span a request,
   phase 17's run checks hold, and the decisions equal phase 17's.  (c)
   (a)'s cell in ``run(max_steps=k)`` slices: between slices the live
   windows and gauges move and the exposition conforms.

Every engine's graph and memory pool is released before the next engine
is built, and each phase prints its peak device memory.

Kernel and library times come from CUDA graphs of 100 launches divided
by 100: an event pair around one launch of under about 0.1 ms measures
the host's enqueue.  The matmuls' weights are cycled through copies
totalling at least 256 MB, so that the 50 MB L2 cannot hold them (a
decode step reads each layer's weights once); K3's and K6's operands are
not (K3's at the long geometry are far past the L2 anyway).  Each
kernel's event time (median of one event pair per launch, L2 flushed
before each) is kept beside it; plain versions, which synchronise
with the host, are timed by events only.  The line before the last is the
kernels JSON, the one before it the card's ``nvidia-smi`` name and power
limit, and the last line is ``{"ok": true, "device": {...}}``.  Details
go to ``chip_smoke.json`` in ``OUT_DIR``.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT32_LANES_PER_SM = 64  # IMAD lanes per Hopper SM and clock
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak, NVIDIA data sheet

# how the kernels line's ms and library_ms are taken; events_ms beside them
# is the median of one CUDA-event pair per launch, L2 flushed before each
GRAPH_TIMING = "CUDA graph of 100 launches (matmul weights cycled through 256 MB), divided by 100"

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
# relative L2; and flips must stay rare (at a decode step at least half the
# slots without one; at a chunked step at least half the rows that no
# earlier flip reaches, see _first_hand).
CROSS_CLEAN_ABS_TOL = 1e-3
CROSS_FLIP_REL_TOL = 0.2

# the chunk width of phase 9's chunked engine (8 slots x 16 lanes = 128
# rows into every projection), of phase 3's chunked gather and of phase 5's
# chunked step
CHUNK = 16

# phase 11: content hash of search_plan(llama3.2-3b full, footprint, budget 0.85), the
# reference's (tests/test_torch_plan.py holds it against the reference on the CPU)
PLAN_HASH = "442c1f04caef00bb"


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
    """Median CUDA-event time of one call, the L2 cache flushed before each;
    :meth:`graph` for launches too short for one event pair each."""

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

    def graph(self, fn, launches: int = 100, reps: int = 5) -> float:
        """Device time of one call: ``fn(0) .. fn(launches - 1)`` captured in
        one CUDA graph, the median replay time over ``reps`` divided by
        ``launches``.  Under about 0.1 ms an event pair around one launch
        measures the host's enqueue; a graph replays back to back with no
        host between launches.  Nothing is flushed between the calls of a
        replay: a caller that needs its operands cold passes ``fn(i)`` that
        cycles through :func:`cold_copies`."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # first calls (handles, library loads) outside the capture
            fn(0)
            fn(1)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(launches):
                fn(i)
        g.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            g.replay()
            e1.record()
            times.append((e0, e1))
        torch.cuda.synchronize()
        vals = sorted(a.elapsed_time(b) for a, b in times)
        del g
        return vals[len(vals) // 2] / launches


def cold_copies(t, budget: int = 256 << 20) -> list:
    """``t`` and enough clones of it that cycling through them touches at
    least ``budget`` bytes, five times the H100's 50 MB L2: a graph launch
    that takes the next copy finds its operand in HBM, as a decode step
    finds each layer's weights."""
    n = max(1, min(100, -(-budget // (t.numel() * t.element_size()))))
    return [t] + [t.clone() for _ in range(n - 1)]


@dataclasses.dataclass
class Card:
    name: str
    power_limit: str
    sms: int
    clock_mhz: float

    @property
    def int32_ops_per_s(self) -> float:
        return self.sms * INT32_LANES_PER_SM * self.clock_mhz * 1e6

    def bound(self, n_bytes: float, ops: float, ops_per_s: float | None = None
              ) -> tuple[float, str, float, float]:
        """(bound ms, what bounds it, bytes ms, ops ms); ``ops`` run at
        ``ops_per_s``, by default the int32 IMAD peak."""
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / (ops_per_s or self.int32_ops_per_s) * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops


def decode_matmul_shapes(cfg) -> dict[str, tuple[int, int, int]]:
    """name -> (K, N, launches per decode step) for every packed matmul
    (wq and wo apart where ``n_heads x hd`` is not ``d_model``)."""
    d, hd, L = cfg.d_model, cfg.hd, cfg.n_layers
    qo = cfg.n_heads * hd
    attn = ({"wq|wo": (d, qo, 2 * L)} if qo == d else {"wq": (d, qo, L), "wo": (qo, d, L)})
    return {
        **attn,
        "wk|wv": (d, cfg.kv_heads * hd, 2 * L),
        "w_up|w_gate": (d, cfg.d_ff, 2 * L),
        "w_down": (cfg.d_ff, d, L),
        "head": (d, cfg.vocab, 1),
    }


# kernel symbol -> (template-argument pattern of its mangled name, field names)
PTXAS_KERNELS = {
    "packed_ring_kernel": (r"packed_ring_kernelILi(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E",
                           ("n_seg", "overlap", "fused", "vec", "batched")),
    "quant_packed_mma_kernel": (r"quant_packed_mma_kernelILb(\d)ELi(\d+)E", ("overlap", "copy")),
    "quant_mma_kernel": (r"quant_mma_kernelILi(\d+)ELi(\d+)E", ("bm", "copy")),
    "filter_tile_kernel": (r"filter_tile_kernelILi(\d)ELb(\d)ELb(\d)E", ("nseg", "overlap", "v2")),
}


def ptxas_kernels(text: str, kernel: str) -> list:
    """Registers, static shared memory and spills of every instantiation of
    ``kernel`` (a key of :data:`PTXAS_KERNELS`) in an ``nvcc -Xptxas=-v``
    report (empty when the library was already built)."""
    import re

    pattern, fields = PTXAS_KERNELS[kernel]
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(pattern, m.group(1))
            cur = None
            if t:
                cur = dict(zip(fields, map(int, t.groups())))
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


# -- phase 2 -------------------------------------------------------------------


def k1_bound(card, M: int, K: int, N: int, nbytes: float) -> tuple[float, str, float, float]:
    """The least time of K1's or K2's function, an int32 ``[M, N]`` product
    of 4-bit levels: its bytes, or its ``M x K x N`` products on the s8
    tensor cores (which the card offers for it), whichever is longer.  Not
    the packed words' IMADs: they are this kernel's algorithm, not a floor."""
    return card.bound(nbytes, 2 * M * K * N, INT8_OPS_PER_S)


def phase_matmul(torch, card, timer, cfg, M: int, report: dict) -> dict:
    from repro_torch.kernels.packed_matmul import ref as pm
    from repro_torch.kernels.packed_matmul.kernel import (
        BM, BN, grid_plan, packed_dense_fused_plain, packed_dense_fused_raw, packed_matmul_plain,
        packed_matmul_raw,
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
            w8 = w_lvl.to(torch.int8)  # the same levels for torch._int_mm
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
            nodes = device_nodes(torch, lambda: (packed_dense_fused_raw(x, wp, a_bits=4, **kw),
                                                 packed_matmul_raw(a_lvl, wp, block_k=512, **kw)))
            two = {"packed_dense_fused": 1, "packed_matmul": 1}
            check(nodes == (only_kernels(two), two),
                  f"K1 + K2 at {name} ran other device work than their two kernels: {nodes}")
            Np = wp.shape[1]
            splits, k_per_split = grid_plan(M, K, Np, card.sms)
            blocks = -(-M // BM) * -(-Np // BN) * splits
            nbytes = M * K * 4 + K * Np * 4 + M * N * 4 + M * 4
            b_ms, b_by, t_b, t_o = k1_bound(card, M, K, N, nbytes)
            w_bf16 = torch.randn((K, N), generator=g, device="cuda", dtype=torch.bfloat16)
            x_bf16 = x.to(torch.bfloat16)
            int_mm, int_mm_m = _int_mm(torch, a_lvl.to(torch.int8), w8)
            wps, w_bf16s, w8s = cold_copies(wp), cold_copies(w_bf16), cold_copies(w8)
            row = dict(
                shape=name, K=K, N=N, M=M, placement=label, per_step=per_step, splits=splits,
                k_per_split=k_per_split, blocks=blocks,
                k1_ms=timer(lambda: packed_dense_fused_raw(x, wp, a_bits=4, **kw), reps=20),
                k2_ms=timer(lambda: packed_matmul_raw(a_lvl, wp, block_k=512, **kw), reps=20),
                plain_ms=timer(lambda: packed_dense_fused_plain(x, wp, a_bits=4, **kw), reps=3),
                bf16_ms=timer(lambda: torch.matmul(x_bf16, w_bf16), reps=20),
                k1_graph_ms=timer.graph(lambda i: packed_dense_fused_raw(
                    x, wps[i % len(wps)], a_bits=4, **kw)),
                k2_graph_ms=timer.graph(lambda i: packed_matmul_raw(
                    a_lvl, wps[i % len(wps)], block_k=512, **kw)),
                bf16_graph_ms=timer.graph(lambda i: torch.matmul(x_bf16, w_bf16s[i % len(w_bf16s)])),
                int_mm_graph_ms=timer.graph(lambda i: int_mm(w8s[i % len(w8s)])), int_mm_m=int_mm_m,
                bound_ms=b_ms, bound_by=b_by, t_bytes=t_b, t_ops=t_o, bytes=nbytes,
            )
            row["k1_gbps"] = nbytes / row["k1_graph_ms"] / 1e6
            row["k2_gbps"] = (nbytes - M * 4) / row["k2_graph_ms"] / 1e6
            rows.append(row)
            print(f"  {name:12s} K={K:5d} N={N:6d} {label}, {blocks} blocks ({splits} K splits): "
                  f"K1 {row['k1_graph_ms']:.4f} ms by graph "
                  f"({row['k1_gbps']:.0f} GB/s; events {row['k1_ms']:.4f}), K2 {row['k2_graph_ms']:.4f} "
                  f"({row['k2_gbps']:.0f} GB/s; events {row['k2_ms']:.4f}), plain {row['plain_ms']:.3f} ms, "
                  f"_int_mm (M={int_mm_m}) {row['int_mm_graph_ms']:.4f}, bf16 matmul "
                  f"{row['bf16_graph_ms']:.4f} (events {row['bf16_ms']:.4f}), bound {b_ms:.4f} ms "
                  f"({b_by}); bit-exact, no memset", flush=True)
            del x, wp, acc, p_acc, acc2, p_acc2, w_bf16, x_bf16, a_lvl, wps, w_bf16s, w8, w8s, int_mm
    report["matmul"] = rows
    return {"max_err": max_err, "rows": rows}


def phase_matmul_chunk(torch, card, timer, cfg, M: int, report: dict, *, key: str = "matmul_chunk",
                       head_m: int = 0, shapes: dict | None = None) -> dict:
    """K1 at a chunked step's row count (slots x chunk width) at every
    full-width layer shape (``shapes``, by default
    :func:`decode_matmul_shapes`), the served w4a4 placement: bit-exact
    against its plain version, timed by graph beside its bound and
    ``_int_mm``.  The head stays at M = slots (the step takes each slot's
    last lane before it): it is left out, or with ``head_m`` taken at that
    M, so that the rows make up a whole chunked step.  The rows go to
    ``report[key]``."""
    from repro_torch.kernels.packed_matmul import ref as pm
    from repro_torch.kernels.packed_matmul.kernel import (
        BM, BN, grid_plan, packed_dense_fused_plain, packed_dense_fused_raw,
    )
    from repro_torch.kernels.packed_matmul.ops import choose_config

    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    c = choose_config(4, 4)
    kw = dict(a_bits=4, n_seg=c.n_seg, stride=c.stride, acc_chunk=c.acc_chunk, overlap=c.overlap)
    rows, max_err = [], 0.0
    for name, (K, N, per_step) in (shapes or decode_matmul_shapes(cfg)).items():
        if name == "head" and not head_m:
            continue
        m = head_m if name == "head" else M
        x = torch.rand((m, K), generator=g, device="cuda") * 1.2 - 0.1
        w_lvl = torch.randint(0, 16, (K, N), generator=g, device="cuda", dtype=torch.int32)
        wp = pm.pack_weights(w_lvl, c.n_seg, c.stride)
        w8 = w_lvl.to(torch.int8)
        del w_lvl
        acc, a_sum = packed_dense_fused_raw(x, wp, **kw)
        p_acc, p_sum = packed_dense_fused_plain(x, wp, **kw)
        torch.cuda.synchronize()
        err = max((acc - p_acc).abs().max().item(), (a_sum - p_sum).abs().max().item())
        check(torch.equal(acc, p_acc) and torch.equal(a_sum, p_sum),
              f"K1 differs from its plain version at {name} M={m}: max {err}")
        max_err = max(max_err, err)
        Np = wp.shape[1]
        splits, k_per_split = grid_plan(m, K, Np, card.sms)
        nbytes = m * K * 4 + K * Np * 4 + m * N * 4 + m * 4
        b_ms, b_by, t_b, t_o = k1_bound(card, m, K, N, nbytes)
        a8 = torch.round(torch.clamp(x, 0, 1) * 15).to(torch.int8)
        int_mm, int_mm_m = _int_mm(torch, a8, w8)
        wps, w8s = cold_copies(wp), cold_copies(w8)
        row = dict(shape=name, K=K, N=N, M=m, per_step=per_step, splits=splits,
                   k_per_split=k_per_split, blocks=-(-m // BM) * -(-Np // BN) * splits,
                   k1_graph_ms=timer.graph(lambda i: packed_dense_fused_raw(x, wps[i % len(wps)], **kw)),
                   k1_ms=timer(lambda: packed_dense_fused_raw(x, wp, **kw), reps=20),
                   plain_ms=timer(lambda: packed_dense_fused_plain(x, wp, **kw), reps=1, warmup=0),
                   int_mm_graph_ms=timer.graph(lambda i: int_mm(w8s[i % len(w8s)])), int_mm_m=int_mm_m,
                   bound_ms=b_ms, bound_by=b_by, t_bytes=t_b, t_ops=t_o, bytes=nbytes)
        row["k1_gbps"] = nbytes / row["k1_graph_ms"] / 1e6
        rows.append(row)
        print(f"  {name:12s} K={K:5d} N={N:6d} M={m}: {row['blocks']} blocks ({splits} K splits): "
              f"K1 {row['k1_graph_ms']:.4f} ms by graph ({row['k1_gbps']:.0f} GB/s; events "
              f"{row['k1_ms']:.4f}), plain {row['plain_ms']:.3f} ms, _int_mm (M={int_mm_m}) "
              f"{row['int_mm_graph_ms']:.4f}, bound {b_ms:.4f} ms ({b_by}); bit-exact", flush=True)
        del x, wp, w8, acc, p_acc, a8, wps, w8s, int_mm
    report[key] = rows
    return {"max_err": max_err, "rows": rows}


def device_nodes(torch, fn) -> tuple[dict, dict]:
    """What one call of ``fn`` runs on the device: the census of a CUDA
    graph that captures it (``build.graph_census``: its node kinds, and its
    kernel nodes by launch counter, read with ``cuGraphGetNodes`` from
    libcuda), and the kernel wrappers' launch counts during the capture.
    ``fn`` runs once before, so that workspaces and split-K counters exist
    outside the capture.  (``torch.profiler`` traces of one short call come
    back without their device events now and then on an H100; a captured
    graph holds every node.)"""
    from repro_torch.kernels import build

    fn()
    torch.cuda.synchronize()
    before = build.counts()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    launched = {k: v - before[k] for k, v in build.counts().items() if v != before[k]}
    census = build.graph_census(g)
    del g, census["families"]  # only_kernels describes kinds and counters
    return census, launched


def only_kernels(launched: dict) -> dict:
    """The census of a graph whose nodes are exactly the kernels ``launched``."""
    return {"kinds": {"kernel": sum(launched.values())}, "kernels": dict(launched)}


def check_graph(eng, per_step: dict, what: str, memset: bool = False) -> dict:
    """An engine's captured step against its launch counters: the launches
    its capture counted, and its graph's kernel nodes of the port's
    kernels, must both be ``per_step``; no memset node unless ``memset``
    (phase 8's plain integer path, which launches no port kernel)."""
    from repro_torch.kernels import build

    prog = eng._program
    check(prog.graph is not None, f"{what}: the engine's step was not captured")
    want = {k: v for k, v in per_step.items() if v}
    census = build.graph_census(prog.graph)
    ours = {k: v for k, v in census["kernels"].items() if k != "other"}
    check(prog.launches == want, f"{what}: the capture counted {prog.launches}, not {want}")
    check(ours == want, f"{what}: the graph's port kernel nodes {ours} != {want}")
    check(memset or "memset" not in census["kinds"], f"{what}: the graph holds memset nodes: {census}")
    return census


# -- phase 3 -------------------------------------------------------------------


# phase 3's long-context geometry: llama3.2-3b's KV width and page size at 32
# slots of 4096 tokens (its published context is 128k), every live slot
# 1024-4095 tokens long, a pool of S x n_blocks + 1 pages
LONG_GATHER = dict(S=32, max_len=4096, lengths=(1024, 4096), seed=2)


def _gather_geometry(torch, S, nb, ps, n_pages, seed, lengths=(17, 96)):
    import numpy as np

    rng = np.random.default_rng(seed)
    table = np.zeros((S, nb), np.int32)
    pos = np.zeros((S,), np.int32)
    free = list(range(1, n_pages))
    rng.shuffle(free)
    for s in range(S - 1):  # the last slot stays inactive: an all-null row
        length = int(rng.integers(*lengths))
        n_live = length // ps + 1
        table[s, :n_live] = [free.pop() for _ in range(n_live)]
        pos[s] = length
    return torch.from_numpy(table).cuda(), torch.from_numpy(pos).cuda(), int(np.count_nonzero(table))


def gather_operands(torch, S, nb, ps, D, n_pages, seed, lengths=(17, 96)):
    """Block table, positions, live page count, and bf16 and int8 K/V pools
    (levels and per-row scales of the same float values) for phase 3: the
    null page holds NaN garbage, which the views must read as zeros."""
    table, pos, n_live = _gather_geometry(torch, S, nb, ps, n_pages, seed, lengths)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    fp = torch.randn((2, n_pages, ps, D), generator=g, device="cuda")
    fp[:, 0] = float("nan")
    bf = fp.to(torch.bfloat16)
    sc = fp.abs().amax(-1, keepdim=True).nan_to_num(1.0) / 127 + 1e-12
    lv = torch.clamp(torch.round(fp.nan_to_num(0.0) / sc), -127, 127).to(torch.int8)
    del fp
    return table, pos, n_live, bf, lv, sc


def gather_bytes(S, nb, ps, D, n_live, chunk, elem, scaled) -> int:
    """K3's bytes: the live pages read (and their scales), the bf16 views and
    the mask written, the table and positions read."""
    return (2 * n_live * ps * D * elem + 2 * S * nb * ps * D * 2 + S * chunk * nb * ps
            + S * nb * 4 + S * 4 + (2 * n_live * ps * 4 if scaled else 0))


def phase_gather(torch, card, timer, cfg, ecfg, report: dict) -> dict:
    """K3 at the engine's geometry and at a long-context one.  At the
    engine's, each slot's position lies on its last live page, so the chunk's
    lanes cross a page boundary and run past the live pages onto null ones
    (as a chunked step's invalid lanes do).  A call at the long geometry
    reads and writes 0.7-0.9 GB, far past the 50 MB L2, so its graph
    timings need no cold copies; the engine geometry's operands fit in L2,
    as a step's do."""
    from repro_torch.kernels.paged_gather.kernel import paged_gather_plain, paged_gather_raw

    ps, D = ecfg.page_size, cfg.kv_heads * cfg.hd
    lg = LONG_GATHER
    geometries = [
        ("served", ecfg.n_slots, ecfg.blocks_per_slot, ecfg.pool_pages(), 1, (17, 96)),
        ("long", lg["S"], lg["max_len"] // ps, lg["S"] * (lg["max_len"] // ps) + 1, lg["seed"], lg["lengths"]),
    ]
    rows, max_err = [], 0.0
    for geometry, S, nb, P, seed, lengths in geometries:
        table, pos, n_live, bf, lv, sc = gather_operands(torch, S, nb, ps, D, P, seed, lengths)
        if geometry == "served":
            check(bool((pos[:-1] % ps + CHUNK > ps).all()), "K3 geometry: a chunk does not cross its page")
        print(f"  {geometry} geometry: {S} slots x {nb} blocks of {ps} rows, D {D}, {P} pool pages, "
              f"{n_live} live", flush=True)
        cases = [
            ("bf16 pool, full causal", (bf[0], bf[1]), (None, None), 0),
            ("bf16 pool, window 40", (bf[0], bf[1]), (None, None), 40),
            ("int8 pool -> bf16, full causal", (lv[0], lv[1]), (sc[0], sc[1]), 0),
            ("int8 pool -> bf16, window 40", (lv[0], lv[1]), (sc[0], sc[1]), 40),
        ]
        for (label, pools, scales, window), chunk in itertools.product(cases, (1, CHUNK)):
            args = (table, pos, window, *pools, *scales)
            kw = dict(chunk=chunk, out_dtype=torch.bfloat16)
            got = paged_gather_raw(*args, **kw)
            want = paged_gather_plain(*args, **kw)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                check(a.dtype == b.dtype and torch.equal(a, b),
                      f"K3 differs from its plain version: {geometry} geometry, {label}, chunk {chunk}")
                max_err = max(max_err, (a.float() - b.float()).abs().max().item())
            del got, want
            nbytes = gather_bytes(S, nb, ps, D, n_live, chunk, pools[0].element_size(), scales[0] is not None)
            b_ms, b_by, _, _ = card.bound(nbytes, 0)
            tl = table.long()
            row = dict(
                geometry=geometry, case=label, chunk=chunk, S=S, n_blocks=nb, page_size=ps, D=D,
                live_pages=n_live, per_step=cfg.n_layers,
                k3_ms=timer(lambda: paged_gather_raw(*args, **kw), reps=20),
                k3_graph_ms=timer.graph(lambda i: paged_gather_raw(*args, **kw)),
                plain_ms=timer(lambda: paged_gather_plain(*args, **kw), reps=10),
                library_ms=timer(lambda: (pools[0][tl], pools[1][tl]), reps=20),
                library_graph_ms=timer.graph(lambda i: (pools[0][tl], pools[1][tl])),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            )
            row["fraction_of_bound"] = b_ms / row["k3_graph_ms"]
            note = ""
            if scales[0] is not None:
                # the same function as K3 on an int8 pool: the gather, then the
                # dequantization in paged_gather_plain's op order
                def dequant(pools=pools, scales=scales, tl=tl):
                    return tuple(p[tl].to(torch.bfloat16) * s[tl].to(torch.bfloat16)
                                 for p, s in zip(pools, scales))

                row.update(dequant_ms=timer(dequant, reps=20),
                           dequant_graph_ms=timer.graph(lambda i: dequant()))
                note = (f", gather + dequantize {row['dequant_ms']:.4f} ms (graph "
                        f"{row['dequant_graph_ms']:.4f}; the same function)")
            rows.append(row)
            print(f"  {geometry}, {label}, chunk {chunk}: K3 {row['k3_ms']:.4f} ms (graph "
                  f"{row['k3_graph_ms']:.4f}, {100 * row['fraction_of_bound']:.0f} % of its bound), plain "
                  f"{row['plain_ms']:.4f} ms, pool[table] {row['library_ms']:.4f} ms (graph "
                  f"{row['library_graph_ms']:.4f}){note}, bound {b_ms:.4f} ms; bit-exact", flush=True)
        del table, pos, bf, lv, sc, cases, args, pools, scales
        torch.cuda.empty_cache()
    report["gather"] = rows
    return {"max_err": max_err, "rows": rows}


# -- phase 4 -------------------------------------------------------------------


def check_clean(eng, what: str) -> None:
    """An engine run without chaos struck nothing: no quarantine, no
    retried step, no hard recovery.  The engine never samples a non-finite
    row (it strikes the request and replays it), so a kernel that emits a
    NaN now and then shows here, not in the sampled rows."""
    n = (eng.scheduler.n_quarantines, eng.step_retries, eng.hard_recoveries)
    check(n == (0, 0, 0), f"{what}: a run without chaos struck requests ({n[0]} quarantines, {n[1]} step "
                          f"retries, {n[2]} hard recoveries; fault log {eng.fault_log})")


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
    check_clean(eng, "the served run")
    return metrics, build.counts(), wall


def graph_replay_ms(torch, eng, reps: int = 20) -> float:
    """Device time of one replay of an engine's captured step after its
    run (median of ``reps`` event pairs on the engine's stream): the step's
    device time with no host between its kernels.  The replays repeat the
    last step on pages the finished run no longer holds, and are not
    counted."""
    prog = eng._program
    pairs = []
    with torch.cuda.stream(prog.stream):
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            prog.graph.replay()
            e1.record()
            pairs.append((e0, e1))
    torch.cuda.synchronize()
    vals = sorted(a.elapsed_time(b) for a, b in pairs)
    return vals[len(vals) // 2]


def phase_engine(torch, cfg, ecfg, report: dict) -> dict:
    import numpy as np

    from repro_torch.kernels import build
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
    per_step = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": cfg.n_layers * 7 + 1,
                "paged_gather": cfg.n_layers}
    check(m["statuses"] == {"ok": len(prompts)}, f"engine statuses {m['statuses']}")
    check(all(len(r.out_tokens) == 32 for r in eng.finished), "a request ended short")
    check(counts == {k: v * steps for k, v in per_step.items()},
          f"launch counters {counts} != {per_step} x {steps} steps")
    census = check_graph(eng, per_step, "K1 path")
    replay_ms = graph_replay_ms(torch, eng)
    eng.close()
    step_ms = [1e3 * s for s in eng.step_seconds]
    run_a = dict(
        build_s=t_build, steps=steps, wall_s=wall, tokens=m["generated_tokens"],
        tokens_per_s=m["tokens_per_s"], step_ms_p50=float(np.median(step_ms)),
        step_ms_min=min(step_ms), counts=counts, per_step=per_step,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, fed_tokens=m["fed_tokens"],
        ttft_ms_p50=1e3 * m["ttft_p50"], graph=census, replay_ms=replay_ms,
    )
    print(f"  K1 path: {steps} steps, {m['generated_tokens']} tokens in {wall:.2f} s: "
          f"{m['tokens_per_s']:.1f} tok/s, step p50 {run_a['step_ms_p50']:.2f} ms "
          f"(min {run_a['step_ms_min']:.2f}), TTFT p50 {run_a['ttft_ms_p50']:.1f} ms; one replay "
          f"{replay_ms:.2f} ms of device time ({100 * replay_ms / run_a['step_ms_p50']:.1f} % of the step "
          f"p50); launches {counts}; "
          f"graph nodes {census}; build {t_build:.1f} s; peak memory {run_a['peak_mem_gb']:.1f} GB",
          flush=True)
    tokens_a = {r.rid: list(r.out_tokens) for r in eng.finished}
    samples, tokens_s = _sampled_run(torch, Engine(cfg, eng.params, ecfg, head=eng._head), prompts, 32)
    check(tokens_s == tokens_a, "the sampled (untimed) run gave other tokens than the timed run")
    gaps = {k: float(np.diff(np.partition(row, -2)[-2:])[0]) for k, row in samples.items()}
    run_a["top2_gap"] = dict(min=min(gaps.values()), p50=float(np.median(list(gaps.values()))))
    print(f"  sampled rows' top-2 logit gap: min {run_a['top2_gap']['min']:.4g}, p50 "
          f"{run_a['top2_gap']['p50']:.4g}; distinct tokens {len({t for v in tokens_a.values() for t in v})}",
          flush=True)
    report["profile"] = profile_engine(torch, Engine(cfg, eng.params, ecfg, head=eng._head), cfg,
                                       "C=1, captured")

    # the K-blocked path: the same packed words with block_k=512 (as a
    # deployment plan with an autotuned block_k sets); the head stays K1
    blocked = T.map_leaves(
        eng.params,
        lambda a: dataclasses.replace(a, block_k=512) if isinstance(a, PackedDenseParams) else a,
    )
    eng_b = Engine(cfg, blocked, ecfg, head=eng._head)
    max_new_b = 8
    m_b, counts_b, wall_b = _serve(torch, eng_b, prompts, max_new_b)
    per_step_b = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": 1,
                  "packed_matmul": cfg.n_layers * 7, "paged_gather": cfg.n_layers}
    check(m_b["statuses"] == {"ok": len(prompts)}, f"blocked engine statuses {m_b['statuses']}")
    check(counts_b == {k: v * m_b["steps"] for k, v in per_step_b.items()},
          f"blocked launch counters {counts_b} != {per_step_b} x {m_b['steps']} steps")
    census_b = check_graph(eng_b, per_step_b, "K2 path")
    eng_b.close()
    same = all(r.out_tokens == tokens_a[r.rid][:max_new_b] for r in eng_b.finished)
    check(same, "the K-blocked path gave other tokens than the fused path")
    step_ms_b = [1e3 * s for s in eng_b.step_seconds]
    run_b = dict(steps=m_b["steps"], wall_s=wall_b, tokens=m_b["generated_tokens"],
                 tokens_per_s=m_b["tokens_per_s"], step_ms_p50=float(np.median(step_ms_b)),
                 counts=counts_b, per_step=per_step_b, graph=census_b)
    print(f"  K2 path: {m_b['steps']} steps, {m_b['tokens_per_s']:.1f} tok/s, step p50 "
          f"{run_b['step_ms_p50']:.2f} ms; launches {counts_b}; graph nodes {census_b}; tokens equal "
          f"the K1 path's", flush=True)
    report["engine"] = {"fused": run_a, "blocked": run_b}
    c1 = dict(params=eng.params, head=eng._head, prompts=prompts, tokens=tokens_a, samples=samples,
              gaps=gaps)
    del eng, eng_b, blocked
    return {"fused": run_a, "blocked": run_b, "c1": c1}


def _sampled_run(torch, eng, prompts, max_new: int) -> tuple[dict, dict]:
    """Serve ``prompts`` on ``eng`` (untimed, deterministic clock) and keep
    every sampled logits row, keyed by (request id, index of the sampled
    token), and each request's tokens; then release the engine's graph.
    The timed runs set no hook."""
    rows = {}
    eng.on_sample = lambda rid, t, row: rows.__setitem__((rid, t), row.copy())
    for p in prompts:
        eng.submit(p, max_new)
    eng.run(realtime=False)
    check_clean(eng, "the sampled run")
    eng.close()
    torch.cuda.empty_cache()
    return rows, {r.rid: list(r.out_tokens) for r in eng.finished}


def profile_engine(torch, eng, cfg, label: str, n_requests: int = 8, max_new: int = 8,
                   prompt_len: int = 16) -> dict:
    """Trace a short run of an engine (``n_requests`` requests of
    ``prompt_len`` prompt and ``max_new`` new tokens; a fresh engine, or
    one whose earlier run has ended): device busy share and kernel time by
    name, in all and per step.  Its launches are not counted against any
    path; the engine is released after the run."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(2)
    steps0 = eng.n_steps
    for _ in range(n_requests):
        eng.submit(rng.integers(0, cfg.vocab, prompt_len).tolist(), max_new)
    eng.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        m = eng.run(realtime=True)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    check_clean(eng, f"the traced run ({label})")
    eng.close()
    torch.cuda.empty_cache()
    return trace_summary(prof, wall, m["steps"] - steps0, label)


def trace_summary(prof, wall: float, steps: int, label: str) -> dict:
    """A profiler run of ``steps`` engine steps in ``wall`` seconds: device
    busy share and kernel time by name and by group, in all and per step;
    the table goes to ``OUT_DIR``."""
    # device-side events only (kernels, copies, memsets): the CPU-side op rows
    # carry the device time of the kernels they launched a second time
    rows = [{"name": ev.key, "device_ms": ev.self_device_time_total / 1e3, "count": ev.count}
            for ev in prof.key_averages()
            if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    groups = {"K1/K2 packed_ring_kernel": "packed_ring_kernel", "K3 gather": "gather_",
              "memcpy": "Memcpy", "memset": "Memset"}
    by_group = {g: sum(r["device_ms"] for r in rows if key in r["name"]) for g, key in groups.items()}
    by_group["other kernels (PyTorch)"] = busy - sum(by_group.values())
    tag = label.replace(" ", "_").replace(",", "").replace("=", "")
    (OUT_DIR / f"profile_{tag}.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    print(f"  profile, {label}: {steps} steps in {wall * 1e3:.1f} ms (traced), device busy "
          f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f} %); per step: wall "
          f"{wall * 1e3 / steps:.2f} ms, device "
          + ", ".join(f"{g} {v / steps:.3f} ms" for g, v in by_group.items()), flush=True)
    for r in rows[:8]:
        print(f"    {r['device_ms']:9.3f} ms  x{r['count']:5d}  {r['name'][:90]}", flush=True)
    return {"label": label, "wall_ms": wall * 1e3, "steps": steps, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3), "by_group_ms": by_group,
            "per_step_ms": {g: v / steps for g, v in by_group.items()}, "top": rows[:25]}


# -- phase 5 -------------------------------------------------------------------


# phase 5's cross-check geometry: 8 slots of 4 pages each; its chunked
# step: an inactive slot, two decoding slots, three partial chunks and two
# full ones
CROSS_SLOTS, CROSS_BLOCKS = 8, 4
CROSS_CHUNK_LENS = (0, 1, 5, 16, 16, 1, 9, 0)


def _cross_steps(torch, cfg2, packed, head, steps: int, seed: int, gather: str, chunk_lens=None,
                 states: dict | None = None, *, pos0: int = 0, blocks: int = CROSS_BLOCKS,
                 cpu_cfg=None, per_layer: int = 7):
    """Run ``steps`` decode steps of the same packed weights on the card and
    on the CPU (8 slots of ``blocks`` pages, random tokens from ``seed``),
    then, given ``chunk_lens``, one chunked step of ``CHUNK`` lanes in which
    slot ``i`` feeds ``chunk_lens[i]`` of them.  The first step is at
    position ``pos0``; the float pools' rows before it hold the same random
    values on both sides (seeded).  ``cpu_cfg`` replaces ``cfg2`` on the
    CPU side (a planted fault); ``per_layer`` packed matmuls run a layer.
    Yields per step the card's and the CPU's logits (on the CPU); per
    slot, whether any activation level
    quantized by a packed matmul for a row it reads (a lane it feeds, or
    lane 0 of a slot that feeds none) differed between the two at this or
    an earlier step; that step's ``[S, C]`` rows read and, of them, those
    with a differing level in a layer; per slot whether the head's input
    row differed; and per packed matmul of the step, in call order
    (``per_layer`` a layer, then the head), its rows (``[S, C]``, the
    head's ``[S]``) with a differing level.  ``states``, when given, receives both sides'
    pools (``"cuda"``, ``"cpu"``), updated by every step."""
    import numpy as np

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cpu_packed = T.map_leaves(packed, lambda a: a.to("cpu"))
    cpu_head = head.to("cpu")
    S, ps, nb = CROSS_SLOTS, 16, blocks
    n_pages = S * nb + 1
    states = {} if states is None else states
    states.update({dev: T.init_paged_state(cfg2, S, n_pages, ps, dtype=torch.float32, device=dev)
                   for dev in ("cuda", "cpu")})
    if pos0:
        check(all(p.dtype == torch.float32 for p in states["cpu"].values()), "pos0 needs float pools")
        g = torch.Generator().manual_seed(seed)
        for name, pool in states["cpu"].items():
            pool.copy_(torch.randn(pool.shape, generator=g))
            states["cuda"][name].copy_(pool)
    table = torch.arange(1, n_pages, dtype=torch.int32).reshape(S, nb)
    rng = np.random.default_rng(seed)
    plan = [(1, None)] * steps + ([(CHUNK, chunk_lens)] if chunk_lens is not None else [])

    # record the activation levels every packed matmul quantizes, per row
    levels: list = []
    inner = L.packed_dense

    def recording(x, w, **kw):
        n = (1 << w.a_bits) - 1
        levels.append(torch.round(torch.clamp(x.float(), 0.0, 1.0) * n).to(torch.int16).cpu())
        return inner(x, w, **kw)

    flipped = torch.zeros(S, dtype=torch.bool)  # a level differed at this or an earlier step
    L.packed_dense = recording
    try:
        for t, (C, lens) in enumerate(plan):
            tokens = torch.from_numpy(rng.integers(0, cfg2.vocab, (S, C)).astype(np.int32))
            pos = torch.full((S,), pos0 + t, dtype=torch.int32)
            tlens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
            read = torch.ones((S, C), dtype=torch.bool)  # the rows each slot's logits depend on
            if lens is not None:
                read = torch.arange(C)[None] < torch.clamp(tlens, min=1)[:, None]
            levels.clear()
            g_log, _ = T.forward_decode_paged(
                packed, cfg2, states["cuda"], table.cuda(), tokens.cuda(), pos.cuda(), head=head,
                lens=None if tlens is None else tlens.cuda(), gather=gather)
            g_levels = list(levels)
            levels.clear()
            c_log, _ = T.forward_decode_paged(cpu_packed, cpu_cfg or cfg2, states["cpu"], table, tokens,
                                              pos, head=cpu_head, lens=tlens, gather=gather)
            check(len(levels) == len(g_levels) == per_layer * cfg2.n_layers + 1, "packed matmul count")
            calls = [(g != c).any(dim=1).reshape(S, C) & read for g, c in zip(g_levels[:-1], levels[:-1])]
            head_flip = (g_levels[-1] != levels[-1]).any(dim=1)  # the head: a row per slot
            row_flip = torch.stack(calls).any(dim=0)  # the layers: S x C rows
            flipped |= row_flip.any(dim=1) | head_flip
            g_log = g_log.cpu()
            check(bool(torch.isfinite(g_log).all()), f"non-finite logits at cross-check step {t}")
            yield g_log, c_log, flipped.clone(), read, row_flip, head_flip, calls + [head_flip]
    finally:
        L.packed_dense = inner


def _kv_level_flips(torch, states: dict) -> dict:
    """The card's int8 KV pools against the CPU's after a cross-check step
    (:func:`_cross_steps`' geometry: slot ``s`` owns pages ``1 + s *
    CROSS_BLOCKS`` on), on the live pages: levels that differ by one (a
    K/V value on a rounding boundary of ``quantize_kv_row``, or one that an
    activation-level flip upstream moved a little), levels that differ by
    more (rows whose inputs an earlier flip moved), and per slot whether
    any of its levels differ."""
    slots = torch.zeros(CROSS_SLOTS, dtype=torch.bool)
    by_one = more = 0
    for name in ("k", "v"):
        d = (states["cuda"][name][:, 1:].cpu().to(torch.int16) - states["cpu"][name][:, 1:].to(torch.int16)).abs()
        by_one += int((d == 1).sum())
        more += int((d > 1).sum())
        slots |= (d != 0).any(dim=3).any(dim=2).any(dim=0).reshape(CROSS_SLOTS, CROSS_BLOCKS).any(dim=1)
    return dict(kv_levels_off_by_one=by_one, kv_levels_off_more=more, kv_slots=slots)


def _row_stats(torch, g_log, c_log, flipped) -> dict:
    diff = (g_log - c_log).abs()
    row_max = diff.max(dim=1).values
    row_rel = torch.linalg.vector_norm(g_log - c_log, dim=1) / torch.linalg.vector_norm(c_log, dim=1)
    clean = ~flipped
    top2 = torch.topk(c_log, 2, dim=1).values
    agree = torch.argmax(g_log, 1) == torch.argmax(c_log, 1)
    decided = (top2[:, 0] - top2[:, 1]) > 2 * row_max
    return dict(row_max=row_max, row_rel=row_rel, clean=clean, agree=agree, decided=decided,
                summary=dict(
                    clean_rows=int(clean.sum()),
                    clean_max_abs=float(row_max[clean].max()) if clean.any() else None,
                    flipped_max_rel=float(row_rel[flipped].max()) if flipped.any() else None,
                    max_rel=float(row_rel.max()),
                    tokens_agree=int(agree.sum()), tokens_decided=int(decided.sum())))


def _first_hand(prior, read, row_flip, head_flip) -> tuple[int, int, int]:
    """(first-hand rows, rows with a first-hand flip, slots whose flipped
    rows are exactly those from their first flip on) of one step.  A row
    is first-hand when nothing it reads had a flip: its slot had none at an
    earlier step (or the K/V rows it attends to differ) and no earlier lane
    of this step had one (its K/V rows reach every later lane from the next
    layer on).  Per such slot: its rows read, in lane order, up to and
    including its first flipped one; a head flip counts at its last row."""
    rows = fresh = suffix = 0
    for s in range(len(prior)):
        n = int(read[s].sum())
        lanes = row_flip[s, :n].clone()
        lanes[n - 1] |= head_flip[s]
        hit = lanes.nonzero()
        suffix += bool(len(hit)) and bool(lanes[int(hit[0]):].all())
        if prior[s]:
            continue
        rows += int(hit[0]) + 1 if len(hit) else n
        fresh += bool(len(hit))
    return rows, fresh, suffix


def phase_crosscheck(torch, cfg, steps: int = 3, *, kv_int8: bool = False, gather: str = "kernel",
                     pos0: int = 0, blocks: int = CROSS_BLOCKS, chunk_step: bool = True,
                     packed_mlp: bool = True, cpu_window_pattern: tuple | None = None) -> list:
    """``steps`` decode steps, then (``chunk_step``) one chunked step of
    ``CHUNK`` lanes.  Flips must stay rare: at the decode steps at least half the slots
    without one at this or an earlier step; at the chunked step, where a
    slot's lanes attend to each other and to the rows of its earlier steps
    so that one flip moves every later row of the slot, at least half the
    first-hand rows (:func:`_first_hand`) without one.  ``kv_int8`` runs
    the same weights on int8 KV pools (phase 12) and counts the KV levels
    that differ between the two sides (:func:`_kv_level_flips`) beside the
    activation-level flips; the rules stay phase 5's.  ``pos0`` and
    ``blocks`` place the steps in longer pools (phase 14 (d): past a
    window), ``packed_mlp=False`` keeps the MLP projections float (packed:
    the attention projections and the head), and ``cpu_window_pattern``
    plants a fault: the CPU side with that window pattern."""
    from repro_torch.kernels import build
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving.api import quantize_params_packed

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32,
                               kv_dtype="int8" if kv_int8 else cfg.kv_dtype)
    params = T.init_params(cfg2, seed=1, device="cuda")
    head = L.prepack_lm_head(params["embed"], w_bits=4, a_bits=4, device="cuda")
    packed = quantize_params_packed(params, w_bits=4, a_bits=4, device="cuda")
    if not packed_mlp:
        packed["layers"]["mlp"] = params["layers"]["mlp"]
    del params
    S = CROSS_SLOTS
    results = []
    prior = torch.zeros(S, dtype=torch.bool)
    states: dict = {}
    k3_before = build.counts()["paged_gather"]
    cpu_cfg = (None if cpu_window_pattern is None
               else dataclasses.replace(cfg2, window_pattern=cpu_window_pattern))
    chunk_lens = CROSS_CHUNK_LENS if chunk_step else None
    for t, (g_log, c_log, flipped, read, row_flip, head_flip, _) in enumerate(_cross_steps(
            torch, cfg2, packed, head, steps, seed=5, gather=gather,
            chunk_lens=chunk_lens, states=states, pos0=pos0, blocks=blocks,
            cpu_cfg=cpu_cfg, per_layer=7 if packed_mlp else 4)):
        chunked = t == steps
        st = _row_stats(torch, g_log, c_log, flipped)
        first_hand, fresh, suffix = _first_hand(prior, read, row_flip, head_flip)
        r = dict(step=t, chunk=CHUNK if chunked else 1, rows_read=read.sum(dim=1).tolist(),
                 rows_flipped=row_flip.sum(dim=1).tolist(),
                 flipped_lanes=[row_flip[s].nonzero().flatten().tolist() for s in range(S)],
                 first_hand_rows=first_hand, first_hand_flips=fresh, suffix_slots=suffix,
                 **st["summary"])
        kv_note = ""
        if kv_int8:
            kv = _kv_level_flips(torch, states)
            kv_slots = kv.pop("kv_slots")
            r.update(kv, kv_slots=int(kv_slots.sum()), kv_only_slots=int((kv_slots & ~flipped).sum()))
            kv_note = (f"; KV levels off by one {kv['kv_levels_off_by_one']}, by more "
                       f"{kv['kv_levels_off_more']}, in {r['kv_slots']}/{S} slots ({r['kv_only_slots']} of "
                       f"them without an activation-level flip)")
        results.append(r)
        prior = flipped
        what = f"chunked step (lens {list(CROSS_CHUNK_LENS)})" if chunked else f"step {t}"
        what += f" at position {pos0 + t}" if pos0 else ""
        print(f"  {what}: {r['clean_rows']}/{S} slots with identical activation levels, their "
              f"max|d| {r['clean_max_abs']}; slots with a level flip: max rel L2 "
              f"{r['flipped_max_rel']}; rows with a flip / rows read this step, by slot "
              f"{list(zip(r['rows_flipped'], r['rows_read']))}, flipped lanes {r['flipped_lanes']}; "
              f"{fresh} of {first_hand} first-hand rows flipped, {suffix} slots flipped from their "
              f"first flip on; greedy tokens agree {r['tokens_agree']}/{S}{kv_note}", flush=True)
        clean = st["clean"]
        check(bool((st["row_max"][clean] <= CROSS_CLEAN_ABS_TOL).all()),
              f"cross-check {what}: a row without level flips differs by more than "
              f"{CROSS_CLEAN_ABS_TOL}")
        check(bool((st["row_rel"][flipped] <= CROSS_FLIP_REL_TOL).all()),
              f"cross-check {what}: a row with level flips differs by more than "
              f"{CROSS_FLIP_REL_TOL} relative")
        check(bool((st["agree"] | ~st["decided"] | flipped).all()),
              f"cross-check {what}: greedy token differs past the gap bound")
        if not chunked:
            check(int(clean.sum()) >= S // 2, f"cross-check {what}: level flips in most rows")
        else:
            check(2 * fresh <= first_hand, f"cross-check {what}: level flips in most first-hand rows")
    n_steps = steps + (chunk_lens is not None)
    check(len(results) == n_steps, "a cross-check step did not run")
    k3 = build.counts()["paged_gather"] - k3_before
    want = cfg2.n_layers * n_steps if gather == "kernel" else 0
    check(k3 == want, f"cross-check ({gather} gather): {k3} K3 launches on the card, not {want}")
    return results


# -- phase 6 -------------------------------------------------------------------

INT8_PAIRS = ((2, 2), (2, 3))  # the only pairs with an int8-lane placement


def _int_mm(torch, a, w):
    """``torch._int_mm`` of ``a`` by a weight like ``w``, as a timed
    yardstick; it refuses M <= 16, so such an ``a`` is padded with zero rows
    to M = 32.  Returns (call taking the weight, M used)."""
    try:
        torch._int_mm(a, w)
        return (lambda wt: torch._int_mm(a, wt)), a.shape[0]
    except RuntimeError:
        a32 = torch.zeros((32, a.shape[1]), dtype=a.dtype, device=a.device)
        a32[: a.shape[0]] = a
        torch._int_mm(a32, w)
        return (lambda wt: torch._int_mm(a32, wt)), 32


def phase_int8(torch, card, timer, cfg, M: int, report: dict) -> dict:
    import math

    from repro_torch.core.quant import weight_to_int_levels
    from repro_torch.kernels import build
    from repro_torch.kernels.packed_matmul import ref as pm
    from repro_torch.kernels.packed_matmul.kernel import grid_plan
    from repro_torch.kernels.quant_matmul import ref as qm
    from repro_torch.kernels.quant_matmul.kernel import (
        K4_PLAN, k4_bm, quant_matmul_plain, quant_matmul_raw, quant_packed_matmul_plain,
        quant_packed_matmul_raw,
    )
    from repro_torch.kernels.quant_matmul.ops import choose_mxu_config, quant_dense, quant_packed_dense

    d = cfg.d_model
    shapes = [(name, K, N, M, per_step) for name, (K, N, per_step) in decode_matmul_shapes(cfg).items()]
    shapes.append(("wq|wo, M=128", d, cfg.n_heads * cfg.hd, 128, 0))
    cfgs = {pair: choose_mxu_config(*pair) for pair in INT8_PAIRS}
    check(cfgs[(2, 2)] == (2, 5, 7, 1) and cfgs[(2, 3)] == (2, 5, 3, 1) and choose_mxu_config(4, 4) is None,
          f"unexpected int8-lane placements {cfgs}")
    g = torch.Generator(device="cuda")
    g.manual_seed(6)

    # the slice's main path: the public entry points from float inputs, on the
    # card; w4a4 has no int8-lane placement and takes the plain integer path
    floats = {}
    torch.cuda.synchronize()
    build.reset_counts()
    for name, K, N, m, _ in shapes:
        x = torch.rand((m, K), generator=g, device="cuda") * 1.2 - 0.1
        w = torch.randn((K, N), generator=g, device="cuda") / math.sqrt(K)
        outs = [quant_dense(x, w)] + [quant_packed_dense(x, w, w_bits=wb, a_bits=ab)
                                      for wb, ab in INT8_PAIRS + ((4, 4),)]
        for o in outs:
            check(o.shape == (m, N) and bool(torch.isfinite(o).all()),
                  f"int8-lane entry point gave a bad result at {name}")
        if name in ("wq|wo", "w_down"):
            floats[name] = (x, w, outs)
        del x, w, outs
    torch.cuda.synchronize()
    counts = build.counts()
    want = {**dict.fromkeys(build.COUNTS, 0), "quant_matmul": len(shapes),
            "quant_packed_matmul": len(INT8_PAIRS) * len(shapes)}
    check(counts == want, f"int8-lane launch counters {counts} != {want}")
    print(f"  main path: quant_dense and quant_packed_dense (w2a2, w2a3, w4a4) at {len(shapes)} "
          f"shapes; launches {counts}", flush=True)

    # the same layers on the CPU: bit-exact wherever the levels agree
    cross = []
    for name, (x, w, outs) in floats.items():
        xc, wc = x.cpu(), w.cpu()
        same_w8 = bool(torch.equal(qm.quantize_symmetric(w)[0].cpu(), qm.quantize_symmetric(wc)[0]))
        want_q = quant_dense(xc, wc)
        rel = float(torch.linalg.vector_norm(outs[0].cpu() - want_q) / torch.linalg.vector_norm(want_q))
        check(rel < 5e-3 and (not same_w8 or torch.equal(outs[0].cpu(), want_q)),
              f"quant_dense on the card differs from the CPU at {name}: rel {rel}")
        row = dict(shape=name, quant_dense_bit_exact=bool(torch.equal(outs[0].cpu(), want_q)),
                   quant_dense_rel_l2=rel)
        for (wb, ab), o in zip(INT8_PAIRS + ((4, 4),), outs[1:]):
            # columns whose weight levels came out the same on both sides (tanh rounds differently)
            clean = (weight_to_int_levels(w, wb)[0].cpu() == weight_to_int_levels(wc, wb)[0]).all(dim=0)
            want_p = quant_packed_dense(xc, wc, w_bits=wb, a_bits=ab)
            check(int(clean.sum()) >= clean.numel() - 16 and torch.equal(o.cpu()[:, clean], want_p[:, clean]),
                  f"quant_packed_dense w{wb}a{ab} on the card differs from the CPU at {name}")
            row[f"w{wb}a{ab}_level_flip_columns"] = int((~clean).sum())
        cross.append(row)
        print(f"  card vs CPU at {name}: {row}", flush=True)
        del xc, wc
    del floats

    # K4 and K5 against their plain versions on identical integer operands
    rows, max4, max5 = [], 0.0, 0.0
    for name, K, N, m, per_step in shapes:
        a8 = torch.randint(-127, 128, (m, K), generator=g, device="cuda", dtype=torch.int8)
        w8 = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
        sc = torch.rand((1, N), generator=g, device="cuda") * 1e-4
        out, p_out = quant_matmul_raw(a8, w8, sc), quant_matmul_plain(a8, w8, sc)
        torch.cuda.synchronize()
        err = (out - p_out).abs().max().item()
        check(torch.equal(out, p_out), f"K4 differs from its plain version at {name}: max {err}")
        max4 = max(max4, err)
        nodes = device_nodes(torch, lambda: quant_matmul_raw(a8, w8, sc))
        check(nodes == (only_kernels({"quant_matmul": 1}), {"quant_matmul": 1}),
              f"K4 at {name} ran other device work than its kernel: {nodes}")
        lib, lib_m = _int_mm(torch, a8, w8)
        w8s = cold_copies(w8)
        nbytes = m * K + K * N + 4 * N + 4 * m * N
        b_ms, b_by, t_b, t_o = card.bound(nbytes, 2 * m * K * N, INT8_OPS_PER_S)
        bm = k4_bm(m)
        row = dict(kernel="quant_matmul", shape=name, K=K, N=N, M=m, per_step=per_step,
                   ms=timer.graph(lambda i: quant_matmul_raw(a8, w8s[i % len(w8s)], sc)),
                   events_ms=timer(lambda: quant_matmul_raw(a8, w8, sc), reps=20),
                   plain_ms=timer(lambda: quant_matmul_plain(a8, w8, sc), reps=3),
                   library_ms=timer.graph(lambda i: lib(w8s[i % len(w8s)]).to(torch.float32) * sc),
                   library_m=lib_m, bound_ms=b_ms, bound_by=b_by, t_bytes=t_b, t_ops=t_o, bytes=nbytes,
                   bm=bm, plan=grid_plan(m, K, N, card.sms, bm=bm, **K4_PLAN))
        row["gbps"] = nbytes / row["ms"] / 1e6
        rows.append(row)
        print(f"  K4 {name:13s} M={m:3d} K={K:5d} N={N:6d}: {row['ms']:.4f} ms ({row['gbps']:.0f} GB/s; "
              f"events {row['events_ms']:.4f}; row tile {bm}, (splits, k_per_split) {row['plan']}), plain "
              f"{row['plain_ms']:.3f} ms, _int_mm (M={lib_m}) {row['library_ms']:.4f} ms, bound {b_ms:.4f} "
              f"ms ({b_by}); bit-exact, one kernel node", flush=True)
        del a8, w8, w8s, out, p_out, lib
        for pair, c in cfgs.items():
            a_lvl = torch.randint(0, 1 << pair[1], (m, K), generator=g, device="cuda", dtype=torch.int8)
            w_lvl = torch.randint(0, 1 << pair[0], (K, N), generator=g, device="cuda", dtype=torch.int32)
            wp = pm.pack_weights(w_lvl, c.n_seg, c.stride).to(torch.int8)
            del w_lvl
            kw = dict(n_seg=c.n_seg, stride=c.stride, acc_chunk=c.acc_chunk, overlap=c.overlap)
            acc, p_acc = quant_packed_matmul_raw(a_lvl, wp, **kw), quant_packed_matmul_plain(a_lvl, wp, **kw)
            torch.cuda.synchronize()
            err = (acc - p_acc).abs().max().item()
            check(torch.equal(acc, p_acc), f"K5 differs from its plain version at {name} w{pair[0]}a{pair[1]}")
            max5 = max(max5, err)
            nodes = device_nodes(torch, lambda: quant_packed_matmul_raw(a_lvl, wp, **kw))
            check(nodes == (only_kernels({"quant_packed_matmul": 1}), {"quant_packed_matmul": 1}),
                  f"K5 at {name} w{pair[0]}a{pair[1]} ran other device work than its kernel: {nodes}")
            lib, lib_m = _int_mm(torch, a_lvl, wp)
            wps = cold_copies(wp)
            np_ = wp.shape[1]
            nbytes = m * K + K * np_ + 4 * m * N
            b_ms, b_by, t_b, t_o = card.bound(nbytes, 2 * m * K * np_ * (2 if c.overlap else 1), INT8_OPS_PER_S)
            row = dict(kernel="quant_packed_matmul", shape=name, pair=f"w{pair[0]}a{pair[1]}", K=K, N=N,
                       M=m, per_step=per_step,
                       ms=timer.graph(lambda i: quant_packed_matmul_raw(a_lvl, wps[i % len(wps)], **kw)),
                       events_ms=timer(lambda: quant_packed_matmul_raw(a_lvl, wp, **kw), reps=20),
                       plain_ms=timer(lambda: quant_packed_matmul_plain(a_lvl, wp, **kw), reps=1, warmup=0),
                       library_ms=timer.graph(lambda i: lib(wps[i % len(wps)])), library_m=lib_m,
                       bound_ms=b_ms, bound_by=b_by, t_bytes=t_b, t_ops=t_o, bytes=nbytes)
            row["gbps"] = nbytes / row["ms"] / 1e6
            rows.append(row)
            print(f"  K5 {name:13s} M={m:3d} K={K:5d} N={N:6d} {row['pair']}: {row['ms']:.4f} ms "
                  f"({row['gbps']:.0f} GB/s; events {row['events_ms']:.4f}), plain {row['plain_ms']:.3f} ms, "
                  f"_int_mm on the packed words (M={lib_m}) {row['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}); bit-exact, one kernel node", flush=True)
            del a_lvl, wp, wps, acc, p_acc, lib
    streams = two_stream_splits(torch, card, cfg, M)
    report["int8"] = {"main_path_counts": counts, "cpu_cross": cross, "rows": rows, "two_streams": streams}
    return {"counts": counts, "rows": rows, "max_err": {"quant_matmul": max4, "quant_packed_matmul": max5}}


def two_stream_splits(torch, card, cfg, M: int, rounds: int = 20) -> dict:
    """K1 (wk|wv, w4a4), K5 (wq|wo, w2a2) and K4 (wq|wo) at shapes that
    split K, launched in turns on two streams for ``rounds`` rounds with no
    synchronisation between the streams; every output must equal its plain
    version.  Each stream takes its own slot of the split-K arrival
    counters (``packed_matmul.kernel._split_scratch``)."""
    from repro_torch.kernels.packed_matmul import ref as pm
    from repro_torch.kernels.packed_matmul.kernel import (
        grid_plan, packed_dense_fused_plain, packed_dense_fused_raw,
    )
    from repro_torch.kernels.packed_matmul.ops import choose_config
    from repro_torch.kernels.quant_matmul.kernel import (
        K4_PLAN, K5_PLAN, k4_bm, quant_matmul_plain, quant_matmul_raw, quant_packed_matmul_plain,
        quant_packed_matmul_raw,
    )
    from repro_torch.kernels.quant_matmul.ops import choose_mxu_config

    d, kv, q = cfg.d_model, cfg.kv_heads * cfg.hd, cfg.n_heads * cfg.hd
    c1, c5 = choose_config(4, 4), choose_mxu_config(2, 2)
    kw1 = dict(a_bits=4, n_seg=c1.n_seg, stride=c1.stride, acc_chunk=c1.acc_chunk, overlap=c1.overlap)
    kw5 = dict(n_seg=c5.n_seg, stride=c5.stride, acc_chunk=c5.acc_chunk, overlap=c5.overlap)
    splits = {"K1": grid_plan(M, d, kv // c1.n_seg, card.sms)[0],
              "K5": grid_plan(M, d, q // c5.n_seg, card.sms, **K5_PLAN)[0],
              "K4": grid_plan(M, d, q, card.sms, bm=k4_bm(M), **K4_PLAN)[0]}
    check(min(splits.values()) > 1, f"two-stream check: a shape does not split K: {splits}")
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    ops, fns = [], []
    for _ in range(2):
        x = torch.rand((M, d), generator=g, device="cuda") * 1.2 - 0.1
        wp1 = pm.pack_weights(torch.randint(0, 16, (d, kv), generator=g, device="cuda", dtype=torch.int32),
                              c1.n_seg, c1.stride)
        a5 = torch.randint(0, 4, (M, d), generator=g, device="cuda", dtype=torch.int8)
        wp5 = pm.pack_weights(torch.randint(0, 4, (d, q), generator=g, device="cuda", dtype=torch.int32),
                              c5.n_seg, c5.stride).to(torch.int8)
        a4 = torch.randint(-128, 128, (M, d), generator=g, device="cuda", dtype=torch.int8)
        w4 = torch.randint(-128, 128, (d, q), generator=g, device="cuda", dtype=torch.int8)
        s4 = torch.rand((1, q), generator=g, device="cuda") * 1e-4
        ops.append((x, wp1, a5, wp5, a4, w4, s4))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(rounds):
        for i, st in enumerate(streams):
            x, wp1, a5, wp5, a4, w4, s4 = ops[i]
            with torch.cuda.stream(st):
                outs[i].append((packed_dense_fused_raw(x, wp1, **kw1), quant_packed_matmul_raw(a5, wp5, **kw5),
                                quant_matmul_raw(a4, w4, s4)))
    torch.cuda.synchronize()
    for i in range(2):
        x, wp1, a5, wp5, a4, w4, s4 = ops[i]
        want1, want5, want4 = (packed_dense_fused_plain(x, wp1, **kw1), quant_packed_matmul_plain(a5, wp5, **kw5),
                               quant_matmul_plain(a4, w4, s4))
        for r, ((acc1, sum1), acc5, out4) in enumerate(outs[i]):
            check(torch.equal(acc1, want1[0]) and torch.equal(sum1, want1[1]),
                  f"two-stream check: K1 on stream {i}, round {r}, differs from its plain version")
            check(torch.equal(acc5, want5), f"two-stream check: K5 on stream {i}, round {r}, differs")
            check(torch.equal(out4, want4), f"two-stream check: K4 on stream {i}, round {r}, differs")
    print(f"  two streams: K1 wk|wv, K5 wq|wo w2a2, K4 wq|wo (K splits {splits}) x {rounds} rounds each, "
          f"in turns with no synchronisation: every output equals its plain version", flush=True)
    return {"rounds": rounds, "splits": splits}


# -- phase 7 -------------------------------------------------------------------

# UltraNet's five 3x3 layers at in_hw = (160, 320), each as row convolutions
# (B = H rows, C = C_in, N = W), and the Filter-Packing pairs run at each
ULTRANET_ROWS = ((160, 3, 320), (80, 16, 160), (40, 32, 80), (20, 64, 40), (10, 64, 20))
FILTER_PAIRS = ((2, 2), (3, 4), (4, 4))


def phase_filter(torch, card, timer, report: dict) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.filter_conv import ref as fc
    from repro_torch.kernels.filter_conv.kernel import filter_conv_plain, filter_conv_raw, tile_plan
    from repro_torch.kernels.filter_conv.ops import choose_filter_config, packed_conv1d

    cases = [(shape, pair, 3) for shape in ULTRANET_ROWS for pair in FILTER_PAIRS]
    cases.append((ULTRANET_ROWS[2], (2, 2), 7))
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    operands = []
    for (B, C, N), (wb, ab), k in cases:
        s = torch.randint(0, 1 << ab, (B, C, N), generator=g, device="cuda", dtype=torch.int32)
        f = torch.randint(0, 1 << wb, (C, k), generator=g, device="cuda", dtype=torch.int32)
        operands.append((s, f))

    # the main path: the public entry point
    torch.cuda.synchronize()
    build.reset_counts()
    outs = [packed_conv1d(s, f, w_bits=wb, a_bits=ab) for (s, f), (_, (wb, ab), _) in zip(operands, cases)]
    torch.cuda.synchronize()
    counts = build.counts()
    want = {**dict.fromkeys(build.COUNTS, 0), "filter_conv": len(cases)}
    check(counts == want, f"filter-conv launch counters {counts} != {want}")
    print(f"  main path: packed_conv1d at {len(cases)} (shape, pair, K) cases; launches {counts}",
          flush=True)

    rows, max_err = [], 0.0
    for ((B, C, N), (wb, ab), k), (s, f), out in zip(cases, operands, outs):
        c = choose_filter_config(wb, ab, k)
        truth = fc.conv_full_levels(f, s)
        n_pad = -(-N // c.n_p) * c.n_p
        sp = F.pad(s, (0, n_pad - N)).contiguous()
        fp = fc.pack_filter(f, c.k_p, c.stride)
        kw = dict(k_p=c.k_p, n_p=c.n_p, stride=c.stride, acc_chunk=c.acc_chunk, k_len=k, n_len=N,
                  overlap=c.overlap)
        raw, plain = filter_conv_raw(sp, fp, **kw), filter_conv_plain(sp, fp, **kw)
        torch.cuda.synchronize()
        err = max((raw - plain).abs().max().item(), (out - truth).abs().max().item())
        label = f"B={B} C={C} N={N} K={k} w{wb}a{ab} {tuple(c)}"
        check(torch.equal(raw, plain) and torch.equal(raw, truth) and torch.equal(out, truth),
              f"K6 differs from its plain version or the convolution at {label}: max {err}")
        max_err = max(max_err, err)
        nodes = device_nodes(torch, lambda: filter_conv_raw(sp, fp, **kw))
        check(nodes == (only_kernels({"filter_conv": 1}), {"filter_conv": 1}),
              f"K6 at {label} ran other device work than its kernel: {nodes}")
        s32, f32 = s.to(torch.float32), torch.flip(f, (1,)).to(torch.float32)[None]
        check(torch.equal(F.conv1d(s32, f32, padding=k - 1)[:, 0], truth.to(torch.float32)),
              "float32 conv1d yardstick is not exact")
        n_fc = fp.shape[1]
        nbytes = 4 * (B * C * n_pad + C * n_fc + B * (N + k - 1))
        ops = B * (n_pad // c.n_p) * n_fc * C * (2 if c.overlap else 1)
        b_ms, b_by, t_b, t_o = card.bound(nbytes, ops)
        row = dict(kernel="filter_conv", B=B, C=C, N=N, K=k, pair=f"w{wb}a{ab}", config=tuple(c),
                   ms=timer.graph(lambda i: filter_conv_raw(sp, fp, **kw)),
                   events_ms=timer(lambda: filter_conv_raw(sp, fp, **kw), reps=20),
                   plain_ms=timer(lambda: filter_conv_plain(sp, fp, **kw), reps=3),
                   library_ms=timer.graph(lambda i: F.conv1d(s32, f32, padding=k - 1)),
                   bound_ms=b_ms, bound_by=b_by, t_bytes=t_b, t_ops=t_o, bytes=nbytes, int32_ops=ops,
                   plan=tuple(tile_plan(B, C, N + k - 1, c.k_p, c.n_p, n_fc, c.acc_chunk, card.sms)))
        row["gbps"] = nbytes / row["ms"] / 1e6
        rows.append(row)
        print(f"  K6 {label}: {1e3 * row['ms']:.2f} us (graph; events {1e3 * row['events_ms']:.1f} us; "
              f"plan {row['plan']}), plain {row['plain_ms']:.3f} ms, f32 conv1d "
              f"{1e3 * row['library_ms']:.2f} us, bound {1e3 * b_ms:.3f} us ({b_by}); bit-exact, one "
              f"kernel node", flush=True)
    report["filter"] = {"main_path_counts": counts, "rows": rows}
    return {"counts": counts, "rows": rows, "max_err": max_err}


# -- phase 8 -------------------------------------------------------------------

# phase 8 tolerance.  The default bits (w4a8, head (8, 8)) have no packing
# placement: every projection and the head run the plain integer matmul
# (float64 on the card, int32-exact), so a slot's logits differ from the
# CPU's only where float32 sum order (attention, norms) moved an activation
# across one of its 255 rounding boundaries.  A slot with no such flip must
# agree to CROSS_CLEAN_ABS_TOL per logit; a flipped 8-bit level moves one
# product by 1/255 of an activation, so a slot with flips must stay within
# DEFAULT_FLIP_REL_TOL relative L2.  Flips are common at 255 levels and are
# counted, not bounded.
DEFAULT_FLIP_REL_TOL = 1e-2


def phase_default_engine(torch, cfg, report: dict, steps: int = 3) -> dict:
    import numpy as np

    from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, build_engine

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    ecfg = EngineConfig(packed_head=True)
    check(ecfg.head_bits == (8, 8), f"default head bits {ecfg.head_bits}")
    eng = build_engine(cfg2, ecfg, quant="packed", seed=0)  # the default w4a8
    leaves = []
    T.map_leaves(eng.params, leaves.append)
    packed = [a for a in leaves if isinstance(a, PackedDenseParams)]
    check(len(packed) == 7 * cfg2.n_layers and all(p.cfg is None and (p.w_bits, p.a_bits) == (4, 8)
                                                    for p in packed) and eng._head.cfg is None,
          "the default bits should pack nothing and take the plain integer path")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg2.vocab, int(rng.integers(16, 65))).tolist() for _ in range(8)]
    m, counts, wall = _serve(torch, eng, prompts, 8)
    check(m["statuses"] == {"ok": len(prompts)}, f"default-bits engine statuses {m['statuses']}")
    check(counts == dict.fromkeys(counts, 0), f"the plain integer path launched kernels: {counts}")
    census = check_graph(eng, {}, "default-bits engine", memset=True)
    eng.close()
    run = dict(steps=m["steps"], wall_s=wall, tokens=m["generated_tokens"],
               tokens_per_s=m["tokens_per_s"], step_ms_p50=float(np.median(eng.step_seconds)) * 1e3,
               graph=census)
    print(f"  engine: 2 layers at full width, w4a8, (8, 8) head: {m['steps']} steps, all "
          f"{len(prompts)} requests ok, {m['tokens_per_s']:.1f} tok/s, step p50 "
          f"{run['step_ms_p50']:.2f} ms; captured graph nodes {census}", flush=True)
    results = []
    for t, (g_log, c_log, flipped, *_) in enumerate(
            _cross_steps(torch, cfg2, eng.params, eng._head, steps,
                         seed=9, gather=ecfg.gather_backend)):
        st = _row_stats(torch, g_log, c_log, flipped)
        r = dict(step=t, **st["summary"])
        results.append(r)
        print(f"  cross-check step {t}: {r['clean_rows']}/8 rows without a level flip (max|d| "
              f"{r['clean_max_abs']}), max rel L2 {r['max_rel']:.3g}; greedy tokens agree "
              f"{r['tokens_agree']}/8", flush=True)
        check(bool((st["row_max"][st["clean"]] <= CROSS_CLEAN_ABS_TOL).all()),
              f"default-bits cross-check step {t}: a row without level flips differs by more than "
              f"{CROSS_CLEAN_ABS_TOL}")
        check(bool((st["row_rel"] <= DEFAULT_FLIP_REL_TOL).all()),
              f"default-bits cross-check step {t}: a row differs by more than {DEFAULT_FLIP_REL_TOL} "
              f"relative")
        check(bool((st["agree"] | ~st["decided"] | flipped).all()),
              f"default-bits cross-check step {t}: greedy token differs past the gap bound")
    report["default_engine"] = {"run": run, "counts": counts, "crosscheck": results}
    del eng
    return run


# -- phase 9 -------------------------------------------------------------------

# phase 9 tolerances.  The chunked runs serve phase 4's weights and prompts
# in bf16, so a sampled row may differ from phase 4's at the same (request,
# token) by the sum order of the attention at 16 lanes against 1 (other
# cuBLAS algorithms), which can move an activation across a 4-bit rounding
# boundary and cascade through the later layers, as phase 5 sees between
# the card and the CPU.  Each row must stay within CHUNK_ROW_REL_TOL relative
# L2 of phase 4's (phase 5's bound for a row with flips); such rows must stay
# rare: at least CHUNK_CLEAN_SHARE of the rows compared within
# CROSS_CLEAN_ABS_TOL of phase 4's per logit; and a request's tokens may
# part from phase 4's only at a token whose phase-4 top-2 logit gap is at
# most CHUNK_TIE_UNITS head units.  The packed head's logits are w_scale *
# a_scale times integers, so a gap is a whole number of such units (0 is a
# true tie, which argmax breaks by index); one activation level flipped at
# the head's input moves the gap between two columns by at most 15 units
# (4-bit weight levels differ by at most 15).  The degenerate (4, 4) head
# on random weights gives every row a large common part, so a wrong row
# stays within CHUNK_ROW_REL_TOL and may emit the same tokens; the share of
# clean rows tells it from a sound run.  Each run plants such a fault (the
# head fed each slot's last lane instead of its last valid one) and
# requires the checks to reject it.
CHUNK_ROW_REL_TOL = CROSS_FLIP_REL_TOL
CHUNK_CLEAN_SHARE = 0.5
CHUNK_TIE_UNITS = 15
# run (b)'s usable pool, as a share of the requests' summed worst-case pages
ON_DEMAND_POOL_SHARE = 0.6


def _against_c1(rows: dict, tokens: dict, c1: dict, tie_bound: float, prefix: bool = False) -> dict:
    """Phase 9's reading of one run's sampled rows and tokens against phase
    4's, up to and including each request's first token divergence.  By
    default every request of phase 4 must be in ``tokens`` at its full
    length; with ``prefix`` only the requests of ``tokens`` are read, each
    over its own tokens (a prefix of phase 4's where it ended early)."""
    import numpy as np

    if not prefix:
        check(tokens.keys() == c1["tokens"].keys(), f"requests {sorted(tokens)}, not phase 4's")
        check(all(len(tokens[rid]) == len(t) for rid, t in c1["tokens"].items()),
              "a request ended short of phase 4's tokens")
    divergences, rel, clean = [], [], 0
    for rid, ours in tokens.items():
        theirs = c1["tokens"][rid][:len(ours)]
        div = next((t for t in range(len(theirs)) if ours[t] != theirs[t]), None)
        for t in range(len(theirs) if div is None else div + 1):
            a, b = rows[(rid, t)], c1["samples"][(rid, t)]
            rel.append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
            clean += float(np.abs(a - b).max()) <= CROSS_CLEAN_ABS_TOL
        if div is not None:
            divergences.append((rid, div, c1["gaps"][(rid, div)]))
    r = dict(rows_compared=len(rel), rows_clean=clean, row_rel_max=max(rel),
             row_rel_p50=float(np.median(rel)), row_rel_min=min(rel), divergences=divergences)
    r["passes"] = (r["row_rel_max"] <= CHUNK_ROW_REL_TOL and clean >= CHUNK_CLEAN_SHARE * len(rel)
                   and all(gap <= tie_bound for _, _, gap in divergences))
    return r


def phase_chunked(torch, card, cfg, ecfg, c1: dict, fused: dict, report: dict) -> dict:
    """The slice's path at full width on phase 4's weights and prompts:
    chunked prefill under reserve admission, then under on-demand admission
    with a pool of about ``ON_DEMAND_POOL_SHARE`` of the worst case.  Each
    run is timed with no hook set; a second, untimed run of the same
    engine settings records the sampled rows, and must give the same
    tokens.  Last, the planted fault."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine

    prompts, max_new = c1["prompts"], 32
    head = c1["head"]
    tie_bound = CHUNK_TIE_UNITS * head.w_scale / ((1 << head.a_bits) - 1)
    print(f"  tie bound: {CHUNK_TIE_UNITS} head units = {tie_bound:.4g}", flush=True)
    worst = sum(-(-(len(p) + max_new) // ecfg.page_size) for p in prompts)
    usable = round(ON_DEMAND_POOL_SHARE * worst)
    print(f"  requests' summed worst case {worst} pages; on-demand pool {usable} usable pages "
          f"({usable / worst:.2f} of it)", flush=True)
    per_step = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": cfg.n_layers * 7 + 1,
                "paged_gather": cfg.n_layers}
    runs = {}
    for admit, n_pages in (("reserve", 0), ("on-demand", usable + 1)):
        ecfg9 = dataclasses.replace(ecfg, chunk_tokens=CHUNK, admit=admit, n_pages=n_pages)
        eng = Engine(cfg, c1["params"], ecfg9, head=head)
        m, counts, wall = _serve(torch, eng, prompts, max_new)
        steps = m["steps"]
        tokens = {r.rid: list(r.out_tokens) for r in eng.finished}
        check(m["statuses"] == {"ok": len(prompts)}, f"C={CHUNK} {admit}: statuses {m['statuses']}")
        check(all(len(t) == max_new for t in tokens.values()), f"C={CHUNK} {admit}: a request ended short")
        check(counts == {k: v * steps for k, v in per_step.items()},
              f"C={CHUNK} {admit}: launch counters {counts} != {per_step} x {steps} steps")
        if admit == "on-demand":
            check(m["preemptions"] > 0, "the on-demand run did not preempt")
            eng.assert_no_leaks()
        census = check_graph(eng, per_step, f"C={CHUNK} {admit}")
        eng.close()
        step_ms = [1e3 * x for x in eng.step_seconds]
        del eng
        rows, tokens_s = _sampled_run(torch, Engine(cfg, c1["params"], ecfg9, head=head), prompts, max_new)
        check(tokens_s == tokens, f"C={CHUNK} {admit}: the sampled (untimed) run gave other tokens")
        cmp = _against_c1(rows, tokens, c1, tie_bound)
        del rows
        run = dict(admit=admit, chunk_tokens=CHUNK, usable_pages=ecfg9.pool_pages() - 1, steps=steps,
                   fed_tokens=m["fed_tokens"], preemptions=m["preemptions"],
                   tokens=m["generated_tokens"], wall_s=wall, tokens_per_s=m["tokens_per_s"],
                   step_ms_p50=float(np.median(step_ms)), ttft_ms_p50=1e3 * m["ttft_p50"],
                   counts=counts, per_step=per_step, graph=census, **cmp)
        runs[admit] = run
        print(f"  C={CHUNK} {admit}: {steps} steps, {m['fed_tokens']} tokens fed, {m['preemptions']} "
              f"preemptions; {m['tokens_per_s']:.1f} tok/s, step p50 {run['step_ms_p50']:.2f} ms, TTFT "
              f"p50 {run['ttft_ms_p50']:.1f} ms; launches {counts}; {cmp['rows_compared']} sampled rows "
              f"against phase 4's: {cmp['rows_clean']} within {CROSS_CLEAN_ABS_TOL}, rel L2 max "
              f"{cmp['row_rel_max']:.3g}, p50 {cmp['row_rel_p50']:.3g}; first token divergences (rid, "
              f"t, phase-4 top-2 gap) {cmp['divergences']}", flush=True)
        check(cmp["row_rel_max"] <= CHUNK_ROW_REL_TOL,
              f"C={CHUNK} {admit}: a sampled row differs from phase 4's by more than {CHUNK_ROW_REL_TOL} relative")
        check(cmp["rows_clean"] >= CHUNK_CLEAN_SHARE * cmp["rows_compared"],
              f"C={CHUNK} {admit}: fewer than {CHUNK_CLEAN_SHARE} of the sampled rows equal phase 4's")
        check(all(gap <= tie_bound for _, _, gap in cmp["divergences"]),
              f"C={CHUNK} {admit}: tokens part from phase 4's at a top-2 gap above {tie_bound:.4g}")

    # planted fault: the head fed each slot's last lane, not its last valid one
    inner = T.head_paged
    T.head_paged = lambda params, cfg_, x, lens=None, head=None: inner(params, cfg_, x, None, head)
    try:
        ecfg9 = dataclasses.replace(ecfg, chunk_tokens=CHUNK)
        rows, tokens = _sampled_run(torch, Engine(cfg, c1["params"], ecfg9, head=head), prompts, max_new)
    finally:
        T.head_paged = inner
    fault = _against_c1(rows, tokens, c1, tie_bound)
    del rows
    print(f"  planted fault (head fed lane {CHUNK - 1}, not lens - 1): {fault['rows_compared']} rows "
          f"compared, {fault['rows_clean']} within {CROSS_CLEAN_ABS_TOL}, rel L2 min "
          f"{fault['row_rel_min']:.3g}, p50 {fault['row_rel_p50']:.3g}, max {fault['row_rel_max']:.3g}; "
          f"first token divergences {fault['divergences']}", flush=True)
    check(not fault["passes"], "phase 9's checks pass a head fed the wrong lane")

    print(f"  prefill at C=1 and C={CHUNK} on {card.name} ({card.power_limit}):", flush=True)
    for label, r in (("C=1 reserve (phase 4)", fused), (f"C={CHUNK} reserve", runs["reserve"]),
                     (f"C={CHUNK} on-demand", runs["on-demand"])):
        print(f"    {label:22s} steps {r['steps']:4d}, fed {r['fed_tokens']:5d}, TTFT p50 "
              f"{r['ttft_ms_p50']:8.1f} ms, step p50 {r['step_ms_p50']:7.2f} ms, "
              f"{r['tokens_per_s']:6.1f} tok/s", flush=True)
    report["chunked"] = dict(runs, tie_bound=tie_bound, planted_fault=fault)
    return runs


# -- phase 10 ------------------------------------------------------------------

# timed turns of each cell in phase 10: eager, captured, captured, eager, ...
CAPTURE_PAIRS = 4


def _sync_free_step(torch, eng) -> None:
    """After the warm-up, one eager step of ``eng`` under
    ``torch.cuda.set_sync_debug_mode("error")``: it must read nothing back
    to the host (no ``.item()``, no device-to-host copy)."""
    eng.warmup()
    prog = eng._program
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode(), prog._on_stream():
            prog._forward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    eng.close()


def phase_capture(torch, card, cfg, ecfg, c1: dict, report: dict) -> dict:
    """The captured step against the eager one on phase 4's weights and
    prompts, at C = 1 (phase 4's cell) and C = 16 under reserve admission
    (phase 9's): no synchronising call in an eager step; an untimed
    recording run of each mode, bit-identical sampled rows and equal
    tokens; then ``CAPTURE_PAIRS`` pairs of timed turns in alternating
    order; last, traces of the eager C = 1 run and of both C = 16 runs."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.serving import Engine

    prompts, max_new = c1["prompts"], 32
    cells = {"C=1": ecfg, f"C={CHUNK}": dataclasses.replace(ecfg, chunk_tokens=CHUNK)}
    per_step = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": cfg.n_layers * 7 + 1,
                "paged_gather": cfg.n_layers}

    def engine(e, capture: bool):
        return Engine(cfg, c1["params"], e, head=c1["head"], capture=capture)

    for e in cells.values():
        _sync_free_step(torch, engine(e, False))
    print(f"  an eager step at C=1 and at C={CHUNK} after its warm-up: no synchronising call", flush=True)
    out = {}
    for label, e in cells.items():
        (rows_e, toks_e), (rows_c, toks_c) = (_sampled_run(torch, engine(e, capture), prompts, max_new)
                                              for capture in (False, True))
        check(toks_c == toks_e, f"{label}: the captured engine gave other tokens than the eager one")
        differ = [k for k in rows_e if k not in rows_c or rows_c[k].tobytes() != rows_e[k].tobytes()]
        check(rows_c.keys() == rows_e.keys() and not differ,
              f"{label}: {len(differ)} of {len(rows_e)} sampled rows differ between the captured and the "
              f"eager step, first {differ[:4]}")
        n_rows = len(rows_e)
        print(f"  {label}: captured and eager, {n_rows} sampled rows bit-identical, tokens equal", flush=True)
        del rows_e, rows_c
        turns = []
        for i, capture in enumerate([False, True, True, False] * (CAPTURE_PAIRS // 2)):
            eng = engine(e, capture)
            m, counts, wall = _serve(torch, eng, prompts, max_new)
            check(m["statuses"] == {"ok": len(prompts)}, f"{label} turn {i + 1}: statuses {m['statuses']}")
            check({r.rid: list(r.out_tokens) for r in eng.finished} == toks_e,
                  f"{label} turn {i + 1}: tokens differ from the recording run's")
            check(counts == {k: v * m["steps"] for k, v in per_step.items()},
                  f"{label} turn {i + 1}: launch counters {counts} != {per_step} x {m['steps']} steps")
            step_ms = [1e3 * x for x in eng.step_seconds]
            replay_ms = graph_replay_ms(torch, eng) if capture else None
            eng.close()
            del eng
            torch.cuda.empty_cache()
            t = dict(turn=i + 1, capture=capture, steps=m["steps"], wall_s=wall,
                     step_ms_p50=float(np.median(step_ms)), step_ms_min=min(step_ms),
                     tokens_per_s=m["tokens_per_s"], ttft_ms_p50=1e3 * m["ttft_p50"], replay_ms=replay_ms)
            turns.append(t)
            print(f"    turn {i + 1} {'captured' if capture else 'eager   '}: {t['steps']} steps, step p50 "
                  f"{t['step_ms_p50']:.2f} ms (min {t['step_ms_min']:.2f}), {t['tokens_per_s']:.1f} tok/s, "
                  f"TTFT p50 {t['ttft_ms_p50']:.1f} ms"
                  + (f"; one replay {replay_ms:.2f} ms of device time" if capture else ""), flush=True)
        med = {mode: {k: float(np.median([t[k] for t in turns if t["capture"] == (mode == "captured")]))
                      for k in ("step_ms_p50", "tokens_per_s", "ttft_ms_p50")}
               for mode in ("eager", "captured")}
        wins = sum(c["step_ms_p50"] < e_["step_ms_p50"] for e_, c in zip(
            [t for t in turns if not t["capture"]], [t for t in turns if t["capture"]]))
        print(f"  {label} on {card.name} ({card.power_limit}), medians eager / captured: step p50 "
              f"{med['eager']['step_ms_p50']:.2f} / {med['captured']['step_ms_p50']:.2f} ms, tok/s "
              f"{med['eager']['tokens_per_s']:.1f} / {med['captured']['tokens_per_s']:.1f}, TTFT p50 "
              f"{med['eager']['ttft_ms_p50']:.1f} / {med['captured']['ttft_ms_p50']:.1f} ms; captured "
              f"faster in {wins} of {CAPTURE_PAIRS} pairs", flush=True)
        out[label] = dict(turns=turns, medians=med, captured_faster_pairs=wins,
                          sampled_rows=n_rows)
    out["profiles"] = [profile_engine(torch, engine(ecfg, False), cfg, "C=1, eager")]
    for capture in (True, False):
        out["profiles"].append(profile_engine(torch, engine(cells[f"C={CHUNK}"], capture), cfg,
                                              f"C={CHUNK}, {'captured' if capture else 'eager'}"))
    report["capture"] = out
    return out


# -- phase 11 ------------------------------------------------------------------

# phase 11's timed turns, alternating: plan, w4a4, w4a4, plan, ... (PLAN_PAIRS pairs)
PLAN_PAIRS = 3
# phase 11's card-vs-CPU fixture: one layer of each pair of the searched plan
PLAN_CROSS_BITS = ((8, 8), (5, 4), (3, 2))


def plan_launches(plan, cfg, n_slots: int) -> tuple[dict, dict]:
    """Kernel launches of one decode step of an engine serving ``plan``:
    ``(per counter, per (counter, w_bits, a_bits, K, N, block_k))``.  A
    layer with a placement runs each projection on K1 when its
    ``block_k`` is None or covers the projection's K, on K2 otherwise; a
    pair with no placement (n_seg 1) runs the plain integer path, no port
    kernel; K3 runs once a layer."""
    from repro_torch.kernels import build
    from repro_torch.plan.search import ProjShape, layer_matmul_shapes

    per = dict.fromkeys(build.COUNTS, 0)
    rows: dict = {}
    shapes = layer_matmul_shapes(cfg, n_slots)
    entries = [(lp, shapes[i]) for i, lp in enumerate(plan.layers)]
    if plan.lm_head is not None:
        entries.append((plan.lm_head, [ProjShape("head", n_slots, cfg.d_model, cfg.vocab)]))
    for lp, projs in entries:
        if lp.n_seg == 1:
            continue
        for p in projs:
            kernel = "packed_dense_fused" if lp.block_k is None or lp.block_k >= p.k else "packed_matmul"
            per[kernel] += 1
            key = (kernel, lp.w_bits, lp.a_bits, p.k, p.n, lp.block_k if kernel == "packed_matmul" else None)
            rows[key] = rows.get(key, 0) + 1
    per["paged_gather"] = cfg.n_layers
    return per, rows


def phase_plan_kernels(torch, card, timer, rows_per_step: dict, M: int) -> list:
    """K1 and K2 against their plain versions at every distinct (kernel,
    pair, shape, block_k) the tuned plan serves: bit-exact; timed by CUDA
    graph (weights cycled through 256 MB) beside their bound and
    ``torch._int_mm`` on the same levels."""
    from repro_torch.kernels.packed_matmul import ref as pm
    from repro_torch.kernels.packed_matmul.kernel import (
        packed_dense_fused_plain, packed_dense_fused_raw, packed_matmul_plain, packed_matmul_raw,
    )
    from repro_torch.kernels.packed_matmul.ops import choose_config

    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    rows = []
    for (kernel, w_b, a_b, K, N, bk), per_step in sorted(rows_per_step.items()):
        c = choose_config(w_b, a_b)
        kw = dict(n_seg=c.n_seg, stride=c.stride, acc_chunk=c.acc_chunk, overlap=c.overlap)
        x = torch.rand((M, K), generator=g, device="cuda") * 1.2 - 0.1
        n_pad = -(-N // c.n_seg) * c.n_seg
        w_lvl = torch.randint(0, 1 << w_b, (K, n_pad), generator=g, device="cuda", dtype=torch.int32)
        wp = pm.pack_weights(w_lvl, c.n_seg, c.stride)
        w8 = w_lvl[:, :N].to(torch.int8).contiguous()
        del w_lvl
        a_lvl = torch.round(torch.clamp(x, 0, 1) * ((1 << a_b) - 1)).to(torch.int32)
        if kernel == "packed_dense_fused":
            def run(w, x=x, kw=kw):
                return packed_dense_fused_raw(x, w, a_bits=a_b, **kw)

            def plain(w=wp, x=x, kw=kw):
                return packed_dense_fused_plain(x, w, a_bits=a_b, **kw)
        else:
            def run(w, a=a_lvl, kw=kw, bk=bk):
                return packed_matmul_raw(a, w, block_k=bk, **kw)

            def plain(w=wp, a=a_lvl, kw=kw, bk=bk):
                return packed_matmul_plain(a, w, block_k=bk, **kw)
        got, want = run(wp), plain()
        torch.cuda.synchronize()
        got, want = (got, want) if kernel == "packed_dense_fused" else ((got,), (want,))
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        label = f"{kernel} w{w_b}a{a_b} K={K} N={N}" + (f" block_k={bk}" if bk else "")
        check(all(torch.equal(a, b) for a, b in zip(got, want)), f"{label} differs from its plain version")
        nbytes = (M * K * 4 + K * wp.shape[1] * 4 + M * n_pad * 4
                  + (M * 4 if kernel == "packed_dense_fused" else 0))
        b_ms, b_by, t_b, t_o = k1_bound(card, M, K, N, nbytes)
        int_mm, int_mm_m = _int_mm(torch, a_lvl.to(torch.int8), w8)
        wps, w8s = cold_copies(wp), cold_copies(w8)
        row = dict(kernel=kernel, pair=f"w{w_b}a{a_b}", K=K, N=N, M=M, block_k=bk, placement=list(c),
                   per_step=per_step, max_abs_err=err, bytes=nbytes,
                   graph_ms=timer.graph(lambda i: run(wps[i % len(wps)])),
                   events_ms=timer(lambda: run(wp), reps=20),
                   plain_ms=timer(plain, reps=1, warmup=0),
                   int_mm_graph_ms=timer.graph(lambda i: int_mm(w8s[i % len(w8s)])), int_mm_m=int_mm_m,
                   bound_ms=b_ms, bound_by=b_by, t_bytes=t_b, t_ops=t_o)
        rows.append(row)
        print(f"  {label} (x{per_step} a step): {row['graph_ms']:.4f} ms by graph (events "
              f"{row['events_ms']:.4f}), plain {row['plain_ms']:.2f} ms, _int_mm (M={int_mm_m}) "
              f"{row['int_mm_graph_ms']:.4f}, bound {b_ms:.4f} ms ({b_by}); bit-exact", flush=True)
        del x, wp, w8, a_lvl, wps, w8s, int_mm, got, want
    return rows


def _plan_cross_check(torch, cfg, tuned, report: dict, steps: int = 3) -> dict:
    """3 layers at full width, one of each of the plan's pairs at its tuned
    ``block_k``, and the plan's head, float32, on the card and on the CPU
    from the same packed words.  Flips are split by the quantizer they hit:
    a fine one (8-bit activations, phase 8's) or a coarse one (2- or 4-bit,
    phase 5's).  Rows with no flip at this or an earlier step agree to
    CROSS_CLEAN_ABS_TOL per logit; rows whose flips are all fine stay
    within DEFAULT_FLIP_REL_TOL relative L2 (phase 8's rule); rows with a
    coarse flip within CROSS_FLIP_REL_TOL (phase 5's); greedy tokens agree
    where decided (phase 5's); and first-hand coarse flips stay rare: over
    the run, at most half the slot-steps of slots with no earlier flip take
    one (the slot's first flipped quantizer of the step is coarse), phase
    5's rarity rule for the quantizers where a flip moves a whole coarse
    level, counted over all steps as phase 5 counts its chunked step's
    rows, since cascades leave few such slots at a later step."""
    from repro_torch.models import transformer as T
    from repro_torch.plan import apply_plan, plan_from_bits

    cfg3 = dataclasses.replace(cfg, n_layers=len(PLAN_CROSS_BITS), dtype=torch.float32)
    block_k = {lp.bits: lp.block_k for lp in tuned.layers}
    plan3 = plan_from_bits(cfg3, arch="llama3.2-3b", bits=list(PLAN_CROSS_BITS), smoke=False,
                           head_bits=(tuned.lm_head.w_bits, tuned.lm_head.a_bits))
    plan3 = dataclasses.replace(plan3, layers=[dataclasses.replace(lp, block_k=block_k[lp.bits])
                                               for lp in plan3.layers])
    params = T.init_params(cfg3, seed=1, device="cuda")
    packed, head = apply_plan(params, cfg3, plan3, verbose=False, device="cuda")
    del params
    a_bits = [lp.a_bits for lp in plan3.layers for _ in range(7)] + [plan3.lm_head.a_bits]
    S = 8
    prior = torch.zeros(S, dtype=torch.bool)  # any flip at an earlier step
    coarse_cum = torch.zeros(S, dtype=torch.bool)
    results = []
    fresh_total = eligible_total = 0
    for t, (g_log, c_log, flipped, read, row_flip, head_flip, calls) in enumerate(
            _cross_steps(torch, cfg3, packed, head, steps, seed=13, gather="kernel")):
        calls = [c.reshape(S, -1).any(dim=1) for c in calls]
        coarse = torch.stack([c for c, a in zip(calls, a_bits) if a <= 4]).any(dim=0)
        coarse_cum |= coarse
        first = [next((a for c, a in zip(calls, a_bits) if c[s]), None) for s in range(S)]
        fresh = sum(1 for s in range(S) if not prior[s] and first[s] is not None and first[s] <= 4)
        st = _row_stats(torch, g_log, c_log, flipped)
        fine_only = flipped & ~coarse_cum
        r = dict(step=t, first_flip_a_bits=first, coarse_rows=int(coarse_cum.sum()),
                 fine_only_rows=int(fine_only.sum()), fresh_coarse=fresh, eligible=int((~prior).sum()),
                 fine_only_max_rel=float(st["row_rel"][fine_only].max()) if fine_only.any() else None,
                 **st["summary"])
        results.append(r)
        print(f"  cross-check step {t}: {r['clean_rows']}/{S} rows without a flip (max|d| "
              f"{r['clean_max_abs']}); {r['fine_only_rows']} with 8-bit flips only (max rel L2 "
              f"{r['fine_only_max_rel']}), {r['coarse_rows']} with a 2/4-bit flip (max rel L2 of flipped "
              f"rows {r['flipped_max_rel']}); first flipped quantizer's a_bits by slot {first}; "
              f"{fresh} of {r['eligible']} slots without an earlier flip took a first-hand coarse flip; "
              f"greedy tokens agree {r['tokens_agree']}/{S}", flush=True)
        check(bool((st["row_max"][st["clean"]] <= CROSS_CLEAN_ABS_TOL).all()),
              f"plan cross-check step {t}: a row without flips differs by more than {CROSS_CLEAN_ABS_TOL}")
        check(bool((st["row_rel"][fine_only] <= DEFAULT_FLIP_REL_TOL).all()),
              f"plan cross-check step {t}: a row with 8-bit flips only differs by more than "
              f"{DEFAULT_FLIP_REL_TOL} relative")
        check(bool((st["row_rel"][coarse_cum] <= CROSS_FLIP_REL_TOL).all()),
              f"plan cross-check step {t}: a row with a coarse flip differs by more than "
              f"{CROSS_FLIP_REL_TOL} relative")
        check(bool((st["agree"] | ~st["decided"] | flipped).all()),
              f"plan cross-check step {t}: greedy token differs past the gap bound")
        fresh_total, eligible_total = fresh_total + fresh, eligible_total + r["eligible"]
        prior = flipped
    check(len(results) == steps, "the plan cross-check did not run every step")
    print(f"  first-hand coarse flips in {fresh_total} of {eligible_total} slot-steps without an earlier "
          f"flip", flush=True)
    check(2 * fresh_total <= eligible_total,
          f"plan cross-check: first-hand coarse flips in {fresh_total} of {eligible_total} slot-steps")
    report["plan_crosscheck"] = dict(plan=plan3.to_payload(), steps=results)
    return results


def _timed_turn(torch, eng, prompts, per_step: dict, what: str, memset: bool, max_new: int = 32,
                keep: bool = False) -> dict:
    """One timed run of a fresh engine (captured), ``max_new`` tokens a
    request: statuses, counters and the graph's port kernel nodes equal to
    ``per_step`` (times the steps), and its times; then release it, unless
    ``keep`` (a later run on it, say a trace, releases it).  ``memset``:
    the graph may hold memset nodes (check_graph)."""
    import numpy as np

    m, counts, wall = _serve(torch, eng, prompts, max_new)
    check(m["statuses"] == {"ok": len(prompts)}, f"{what}: statuses {m['statuses']}")
    check(counts == {k: v * m["steps"] for k, v in per_step.items()},
          f"{what}: launch counters {counts} != {per_step} x {m['steps']} steps")
    census = check_graph(eng, per_step, what, memset=memset)
    replay = graph_replay_ms(torch, eng)
    if not keep:
        eng.close()
    step_ms = [1e3 * x for x in eng.step_seconds]
    out = dict(steps=m["steps"], wall_s=wall, tokens_per_s=m["tokens_per_s"],
               step_ms_p50=float(np.median(step_ms)), step_ms_min=min(step_ms),
               ttft_ms_p50=1e3 * m["ttft_p50"], replay_ms=replay, counts=counts, graph=census,
               preemptions=m["preemptions"], fed_tokens=m["fed_tokens"],
               tokens={r.rid: list(r.out_tokens) for r in eng.finished})
    if not keep:
        torch.cuda.empty_cache()
    return out


def phase_plan(torch, card, cfg, ecfg, c1: dict, report: dict) -> dict:
    """Deployment plans on the card: search (hash against the CPU's), the
    on-card autotune and pair times, K1/K2 at the tuned plan's placements
    against their plain versions, the tuned plan served at full width
    (graph census against the counters, weight bytes against the plan's
    prediction, timed in alternating turns beside phase 4's w4a4 cell),
    the card against the CPU at 3 layers, and a uniform (4, 4) plan against
    phase 4's engine."""
    import numpy as np

    from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
    from repro_torch.models import transformer as T
    from repro_torch.plan import autotune_plan, measure_pair_times, search_plan, summarize, uniform_plan
    from repro_torch.plan import search as plan_search
    from repro_torch.serving import Engine, build_engine

    out: dict = {}
    secs: dict = {}
    t0 = time.monotonic()
    lut_was_cached = plan_search.DEFAULT_LUT_PATH.exists()
    plan = search_plan(cfg, arch="llama3.2-3b", objective="footprint", budget_frac=0.85, smoke=False)
    secs["search"] = time.monotonic() - t0
    check(plan.content_hash() == PLAN_HASH, f"searched plan hash {plan.content_hash()} != the CPU's {PLAN_HASH}")
    print(f"  search ({'LUT loaded from the cache' if lut_was_cached else 'LUT built in-process'}, "
          f"{secs['search']:.2f} s): {summarize(plan)}; the CPU's hash", flush=True)

    t0 = time.monotonic()
    tuned = autotune_plan(plan, cfg, n_slots=ecfg.n_slots, reps=3)
    secs["autotune"] = time.monotonic() - t0
    for key, entry in tuned.autotune["table"].items():
        times = ", ".join(f"{bk}: {us:.1f}" for bk, us in entry["timings_us"].items())
        print(f"  autotune {key}: block_k={entry['block_k']} (us a call by block_k: {times})", flush=True)
    per_step, kernel_rows = plan_launches(tuned, cfg, ecfg.n_slots)
    to_k2 = sorted({(lp.index, key[3]) for lp in tuned.layers for key in kernel_rows
                    if key[0] == "packed_matmul" and (key[1], key[2]) == lp.bits and lp.n_seg > 1})
    print(f"  autotune on the card in {secs['autotune']:.1f} s; per step {per_step}; projections on K2 "
          f"(layer, K): {to_k2 or 'none'}", flush=True)
    t0 = time.monotonic()
    pair_times = measure_pair_times(cfg, bit_choices=plan_search.DEFAULT_BIT_CHOICES, n_slots=ecfg.n_slots,
                                    reps=3)
    secs["pair_times"] = time.monotonic() - t0
    print(f"  pair times (whole K, us a layer at n_slots {ecfg.n_slots}, {secs['pair_times']:.1f} s): "
          + ", ".join(f"w{w}a{a} {1e6 * t:.1f}" for (w, a), t in pair_times.items()), flush=True)
    measured = search_plan(cfg, arch="llama3.2-3b", objective="footprint", budget_frac=0.85, smoke=False,
                           pair_times=pair_times)
    print(f"  search with these pair times (not served): {summarize(measured)}", flush=True)
    out.update(hash=plan.content_hash(), plan=tuned.to_payload(), per_step=per_step, to_k2=to_k2,
               pair_times_us={f"w{w}a{a}": 1e6 * t for (w, a), t in pair_times.items()},
               measured_plan=dict(hash=measured.content_hash(), summary=summarize(measured),
                                  bits=measured.bit_pairs(), predicted=measured.predicted))

    timer = Timer(torch)
    t0 = time.monotonic()
    out["kernels"] = phase_plan_kernels(torch, card, timer, kernel_rows, ecfg.n_slots)
    secs["kernels"] = time.monotonic() - t0
    del timer
    torch.cuda.empty_cache()

    # the tuned plan at full width, from the random weights of phase 4 (seed 0)
    t0 = time.monotonic()
    eng = build_engine(cfg, ecfg, plan=tuned, seed=0)
    torch.cuda.synchronize()
    secs["build"] = time.monotonic() - t0
    leaves = []
    T.map_leaves(eng.params["layers"], leaves.append)
    wbytes = sum(a.data.numel() * a.data.element_size() for a in leaves if isinstance(a, PackedDenseParams))
    check(wbytes == tuned.predicted["weight_bytes"],
          f"projection weight bytes on the card {wbytes} != the plan's {tuned.predicted['weight_bytes']}")
    params, head = eng.params, eng._head
    prompts = c1["prompts"]
    first = _timed_turn(torch, eng, prompts, per_step, "plan engine", memset=True)
    census = first["graph"]
    print(f"  plan engine: built in {secs['build']:.1f} s, projection weights {wbytes / 1e9:.3f} GB on the "
          f"card = the plan's prediction; {first['steps']} steps, step p50 {first['step_ms_p50']:.2f} ms, "
          f"{first['tokens_per_s']:.1f} tok/s, TTFT p50 {first['ttft_ms_p50']:.1f} ms, one replay "
          f"{first['replay_ms']:.2f} ms; launches {first['counts']}; graph nodes {census}", flush=True)
    rows_p, toks_p = _sampled_run(torch, Engine(cfg, params, ecfg, head=head), prompts, 32)
    check(toks_p == first["tokens"], "the plan's sampled (untimed) run gave other tokens than its timed run")
    w4a4_step = {**dict.fromkeys(per_step, 0), "packed_dense_fused": cfg.n_layers * 7 + 1,
                 "paged_gather": cfg.n_layers}
    turns = []
    cells = [c for i in range(PLAN_PAIRS) for c in (("plan", "w4a4") if i % 2 == 0 else ("w4a4", "plan"))]
    for i, cell in enumerate(cells):
        if cell == "plan":
            t = _timed_turn(torch, Engine(cfg, params, ecfg, head=head), prompts, per_step, f"turn {i + 1}",
                           memset=True)
            check(t["tokens"] == first["tokens"], f"turn {i + 1}: the plan's tokens changed")
        else:
            t = _timed_turn(torch, Engine(cfg, c1["params"], ecfg, head=c1["head"]), prompts, w4a4_step,
                           f"turn {i + 1}", memset=False)
            check(t["tokens"] == c1["tokens"], f"turn {i + 1}: w4a4 tokens differ from phase 4's")
        t.update(turn=i + 1, cell=cell)
        del t["tokens"], t["graph"]
        turns.append(t)
        print(f"    turn {i + 1} {cell:5s}: {t['steps']} steps, step p50 {t['step_ms_p50']:.2f} ms (min "
              f"{t['step_ms_min']:.2f}), {t['tokens_per_s']:.1f} tok/s, TTFT p50 {t['ttft_ms_p50']:.1f} ms, "
              f"one replay {t['replay_ms']:.2f} ms", flush=True)
    med = {cell: {k: float(np.median([t[k] for t in turns if t["cell"] == cell]))
                  for k in ("step_ms_p50", "tokens_per_s", "ttft_ms_p50", "replay_ms")}
           for cell in ("plan", "w4a4")}
    print(f"  on {card.name} ({card.power_limit}), medians plan / w4a4 over {PLAN_PAIRS} pairs: step p50 "
          f"{med['plan']['step_ms_p50']:.2f} / {med['w4a4']['step_ms_p50']:.2f} ms, tok/s "
          f"{med['plan']['tokens_per_s']:.1f} / {med['w4a4']['tokens_per_s']:.1f}, TTFT p50 "
          f"{med['plan']['ttft_ms_p50']:.1f} / {med['w4a4']['ttft_ms_p50']:.1f} ms, one replay "
          f"{med['plan']['replay_ms']:.2f} / {med['w4a4']['replay_ms']:.2f} ms", flush=True)
    out.update(weight_bytes=wbytes, first=dict(first, tokens=None, graph=None), graph=census, turns=turns, medians=med,
               sampled_rows=len(rows_p))
    out["profile"] = profile_engine(torch, Engine(cfg, params, ecfg, head=head), cfg, "plan, captured")
    del eng, params, head, rows_p
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    out["crosscheck"] = _plan_cross_check(torch, cfg, tuned, report)
    secs["crosscheck"] = time.monotonic() - t0
    torch.cuda.empty_cache()

    # a uniform (4, 4) plan is phase 4's quant="packed" engine, row for row
    uplan = uniform_plan(cfg, arch="llama3.2-3b", w_bits=4, a_bits=4, head_bits=(4, 4), smoke=False)
    rows_u, toks_u = _sampled_run(torch, build_engine(cfg, ecfg, plan=uplan, seed=0), prompts, 32)
    differ = [k for k in c1["samples"] if k not in rows_u or rows_u[k].tobytes() != c1["samples"][k].tobytes()]
    check(toks_u == c1["tokens"] and rows_u.keys() == c1["samples"].keys() and not differ,
          f"uniform (4, 4) plan: {len(differ)} of {len(c1['samples'])} sampled rows differ from phase 4's")
    print(f"  uniform (4, 4) plan through build_engine(plan=...): {len(rows_u)} sampled rows bit-identical "
          f"to phase 4's, tokens equal", flush=True)
    del rows_u
    out["seconds"] = secs
    report["plan"] = out
    return out


# -- phase 12 ------------------------------------------------------------------

# timed turns of each of phase 12's cell pairs, alternating (first, second,
# second, first, ...): INT8_TURN_PAIRS pairs
INT8_TURN_PAIRS = 2

# phase 12 (d) tolerance.  quant="int8" quantizes no activation: both sides
# dequantize the same int8 weight levels and scales (products exact in
# float32) and differ by float32 sum order (cuBLAS against the CPU), on int8
# KV pools, unless a K/V value sits on a rounding boundary of
# quantize_kv_row and its level flips (one element moves by one step,
# 1/127 of its row's max).  A slot none of whose KV levels differ must
# agree to INT8_W_REL_TOL relative L2 per logits row; a slot with such a
# flip to INT8_KV_FLIP_REL_TOL; greedy tokens agree where decided (phase
# 5's rule: the CPU's top-2 gap above twice the row's largest |difference|).
INT8_W_REL_TOL = 1e-4
INT8_KV_FLIP_REL_TOL = 1e-2


def _census_gathers(census: dict, family: str, n: int, what: str) -> None:
    """The graph's K3 nodes are ``n`` of ``family`` (``gather_fp`` or
    ``gather_i8``) and none of the other."""
    fams = {k: v for k, v in census["families"].items() if k.startswith("gather_")}
    check(fams == {family: n}, f"{what}: K3 nodes by kernel {fams}, not {{{family!r}: {n}}}")


def _alternating_turns(torch, make, prompts, cells: dict, what: str) -> dict:
    """``INT8_TURN_PAIRS`` pairs of timed turns of two cells in alternating order.
    ``cells`` maps each cell's label to ``(per_step, K3 family, memset)``;
    ``make(label)`` builds a fresh engine of the cell.  Every turn is
    checked by :func:`_timed_turn` and :func:`_census_gathers`, and gives
    its cell's tokens of the first turn.  Returns the turns, each cell's
    medians, tokens and graph census."""
    import numpy as np

    a, b = cells
    turns, tokens, census = [], {}, {}
    for i, cell in enumerate(c for k in range(INT8_TURN_PAIRS) for c in ((a, b) if k % 2 == 0 else (b, a))):
        per_step, family, memset = cells[cell]
        t = _timed_turn(torch, make(cell), prompts, per_step, f"{what} turn {i + 1} ({cell})", memset=memset)
        _census_gathers(t["graph"], family, per_step["paged_gather"], f"{what} turn {i + 1} ({cell})")
        check(tokens.setdefault(cell, t["tokens"]) == t["tokens"], f"{what} turn {i + 1}: {cell} tokens changed")
        census[cell] = t.pop("graph")
        del t["tokens"]
        t.update(turn=i + 1, cell=cell)
        turns.append(t)
        print(f"    turn {i + 1} {cell:12s}: {t['steps']} steps, step p50 {t['step_ms_p50']:.2f} ms (min "
              f"{t['step_ms_min']:.2f}), {t['tokens_per_s']:.1f} tok/s, TTFT p50 {t['ttft_ms_p50']:.1f} ms, "
              f"one replay {t['replay_ms']:.2f} ms", flush=True)
    med = {cell: {k: float(np.median([t[k] for t in turns if t["cell"] == cell]))
                  for k in ("step_ms_p50", "tokens_per_s", "ttft_ms_p50", "replay_ms")}
           for cell in cells}
    return dict(turns=turns, medians=med, tokens=tokens, census=census)


def _print_medians(card, med: dict, what: str) -> None:
    a, b = med
    print(f"  {what} on {card.name} ({card.power_limit}), medians {a} / {b} over {INT8_TURN_PAIRS} pairs: "
          f"step p50 {med[a]['step_ms_p50']:.2f} / {med[b]['step_ms_p50']:.2f} ms, tok/s {med[a]['tokens_per_s']:.1f} / "
          f"{med[b]['tokens_per_s']:.1f}, TTFT p50 {med[a]['ttft_ms_p50']:.1f} / {med[b]['ttft_ms_p50']:.1f} ms, "
          f"one replay {med[a]['replay_ms']:.2f} / {med[b]['replay_ms']:.2f} ms", flush=True)


def _int8_weights_cross_check(torch, cfg, steps: int = 3) -> list:
    """``quant="int8"`` on int8 KV pools at 2 layers of full width, float32,
    the float head: ``steps`` decode steps and phase 5's chunked step on
    the card and on the CPU from the same int8 levels and scales, in
    :func:`_cross_steps`' geometry, with the kernel gather."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.serving.api import quantize_params_int8

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32, kv_dtype="int8")
    params = T.init_params(cfg2, seed=1, device="cuda")
    q = {"cuda": quantize_params_int8(params)}
    del params
    q["cpu"] = T.map_leaves(q["cuda"], lambda a: a.cpu())
    S, ps, nb = CROSS_SLOTS, 16, CROSS_BLOCKS
    n_pages = S * nb + 1
    states = {dev: T.init_paged_state(cfg2, S, n_pages, ps, dtype=torch.float32, device=dev) for dev in q}
    table = torch.arange(1, n_pages, dtype=torch.int32).reshape(S, nb)
    rng = np.random.default_rng(17)
    results = []
    k3_before = build.counts()["paged_gather"]
    for t, (C, lens) in enumerate([(1, None)] * steps + [(CHUNK, CROSS_CHUNK_LENS)]):
        tokens = torch.from_numpy(rng.integers(0, cfg2.vocab, (S, C)).astype(np.int32))
        pos = torch.full((S,), t, dtype=torch.int32)
        tlens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
        logits = {}
        for dev in ("cuda", "cpu"):
            logits[dev], _ = T.forward_decode_paged(
                q[dev], cfg2, states[dev], table.to(dev), tokens.to(dev), pos.to(dev),
                lens=None if tlens is None else tlens.to(dev), gather="kernel")
        g_log = logits["cuda"].cpu()
        check(bool(torch.isfinite(g_log).all()), f"int8-weight cross-check step {t}: non-finite logits")
        kv = _kv_level_flips(torch, states)
        kv_slots = kv.pop("kv_slots")
        st = _row_stats(torch, g_log, logits["cpu"], kv_slots)
        clean = ~kv_slots
        r = dict(step=t, chunk=C, kv_slots=int(kv_slots.sum()), **kv,
                 clean_max_rel=float(st["row_rel"][clean].max()) if clean.any() else None,
                 kv_flip_max_rel=float(st["row_rel"][kv_slots].max()) if kv_slots.any() else None,
                 tokens_agree=st["summary"]["tokens_agree"], tokens_decided=st["summary"]["tokens_decided"])
        results.append(r)
        print(f"  int8 weights + int8 KV, {'chunked step' if lens else f'step {t}'}: {S - r['kv_slots']}/{S} "
              f"slots with identical KV levels, max rel L2 {r['clean_max_rel']}; {r['kv_slots']} with a KV "
              f"level flip ({kv['kv_levels_off_by_one']} levels off by one, {kv['kv_levels_off_more']} by "
              f"more), max rel L2 {r['kv_flip_max_rel']}; greedy tokens agree {r['tokens_agree']}/{S}",
              flush=True)
        check(bool((st["row_rel"][clean] <= INT8_W_REL_TOL).all()),
              f"int8-weight cross-check step {t}: a row with identical KV levels differs by more than "
              f"{INT8_W_REL_TOL} relative")
        check(bool((st["row_rel"][kv_slots] <= INT8_KV_FLIP_REL_TOL).all()),
              f"int8-weight cross-check step {t}: a row with a KV level flip differs by more than "
              f"{INT8_KV_FLIP_REL_TOL} relative")
        check(bool((st["agree"] | ~st["decided"]).all()),
              f"int8-weight cross-check step {t}: greedy token differs past the gap bound")
    k3 = build.counts()["paged_gather"] - k3_before
    check(k3 == cfg2.n_layers * (steps + 1), f"int8-weight cross-check: {k3} K3 launches on the card")
    return results


def phase_int8_serving(torch, card, cfg, ecfg, c1: dict, chunked: dict, report: dict) -> dict:
    """int8 KV pools and int8 serving weights at full width: (a) phase 4's
    cell on int8 pools, timed in alternating turns beside phase 4's bf16
    pools; (b) phase 9's on-demand chunked cell on int8 pools at phase 9's
    page count and at its pool bytes; (c) the card against the CPU on int8
    pools at 2 layers, both gathers (phase 5's rules); (d)
    ``build_engine(quant="int8")`` with the float head, timed beside
    ``quant=None`` on the same float weights, and checked against the CPU
    at 2 layers on int8 pools."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, build_engine

    out: dict = {}
    prompts = c1["prompts"]
    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    D = cfg.kv_heads * cfg.hd
    packed_step = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": cfg.n_layers * 7 + 1,
                   "paged_gather": cfg.n_layers}

    # (a) phase 4's cell on int8 pools, in turns with phase 4's bf16 pools
    print("  (a) phase 4's cell on int8 KV pools against its bf16 pools, alternating turns", flush=True)
    pools = {"int8 KV": cfg8, "bf16 KV": cfg}
    a = _alternating_turns(
        torch, lambda cell: Engine(pools[cell], c1["params"], ecfg, head=c1["head"]), prompts,
        {"int8 KV": (packed_step, "gather_i8", False), "bf16 KV": (packed_step, "gather_fp", False)},
        "(a)")
    check(a["tokens"]["bf16 KV"] == c1["tokens"], "(a): the bf16-pool turns gave other tokens than phase 4")
    _print_medians(card, a["medians"], "(a)")
    first = next(t for t in a["turns"] if t["cell"] == "int8 KV")
    print(f"  (a) int8 KV graph nodes {a['census']['int8 KV']}; launches of its first turn {first['counts']}",
          flush=True)
    rows, toks = _sampled_run(torch, Engine(cfg8, c1["params"], ecfg, head=c1["head"]), prompts, 32)
    check(toks == a["tokens"]["int8 KV"], "(a): the sampled (untimed) int8 run gave other tokens")
    rel = [float(np.linalg.norm(rows[k] - c1["samples"][k]) / np.linalg.norm(c1["samples"][k]))
           for k in c1["samples"]]
    same = sum(x == y for rid in toks for x, y in zip(toks[rid], c1["tokens"][rid]))
    n_tok = sum(len(v) for v in c1["tokens"].values())
    a.update(rows_rel_l2=dict(p50=float(np.median(rel)), max=max(rel), min=min(rel)),
             tokens_equal=same, tokens=n_tok, requests_equal=sum(toks[r] == c1["tokens"][r] for r in toks))
    print(f"  (a) int8 KV sampled rows against phase 4's bf16-pool rows (not a gate): rel L2 p50 "
          f"{np.median(rel):.4g}, max {max(rel):.4g}; tokens equal {same}/{n_tok}, requests with equal "
          f"tokens {a['requests_equal']}/{len(toks)}", flush=True)
    del rows
    a["profile"] = profile_engine(torch, Engine(cfg8, c1["params"], ecfg, head=c1["head"]), cfg,
                                  "int8 KV, captured")
    del a["tokens"]
    out["a"] = a

    # (b) phase 9's on-demand cell on int8 pools: its page count, then its pool bytes
    od = chunked["on-demand"]
    pages9 = od["usable_pages"] + 1
    bytes9 = 2 * cfg.n_layers * pages9 * ecfg.page_size * D * 2  # bf16 K and V pools
    row8 = 2 * cfg.n_layers * ecfg.page_size * (D + 4)  # a page of int8 levels + float32 scales
    runs = {}
    for label, n_pages in (("same pages", pages9), ("same bytes", bytes9 // row8)):
        ecfg_b = dataclasses.replace(ecfg, chunk_tokens=CHUNK, admit="on-demand", n_pages=n_pages)
        eng = Engine(cfg8, c1["params"], ecfg_b, head=c1["head"])
        pool_bytes = sum(t.numel() * t.element_size() for t in eng.state.values())
        m, counts, wall = _serve(torch, eng, prompts, 32)
        check(m["statuses"] == {"ok": len(prompts)}, f"(b) {label}: statuses {m['statuses']}")
        check(counts == {k: v * m["steps"] for k, v in packed_step.items()},
              f"(b) {label}: launch counters {counts} != {packed_step} x {m['steps']} steps")
        eng.assert_no_leaks()
        census = check_graph(eng, packed_step, f"(b) {label}")
        _census_gathers(census, "gather_i8", cfg.n_layers, f"(b) {label}")
        eng.close()
        step_ms = [1e3 * x for x in eng.step_seconds]
        runs[label] = dict(pages=n_pages, pool_bytes=pool_bytes, steps=m["steps"], fed_tokens=m["fed_tokens"],
                           preemptions=m["preemptions"], tokens_per_s=m["tokens_per_s"],
                           step_ms_p50=float(np.median(step_ms)), ttft_ms_p50=1e3 * m["ttft_p50"],
                           wall_s=wall, counts=counts, graph=census)
        del eng
        torch.cuda.empty_cache()
    check(runs["same pages"]["preemptions"] > 0, "(b) the same-pages int8 run did not preempt")
    check(runs["same bytes"]["pool_bytes"] <= bytes9, "(b) the same-bytes int8 pools exceed phase 9's bytes")
    print(f"  (b) C={CHUNK} on demand, on {card.name} ({card.power_limit}):", flush=True)
    for label, r in (("bf16 KV (phase 9)", dict(od, pages=pages9, pool_bytes=bytes9)),
                     ("int8 KV, same pages", runs["same pages"]), ("int8 KV, same bytes", runs["same bytes"])):
        print(f"    {label:20s} pages {r['pages']:4d} ({r['pool_bytes'] / 1e9:.3f} GB), preemptions "
              f"{r['preemptions']:3d}, steps {r['steps']:3d}, fed {r['fed_tokens']:5d}, TTFT p50 "
              f"{r['ttft_ms_p50']:7.1f} ms, step p50 {r['step_ms_p50']:6.2f} ms, {r['tokens_per_s']:6.1f} tok/s",
              flush=True)
    out["b"] = dict(runs, phase9=dict(pages=pages9, pool_bytes=bytes9))

    # (c) the card against the CPU on int8 pools, phase 5's fixture and rules
    out["c"] = {}
    for gather in ("kernel", "xla"):
        print(f"  (c) card vs CPU on int8 KV pools, 2 layers, {gather} gather", flush=True)
        out["c"][gather] = phase_crosscheck(torch, cfg, kv_int8=True, gather=gather)
    torch.cuda.empty_cache()

    # (d) int8 serving weights, float head, bf16 pools, beside quant=None
    ecfg_d = dataclasses.replace(ecfg, packed_head=False)
    params = T.init_params(cfg, seed=0, device="cuda")
    t0 = time.monotonic()
    eng_q = build_engine(cfg, ecfg_d, params=params, quant="int8")
    torch.cuda.synchronize()
    t_quant = time.monotonic() - t0
    eng_f = build_engine(cfg, ecfg_d, params=params)
    q_params, f_params = eng_q.params, eng_f.params
    del eng_q, eng_f
    projs = [w["w"] for layer in q_params["layers"] for block in layer.values()
             for name, w in block.items() if name != "ln"]
    check(all(p["levels"].dtype == torch.int8 and p["scale"].dtype == torch.float32 for p in projs),
          "(d) a projection is not in the int8 serving layout")
    levels = sum(p["levels"].numel() for p in projs)
    scales = sum(p["scale"].numel() * 4 for p in projs)
    d, hd = cfg.d_model, cfg.hd
    widths = [cfg.n_heads * hd, cfg.kv_heads * hd, cfg.kv_heads * hd, d, cfg.d_ff, cfg.d_ff, d]
    depths = [d, d, d, cfg.n_heads * hd, d, d, cfg.d_ff]
    want_levels = cfg.n_layers * sum(k * n for k, n in zip(depths, widths))
    check(levels == want_levels and scales == 4 * cfg.n_layers * sum(widths),
          f"(d) int8 projection bytes on the card {levels} levels + {scales} scale bytes")
    print(f"  (d) quant=\"int8\" built in {t_quant:.1f} s: {levels / 1e9:.3f} G int8 levels + "
          f"{scales / 1e6:.2f} MB of float32 scales on the card", flush=True)
    gather_step = {**dict.fromkeys(build.COUNTS, 0), "paged_gather": cfg.n_layers}
    weights = {"int8 weights": q_params, "float": f_params}
    dd = _alternating_turns(
        torch, lambda cell: Engine(cfg, weights[cell], ecfg_d), prompts,
        {"int8 weights": (gather_step, "gather_fp", True), "float": (gather_step, "gather_fp", True)}, "(d)")
    _print_medians(card, dd["medians"], "(d)")
    same = sum(x == y for rid, v in dd["tokens"]["int8 weights"].items()
               for x, y in zip(v, dd["tokens"]["float"][rid]))
    n_tok = sum(len(v) for v in dd["tokens"]["float"].values())
    print(f"  (d) graph nodes: int8 weights {dd['census']['int8 weights']}, float {dd['census']['float']}; "
          f"tokens equal to quant=None's {same}/{n_tok} (not a gate)", flush=True)
    dd.update(levels=levels, scale_bytes=scales, quantize_s=t_quant, tokens_equal=same, tokens=n_tok)
    dd["profile"] = profile_engine(torch, Engine(cfg, q_params, ecfg_d), cfg, "int8 weights, captured")
    del dd["tokens"], weights, q_params, f_params, params
    torch.cuda.empty_cache()
    dd["crosscheck"] = _int8_weights_cross_check(torch, cfg)
    out["d"] = dd
    report["int8_serving"] = out
    return out


# -- phase 13 ------------------------------------------------------------------

# phase 13's lifecycle cell: the queue bound, and the terminal outcomes its
# schedule must give (status, and shed reasons or where a cancel found the
# request); times are in engine steps, the virtual clock's unit, and the
# realtime run (c) scales them by phase 4's step p50
LIFE_MAX_WAITING = 6
LIFE_OUTCOMES = ("ok", "cancelled while waiting", "cancelled mid-decode", "shed: ttft or infeasible",
                 "shed: deadline", "shed: queue-overflow")
SHED_REASONS = ("deadline", "ttft", "infeasible", "queue-overflow", "watchdog")
# (b): 16 requests in gangs of 8 slots, one straggler a gang
GANG_NEW = (48,) + (8,) * 7


def lifecycle_schedule(prompts4: list, vocab: int) -> list[dict]:
    """Phase 13's 20 requests: phase 4's 8 prompts with 32 new tokens each
    at step 0 (batch class), then 12 prompts of 16-64 tokens (seed 13) with
    16 new tokens each arriving over steps 5-60, most early (interactive,
    batch or no class in turn); one explicit deadline that falls
    mid-decode, one that cannot be met, a cancel mid-decode and one while
    waiting.  Each request is a dict
    of ``submit``'s arguments (``slo`` as ``(name, ttft budget, total
    budget)``, times in engine steps) and optionally ``cancel``:
    ``("tokens", k)`` when the request samples its k-th token, ``("step",
    n)`` at the first sample of any request from step n on."""
    import numpy as np

    interactive, batch = ("interactive", 30.0, 150.0), ("batch", None, 400.0)
    reqs = [dict(prompt=p, max_new=32, arrival=0.0, slo=batch) for p in prompts4]
    reqs[2]["cancel"] = ("tokens", 10)
    reqs[4]["deadline"] = 40.0  # its 24-token prompt decodes from step 24
    rng = np.random.default_rng(13)
    lens = rng.integers(16, 65, 12)
    arrivals = np.round(5 + 55 * np.linspace(0, 1, 12) ** 2)  # most of them early
    for i, (n, t) in enumerate(zip(lens, arrivals)):
        reqs.append(dict(prompt=rng.integers(0, vocab, int(n)).tolist(), max_new=16,
                         arrival=float(t), slo=(interactive, batch, None)[i % 3]))
    reqs[9]["cancel"] = ("step", 30)
    reqs[10]["deadline"] = reqs[10]["arrival"] + 30.0
    return reqs


def gang_schedule(vocab: int) -> list[dict]:
    """Phase 13 (b)'s 16 requests: prompts of 8-24 tokens (seed 14),
    ``GANG_NEW`` new tokens in each gang of 8, all at step 0."""
    import numpy as np

    rng = np.random.default_rng(14)
    return [dict(prompt=rng.integers(0, vocab, int(rng.integers(8, 25))).tolist(), max_new=g, arrival=0.0)
            for g in GANG_NEW * 2]


def serve_schedule(eng, reqs: list[dict], *, unit: float = 1.0, realtime: bool = False,
                   rows: dict | None = None, vocab: int | None = None):
    """Submit ``reqs`` to ``eng`` with every time scaled by ``unit``, arm
    their cancels on the engine's sample hook, and run it.  ``rows``
    collects every sampled logits row by (request id, token index);
    ``vocab`` folds the prompts into a smaller vocabulary (the CPU's smoke
    model).  Returns the metrics and the requests."""
    from repro_torch.serving import SLO

    def scale(x):
        return None if x is None else x * unit

    handles = []
    for r in reqs:
        slo = r.get("slo")
        if slo is not None:
            slo = SLO(slo[0], scale(slo[1]), scale(slo[2]))
        prompt = r["prompt"] if vocab is None else [t % vocab for t in r["prompt"]]
        handles.append(eng.submit(prompt, r["max_new"], r["arrival"] * unit,
                                  deadline=scale(r.get("deadline")), slo=slo))
    cancels = [(r["cancel"], h) for r, h in zip(reqs, handles) if "cancel" in r]

    def on_sample(rid, t, row):
        if rows is not None:
            rows[(rid, t)] = row.copy()
        for (kind, n), h in cancels:
            if not h.cancel_requested and (h.rid == rid and t + 1 == n if kind == "tokens"
                                           else eng.n_steps >= n):
                eng.cancel(h)

    eng.on_sample = on_sample
    m = eng.run(realtime=realtime)
    check_clean(eng, "the scheduled run")
    return m, handles


def decisions(m: dict, reqs) -> dict:
    """What the virtual clock makes a function of the schedule alone: per
    request its status, shed reason, token count, first-token and finish
    times; the run's steps."""
    return dict(steps=m["steps"], requests=[(r.rid, r.status, r.shed_reason, len(r.out_tokens),
                                             r.t_first_token, r.t_finish) for r in reqs])


def outcomes(reqs) -> dict:
    """How many requests of the schedule ended in each of ``LIFE_OUTCOMES``."""
    def kind(r):
        if r.status == "cancelled":
            if r.t_admit is None:
                return "cancelled while waiting"
            return "cancelled mid-decode" if r.out_tokens else "cancelled mid-prefill"
        if r.status == "shed":
            return ("shed: ttft or infeasible" if r.shed_reason in ("ttft", "infeasible")
                    else f"shed: {r.shed_reason}")
        return r.status

    out = dict.fromkeys(LIFE_OUTCOMES, 0)
    for k in map(kind, reqs):
        out[k] = out.get(k, 0) + 1
    return out


def lifecycle_cpu(torch, ecfg, prompts4: list) -> dict:
    """Phase 13's schedules on the CPU at the smoke size (the port's plain
    versions, phase 4's engine settings): (a)'s decisions and outcomes, and
    (b)'s steps under each policy."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, build_engine

    cfg = get_config("llama3.2-3b", smoke=True)
    packed = build_engine(cfg, ecfg, quant="packed", w_bits=4, a_bits=4, device="cpu")
    out = {}
    for label, reqs, e in [("a", lifecycle_schedule(prompts4, cfg.vocab),
                            dataclasses.replace(ecfg, max_waiting=LIFE_MAX_WAITING))] + [
            (policy, gang_schedule(cfg.vocab), dataclasses.replace(ecfg, policy=policy))
            for policy in ("continuous", "static")]:
        eng = Engine(cfg, packed.params, e, head=packed._head, device="cpu")
        m, handles = serve_schedule(eng, reqs, vocab=cfg.vocab)
        out[label] = dict(decisions=decisions(m, handles), outcomes=outcomes(handles),
                          statuses=m["statuses"])
    return out


def phase_lifecycle(torch, card, cfg, ecfg, c1: dict, fused: dict, report: dict) -> dict:
    """The request lifecycle at full width on phase 4's weights and engine
    settings, each engine's step one captured graph: (a) the lifecycle
    schedule on the virtual clock, its decisions against the CPU's at the
    smoke size, its rows against phase 4's, its census, counters and
    captures; (b) static gang admission against continuous batching, steps
    against the CPU's; (c) (a)'s schedule on the wall clock, scaled by phase
    4's step p50."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.serving import TERMINAL_STATUSES, Engine

    t0 = time.monotonic()
    cpu = lifecycle_cpu(torch, ecfg, c1["prompts"])
    steps_cpu = {k: v["decisions"]["steps"] for k, v in cpu.items()}
    print(f"  the CPU's runs at the smoke size ({time.monotonic() - t0:.1f} s): (a) {steps_cpu['a']} steps, "
          f"outcomes {cpu['a']['outcomes']}; (b) continuous {steps_cpu['continuous']}, static "
          f"{steps_cpu['static']} steps", flush=True)
    per_step = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": cfg.n_layers * 7 + 1,
                "paged_gather": cfg.n_layers}
    head = c1["head"]
    tie_bound = CHUNK_TIE_UNITS * head.w_scale / ((1 << head.a_bits) - 1)
    ecfg_a = dataclasses.replace(ecfg, max_waiting=LIFE_MAX_WAITING)
    reqs = lifecycle_schedule(c1["prompts"], cfg.vocab)
    out: dict = {}

    def serve(e, schedule, **kw):
        """A fresh engine on phase 4's weights: warmed up (captured), the
        counters set to 0, the schedule served, the counters read, its graph
        checked against them, then released."""
        eng = Engine(cfg, c1["params"], e, head=head)
        eng.warmup()
        torch.cuda.synchronize()
        build.reset_counts()
        t = time.monotonic()
        m, handles = serve_schedule(eng, schedule, **kw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        counts = build.counts()
        check(counts == {k: v * m["steps"] for k, v in per_step.items()},
              f"launch counters {counts} != {per_step} x {m['steps']} steps")
        census = check_graph(eng, per_step, "lifecycle")
        check(eng._program.captures == 1, f"the engine captured {eng._program.captures} graphs, not 1")
        eng.assert_no_leaks()
        eng.close()
        torch.cuda.empty_cache()
        return eng, m, handles, dict(wall_s=wall, counts=counts, graph=census)

    # (a) the deterministic cell
    rows = {}
    _, m, handles, run = serve(ecfg_a, reqs, rows=rows)
    dec, outc = decisions(m, handles), outcomes(handles)
    check(dec == cpu["a"]["decisions"], f"(a): decisions differ from the CPU's: {dec} against "
          f"{cpu['a']['decisions']}")
    check(all(outc[k] >= 1 for k in LIFE_OUTCOMES), f"(a): outcomes {outc} miss one of {LIFE_OUTCOMES}")
    compared = {r.rid: list(r.out_tokens) for r in handles
                if r.rid in c1["tokens"] and r.out_tokens and r.status in ("ok", "cancelled")}
    cmp = _against_c1(rows, compared, c1, tie_bound, prefix=True)
    identical = sum(rows[k].tobytes() == c1["samples"][k].tobytes()
                    for rid, toks in compared.items() for k in ((rid, t) for t in range(len(toks))))
    n_rows = sum(len(t) for t in compared.values())
    print(f"  (a) {m['steps']} steps, statuses {m['statuses']}, outcomes {outc}; decisions (status, shed "
          f"reason, tokens, first-token and finish steps of all 20, and the steps) equal the CPU's; launches "
          f"{run['counts']}; graph {run['graph']}; one capture, no leaks", flush=True)
    print(f"  (a) against phase 4: requests {sorted(compared)} ({n_rows} sampled rows): {identical} "
          f"bit-identical, {cmp['rows_clean']} within {CROSS_CLEAN_ABS_TOL}, rel L2 max {cmp['row_rel_max']:.3g}; "
          f"first token divergences {cmp['divergences']}", flush=True)
    check(cmp["passes"], f"(a): sampled rows or tokens outside phase 9's tolerances of phase 4's: {cmp}")
    out["a"] = dict(steps=m["steps"], statuses=m["statuses"], outcomes=outc, decisions=dec,
                    rows_compared=n_rows, rows_bit_identical=identical, against_phase4=cmp,
                    preemptions=m["preemptions"], **run)
    del rows

    # (b) static gang admission against continuous batching
    steps = {}
    for policy in ("continuous", "static"):
        _, m, handles, run = serve(dataclasses.replace(ecfg, policy=policy), gang_schedule(cfg.vocab))
        check(m["statuses"] == {"ok": 16}, f"(b) {policy}: statuses {m['statuses']}")
        check(decisions(m, handles) == cpu[policy]["decisions"], f"(b) {policy}: decisions differ from the CPU's")
        steps[policy] = m["steps"]
        out[policy] = dict(steps=m["steps"], **run)
    check(steps["static"] > steps["continuous"], f"(b): static took {steps['static']} steps, continuous "
          f"{steps['continuous']}")
    print(f"  (b) 16 requests, one straggler a gang of 8: continuous {steps['continuous']} steps, static "
          f"{steps['static']} (the CPU's: {steps_cpu['continuous']}, {steps_cpu['static']})", flush=True)

    # (c) (a)'s schedule on the wall clock
    unit = fused["step_ms_p50"] / 1e3
    eng, m, handles, run = serve(ecfg_a, reqs, unit=unit, realtime=True)
    step_s = eng.step_seconds
    p50, longest, ewma = float(np.median(step_s)), max(step_s), eng._step_time_ewma
    check(all(r.status in TERMINAL_STATUSES for r in handles), "(c): a request without a terminal status")
    check(all(r.shed_reason in SHED_REASONS for r in handles if r.status == "shed"),
          "(c): a shed reason outside the reference's set")
    late = [(r.rid, r.t_finish, r.deadline) for r in handles
            if r.status == "ok" and r.deadline is not None and r.t_finish > r.deadline + longest]
    check(not late, f"(c): ok requests finished past their deadline plus the longest step {longest}: {late}")
    check(0.5 * p50 <= ewma <= 2 * p50, f"(c): step-time EWMA {ewma} outside 0.5-2x the step p50 {p50}")
    goodput = m["generated_tokens_ok"] / m["wall"]
    out["c"] = dict(unit_s=unit, steps=m["steps"], statuses=m["statuses"], outcomes=outcomes(handles),
                    engine_wall_s=m["wall"], goodput_tok_s=goodput, tokens_per_s=m["tokens_per_s"],
                    ttft_ms_p50=1e3 * m["ttft_p50"], ttft_ms_p99=1e3 * m["ttft_p99"],
                    latency_ms_p50=1e3 * m["latency_p50"], step_ms_p50=1e3 * p50, step_ms_max=1e3 * longest,
                    ewma_ms=1e3 * ewma, decisions=decisions(m, handles), **run)
    c = out["c"]
    print(f"  (c) realtime, one step = {1e3 * unit:.2f} ms on {card.name} ({card.power_limit}): {m['steps']} "
          f"steps in {m['wall']:.2f} s, statuses {m['statuses']}, outcomes {c['outcomes']}; goodput "
          f"{goodput:.1f} ok tok/s ({m['tokens_per_s']:.1f} tok/s in all), TTFT p50 {c['ttft_ms_p50']:.1f} ms, "
          f"p99 {c['ttft_ms_p99']:.1f} ms; step p50 {c['step_ms_p50']:.2f} ms, max {c['step_ms_max']:.2f}, "
          f"EWMA {c['ewma_ms']:.2f} ms; decisions equal (a)'s: {c['decisions'] == dec}", flush=True)
    out["cpu"] = cpu
    report["lifecycle"] = out
    return out


# -- phase 14 ------------------------------------------------------------------

# phase 14's cell: gemma3-1b at full width ([hf:google/gemma-3-1b-pt]: 26
# layers, local:global 5:1 with a 1024-token window, d 1152, 4 heads and one
# KV head of width 256, geglu d_ff 6912, vocab 262144), nothing cut, past its
# window: 8 requests whose prompts (lengths drawn from seed 14) are all
# longer than the window, GEMMA_NEW new tokens each (_timed_turn's 32)
GEMMA_ARCH = "gemma3-1b"
GEMMA_PROMPTS = (1100, 1501)
GEMMA_MAX_LEN = 2048
GEMMA_NEW = 32
GEMMA_TRACE_STEPS = 10  # traced steps, every slot decoding
# (d): the card against the CPU at 2 layers of full width (both windowed),
# decode steps from position GEMMA_CROSS["pos0"] in pools of 96 blocks; the
# MLP projections float (see _geglu_flips: packed, every row flips levels)
GEMMA_CROSS = dict(steps=2, pos0=1500, blocks=96, packed_mlp=False)


def _recorded_run(torch, eng, prompts, trace: int = 0):
    """Serve ``prompts`` on ``eng`` untimed (the virtual clock): every
    sampled logits row, each request's tokens and each step's batch (its
    positions, valid lanes and block table).  With ``trace``, that many
    steps from the first at which every slot decodes run under the
    profiler (the sampling hook included).  The engine's graph is released
    after the run; its pools are kept."""
    from torch.profiler import ProfilerActivity, profile

    rows, batches = {}, []
    eng.on_sample = lambda rid, t, row: rows.__setitem__((rid, t), row.copy())
    run = eng._program.run

    def recording(tokens, pos, lens, table):
        batches.append((pos.copy(), lens.copy(), table.copy()))
        return run(tokens, pos, lens, table)

    eng._program.run = recording
    for p in prompts:
        eng.submit(p, GEMMA_NEW)
    summary = None
    if trace:
        first = max(-(-len(p) // eng.ecfg.chunk_tokens) for p in prompts)
        eng.run(realtime=False, max_steps=first)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            eng.run(realtime=False, max_steps=first + trace)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        check(all((b[1] == 1).all() for b in batches[first:]), "a traced step was not all decode")
        summary = trace_summary(prof, wall, trace, f"gemma3-1b decode steps {first}-{first + trace - 1}")
    eng.run(realtime=False)
    check_clean(eng, "the recorded run")
    eng.close()
    torch.cuda.empty_cache()
    return rows, {r.rid: list(r.out_tokens) for r in eng.finished}, batches, summary


def _window_drops(torch, win: int, pools, batches) -> dict:
    """At every step of a served run, the live keys that K3's mask at the
    window ``win`` drops against full causal (the engine's launch, chunk
    CHUNK, on the run's block table and positions), per valid lane: a
    decoding slot's count must be ``pos + 1 - win`` > 0 (its pages hold
    every earlier position), and no lane may keep a key that causal drops."""
    from repro_torch.kernels.paged_gather.kernel import paged_gather_raw

    decode, prefill = [], []
    for pos, lens, table in batches:
        t, p = torch.from_numpy(table).cuda(), torch.from_numpy(pos).cuda()
        m_win, m_all = (paged_gather_raw(t, p, w, *pools, chunk=CHUNK, out_dtype=torch.bfloat16)[2]
                        .flatten(2) for w in (win, 0))
        check(not bool((m_win & ~m_all).any()), "K3's window mask keeps a key its causal mask drops")
        dropped = (m_all & ~m_win).sum(-1).cpu().numpy()  # [S, CHUNK]
        for s, n in enumerate(lens.tolist()):
            if n == 1:
                check(dropped[s, 0] == pos[s] + 1 - win,
                      f"slot {s} at position {pos[s]}: K3's window drops {dropped[s, 0]} keys")
                decode.append(int(dropped[s, 0]))
            else:
                prefill.extend(int(d) for d in dropped[s, :n])
    check(len(decode) > 0 and min(decode) > 0, "a decoding slot's window dropped no live key")
    return dict(decode_slot_steps=len(decode), decode_min=min(decode), decode_max=max(decode),
                prefill_lanes=len(prefill), prefill_lanes_dropping=sum(d > 0 for d in prefill))


def _gemma_gather(torch, card, timer, win: int, pools: dict, batches) -> dict:
    """K3 against its plain version on the served run's pools (layer 0, a
    windowed one; bf16 from (a), int8 from (b)) and block tables: at the
    first step at which every slot decodes, window ``win`` and 0, chunk 1
    and CHUNK, timed by graph beside its bytes bound; at the last step at
    which every slot feeds a full chunk, bit-exact only."""
    from repro_torch.kernels.paged_gather.kernel import paged_gather_plain, paged_gather_raw

    decode = next(b for b in batches if (b[1] == 1).all())
    prefill = [b for b in batches if (b[1] == CHUNK).all()][-1]
    rows, max_err = [], 0.0
    for kind, ops in pools.items():
        scaled = len(ops) == 4
        # the timed launches cycle through copies of the layer's pools that
        # together pass 256 MB, so that each finds its pages in HBM, as a
        # step does (26 layers apart); the views it writes stay in L2, where
        # the attention reads them
        n_copies = max(1, min(100, -(-(256 << 20) // sum(o.numel() * o.element_size() for o in ops))))
        cold = [ops] + [tuple(o.clone() for o in ops) for _ in range(n_copies - 1)]
        for step, (pos, _, table) in (("decode", decode), ("prefill", prefill)):
            t, p = torch.from_numpy(table).cuda(), torch.from_numpy(pos).cuda()
            S, nb = table.shape
            _, ps, D = ops[0].shape
            n_live = int((table != 0).sum())
            for window, chunk in itertools.product((win, 0), (1, CHUNK)):
                if step == "prefill" and chunk == 1:
                    continue
                args, kw = (t, p, window, *ops), dict(chunk=chunk, out_dtype=torch.bfloat16)
                got, want = paged_gather_raw(*args, **kw), paged_gather_plain(*args, **kw)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    check(a.dtype == b.dtype and torch.equal(a, b),
                          f"K3 differs from its plain version: gemma {kind} pool, {step} step, window "
                          f"{window}, chunk {chunk}")
                    max_err = max(max_err, (a.float() - b.float()).abs().max().item())
                del got, want
                if step != "decode":
                    continue
                nbytes = gather_bytes(S, nb, ps, D, n_live, chunk, ops[0].element_size(), scaled)
                b_ms, b_by, _, _ = card.bound(nbytes, 0)
                tl = t.long()
                row = dict(pool=kind, window=window, chunk=chunk, S=S, n_blocks=nb, page_size=ps, D=D,
                           live_pages=n_live, min_pos=int(pos.min()), max_pos=int(pos.max()),
                           k3_ms=timer(lambda: paged_gather_raw(*args, **kw), reps=20),
                           k3_graph_ms=timer.graph(
                               lambda i: paged_gather_raw(t, p, window, *cold[i % len(cold)], **kw)),
                           k3_warm_graph_ms=timer.graph(lambda i: paged_gather_raw(*args, **kw)),
                           plain_ms=timer(lambda: paged_gather_plain(*args, **kw), reps=10),
                           library_graph_ms=timer.graph(lambda i: tuple(q[tl] for q in cold[i % len(cold)][:2])),
                           bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
                if scaled:  # the same function: the gather, then paged_gather_plain's dequantization
                    row["dequant_graph_ms"] = timer.graph(lambda i: tuple(
                        q[tl].to(torch.bfloat16) * s[tl].to(torch.bfloat16)
                        for q, s in zip(cold[i % len(cold)][:2], cold[i % len(cold)][2:])))
                row["fraction_of_bound"] = b_ms / row["k3_graph_ms"]
                rows.append(row)
                lib = f", gather + dequantize {row['dequant_graph_ms']:.4f}" if scaled else ""
                print(f"  (c) {kind} pool, window {window}, chunk {chunk}: K3 {row['k3_graph_ms']:.4f} ms by "
                      f"graph ({100 * row['fraction_of_bound']:.0f} % of its {b_ms:.4f} ms bound; pools in L2 "
                      f"{row['k3_warm_graph_ms']:.4f}; events {row['k3_ms']:.4f}), plain "
                      f"{row['plain_ms']:.3f} ms, pool[table] "
                      f"{row['library_graph_ms']:.4f}{lib}; bit-exact", flush=True)
        del cold
    return dict(rows=rows, max_err=max_err, live_pages=rows[0]["live_pages"],
                positions=(rows[0]["min_pos"], rows[0]["max_pos"]))


def _geglu_flips(torch, cfg) -> dict:
    """Not a gate: why (d) keeps the MLP projections float.  Layer 0's
    packed geglu MLP at full width, float32, from the same 8 input rows and
    packed words on the card and on the CPU: up and gate (integer products
    dequantized) must be bit-identical; then the 4-bit levels of w_down's
    input, ``sigmoid(gelu(gate) * up)``, that differ in each row, with
    gelu in float32 on each device (the port's) and in float64 on both."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving.api import quantize_params_packed

    cfg1 = dataclasses.replace(cfg, n_layers=1, dtype=torch.float32)
    packed = quantize_params_packed(T.init_params(cfg1, seed=1, device="cuda"), w_bits=4, a_bits=4, device="cuda")
    mlp = {"cuda": T.layer_params(packed["layers"], 0)["mlp"]}
    mlp["cpu"] = T.map_leaves(mlp["cuda"], lambda a: a.to("cpu"))
    x = torch.randn((8, 1, cfg.d_model), generator=torch.Generator().manual_seed(3))
    side = {}
    for dev, p in mlp.items():
        h = L.rmsnorm(p["ln"], x.to(dev))
        up, gate = L.dense(p["w_up"], h), L.dense(p["w_gate"], h)
        side[dev] = dict(up=up, gate=gate, act32=F.gelu(gate, approximate="tanh") * up,
                         act64=F.gelu(gate.double(), approximate="tanh").float() * up)
    check(all(torch.equal(side["cuda"][k].cpu(), side["cpu"][k]) for k in ("up", "gate")),
          "(d) reading: up or gate differ between the card and the CPU")
    out = {}
    for k in ("act32", "act64"):
        lv = {dev: torch.round(torch.clamp(torch.sigmoid(v[k]), 0, 1) * 15).cpu() for dev, v in side.items()}
        out[k] = dict(values_differ=int((side["cuda"][k].cpu() != side["cpu"][k]).sum()),
                      level_flips_by_row=(lv["cuda"] != lv["cpu"]).reshape(8, -1).sum(dim=1).tolist())
    return out


def phase_gemma(torch, card, report: dict) -> dict:
    """gemma3-1b served at full width past its 1024-token window, w4a4
    projections, the packed (4, 4) head and the kernel gather, 8 slots,
    page 16, ``max_len`` GEMMA_MAX_LEN (128 blocks a slot), chunked prefill
    (C = 16), reserve admission, random weights from seed 0; every decode
    position and the later prefill chunks lie past the window of the 21
    windowed layers.  First, K1 at the engine's per-step shapes (the layers
    at 128 rows, the head at 8) against its plain version, timed.
    (a) The serve, its step one captured graph: every request ``ok``, one
    capture, no leaks, launch counters and graph nodes 26 x 7 + 1 K1 and
    26 K3 a step; an untimed repeat records every sampled row, each step's
    batch, and a trace of decode steps.  (b) The same on int8 KV pools:
    rows and tokens read against (a)'s (not a gate).  (c) K3 on (a)'s and
    (b)'s pools and block tables against its plain version, bit-exact,
    timed; the live keys the window drops, counted at every step of (a).
    (d) The card against the CPU from the same packed words with phase 5's
    rules, at 2 layers (both windowed) and 8 slots, GEMMA_CROSS's steps
    from position 1500 (rows before it random and equal on both sides), and
    a planted fault those rules must reject: the CPU side with
    ``window_pattern=(0,)`` (one decode step).  Cuts in (d) only: 2 of 26
    layers; 8 slots of 96 blocks; the earlier rows random rather than
    served; the MLP projections float, not packed (packed, the gelu's last
    float32 bit, which differs between the card and the CPU, flips w_down
    input levels in every row, past phase 5's flip budget:
    :func:`_geglu_flips` prints it), so the packed ones are the attention
    projections and the head."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import layers as L
    from repro_torch.serving import Engine, EngineConfig, build_engine

    t_phase = time.monotonic()
    cfg = get_config(GEMMA_ARCH)
    win = max(cfg.windows())
    check(sorted(set(cfg.windows())) == [0, 1024], f"gemma windows {cfg.windows()}")
    ecfg = EngineConfig(n_slots=8, page_size=16, max_len=GEMMA_MAX_LEN, chunk_tokens=CHUNK, admit="reserve",
                        packed_head=True, head_bits=(4, 4), gather_backend="kernel")
    rng = np.random.default_rng(14)
    lengths = rng.integers(*GEMMA_PROMPTS, size=ecfg.n_slots)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist() for n in lengths]
    print(f"  {ecfg.n_slots} prompts of {sorted(lengths.tolist())} tokens (window {win}), "
          f"{GEMMA_NEW} new tokens each; {ecfg.blocks_per_slot} blocks a slot", flush=True)
    per_step = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": cfg.n_layers * 7 + 1,
                "paged_gather": cfg.n_layers}
    out: dict = {}

    print(f"  K1 at the engine's per-step shapes (the layers at M = {ecfg.n_slots * CHUNK}, the head at "
          f"M = {ecfg.n_slots}):", flush=True)
    timer = Timer(torch)
    out["k1"] = phase_matmul_chunk(torch, card, timer, cfg, ecfg.n_slots * CHUNK, report, key="gemma_matmul",
                                   head_m=ecfg.n_slots)
    torch.cuda.empty_cache()

    # (a) the serve
    t0 = time.monotonic()
    eng = build_engine(cfg, ecfg, quant="packed", w_bits=4, a_bits=4, seed=0)
    torch.cuda.synchronize()
    t_build = time.monotonic() - t0
    pool_gb = sum(x.numel() * x.element_size() for x in eng.state.values()) / 1e9
    params, head = eng.params, eng._head
    a = _timed_turn(torch, eng, prompts, per_step, "(a)", memset=False)
    _census_gathers(a["graph"], "gather_fp", cfg.n_layers, "(a)")
    check(all(len(t) == GEMMA_NEW for t in a["tokens"].values()), "(a): a request ended short")
    check(eng._program.captures == 1, f"(a): {eng._program.captures} captures")
    eng.assert_no_leaks()
    del eng
    a.update(build_s=t_build, kv_pool_gb=pool_gb)
    print(f"  (a) built in {t_build:.1f} s, bf16 KV pools {pool_gb:.3f} GB; {a['steps']} steps, "
          f"{a['tokens_per_s']:.1f} tok/s, step p50 {a['step_ms_p50']:.2f} ms (min {a['step_ms_min']:.2f}), "
          f"one replay {a['replay_ms']:.2f} ms, TTFT p50 {a['ttft_ms_p50']:.1f} ms; launches {a['counts']}; "
          f"graph nodes {a['graph']}; one capture, no leaks", flush=True)
    eng_a = Engine(cfg, params, ecfg, head=head)
    rows_a, toks_a, batches, a["profile"] = _recorded_run(torch, eng_a, prompts, trace=GEMMA_TRACE_STEPS)
    check(toks_a == a["tokens"], "(a): the sampled (untimed) run gave other tokens than the timed run")
    out["a"] = a

    # (b) int8 KV pools
    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    b = _timed_turn(torch, Engine(cfg8, params, ecfg, head=head), prompts, per_step, "(b)", memset=False)
    _census_gathers(b["graph"], "gather_i8", cfg.n_layers, "(b)")
    eng_b = Engine(cfg8, params, ecfg, head=head)
    rows_b, toks_b, batches_b, _ = _recorded_run(torch, eng_b, prompts)
    check(toks_b == b["tokens"], "(b): the sampled (untimed) run gave other tokens than the timed run")
    check(len(batches_b) == len(batches) and all(
        all(np.array_equal(x, y) for x, y in zip(p, q)) for p, q in zip(batches, batches_b)),
        "(b): the int8 run's batches differ from (a)'s")
    rel = [float(np.linalg.norm(rows_b[k] - rows_a[k]) / np.linalg.norm(rows_a[k])) for k in rows_a]
    same = sum(x == y for rid in toks_a for x, y in zip(toks_a[rid], toks_b[rid]))
    b.update(rows_rel_l2=dict(p50=float(np.median(rel)), max=max(rel), min=min(rel)), tokens_equal=same,
             n_tokens=sum(map(len, toks_a.values())))
    print(f"  (b) int8 KV: {b['steps']} steps, {b['tokens_per_s']:.1f} tok/s, step p50 {b['step_ms_p50']:.2f} "
          f"ms, one replay {b['replay_ms']:.2f} ms, TTFT p50 {b['ttft_ms_p50']:.1f} ms; graph nodes "
          f"{b['graph']}; sampled rows against (a)'s (not a gate): rel L2 p50 {np.median(rel):.4g}, max "
          f"{max(rel):.4g}; tokens equal {same}/{b['n_tokens']}", flush=True)
    del rows_a, rows_b
    out["b"] = b

    # (c) K3 on the served pools, and the keys the window drops
    layer0 = {"bf16": (eng_a.state["k"][0], eng_a.state["v"][0]),
              "int8": tuple(eng_b.state[k][0] for k in ("k", "v", "k_scale", "v_scale"))}
    drops = _window_drops(torch, win, layer0["bf16"], batches)
    print(f"  (c) window {win} in a windowed layer, over (a)'s {len(batches)} steps: every one of "
          f"{drops['decode_slot_steps']} decoding slot-steps drops {drops['decode_min']}-{drops['decode_max']} "
          f"live keys; {drops['prefill_lanes_dropping']} of {drops['prefill_lanes']} prefill lanes drop some",
          flush=True)
    c = _gemma_gather(torch, card, timer, win, layer0, batches)
    c["window_drops"] = drops
    out["c"] = c
    del eng_a, eng_b, layer0, batches, batches_b, timer
    torch.cuda.empty_cache()

    # (d) the card against the CPU past the window, and the planted fault
    print(f"  (d) card vs CPU, 2 layers of gemma3-1b at full width (windows {cfg.windows()[:2]}), "
          f"positions from {GEMMA_CROSS['pos0']}", flush=True)
    t0 = time.monotonic()
    out["d"] = phase_crosscheck(torch, cfg, **GEMMA_CROSS)
    t_d = time.monotonic() - t0
    inner = L.packed_dense
    print("  (d) planted fault: the CPU side with window_pattern=(0,)", flush=True)
    try:
        phase_crosscheck(torch, cfg, **dict(GEMMA_CROSS, steps=1), chunk_step=False, cpu_window_pattern=(0,))
        fault = None
    except PhaseError as e:
        fault = str(e)
    check(L.packed_dense is inner, "(d): the planted fault's run left packed_dense patched")
    check(fault is not None and fault.startswith("cross-check"),
          "(d): phase 5's rules pass the CPU side run without the window")
    print(f"  (d) {t_d:.1f} s; the planted fault was rejected: {fault}", flush=True)
    out["d_fault"] = fault
    out["geglu_flips"] = _geglu_flips(torch, cfg)
    print(f"  (d) reading, not a gate: layer 0's packed geglu MLP on the card and the CPU from the same rows: "
          f"up and gate bit-identical; w_down input levels that differ by row, gelu in float32 "
          f"{out['geglu_flips']['act32']}, gelu in float64 {out['geglu_flips']['act64']}", flush=True)
    out["phase_s"] = time.monotonic() - t_phase
    print(f"  phase 14 on {card.name} ({card.power_limit}): {out['phase_s']:.1f} s", flush=True)
    report["gemma"] = out
    return out


# -- phase 15 ------------------------------------------------------------------

# phase 15's cell: mamba2-130m at full width (the reference's config,
# [arXiv:2405.21060]: 24 layers, d 768, d_inner 1536, 24 heads of 64, state
# 128, conv width 4, vocab 50432), nothing cut: 16 slots, page 16, max_len
# 2048, C = 16, on demand; 16 prompts of 512-1536 tokens (lengths drawn from
# seed 15), MAMBA_NEW new tokens each.  Beside it the same engine at C = 1
# on 16 prompts of 64-128 tokens.
MAMBA_ARCH = "mamba2-130m"
MAMBA_SLOTS = 16
MAMBA_PROMPTS = (512, 1537)
MAMBA_SHORT_PROMPTS = (64, 129)
MAMBA_NEW = 64
# the traced short runs, (prompt tokens, new tokens) a request: at C = 16 one
# step (all 16 lanes run whether they prefill or decode; about 30,000 kernel
# events, which the profiler takes some 5 s to read), at C = 1 three
MAMBA_TRACE = {"C=16": (16, 1), "C=1": (2, 2)}
# (c): 16 prompts of 2-8 tokens, 32 new each, C = 16 on demand in pages of 4
# rows, the pool at half the summed worst case.  Small pages make a request
# preempted a few tokens into its run, so that its replay is short: the
# state a skipped reset leaves decays by about exp(-0.8) a token in the
# slowest head and has left no bit in a row 20-odd tokens later.
MAMBA_PREEMPT = dict(prompts=(2, 9), new=32, page_size=4, max_len=256, share=0.5, min_preemptions=8)
# (d): the card against the CPU at 2 layers of full width, float32, 8 slots:
# two decode steps, phase 5's chunked step, slots 3 and 4 re-admitted (their
# states zeroed), and a chunked step in which they feed 1 and 2 lanes.
# Float projections: rows and the states after the run within
# MAMBA_CROSS_REL_TOL relative L2 (cuBLAS and the CPU sum in other orders);
# w4a4 projections and the packed (4, 4) head: phase 5's rules.
MAMBA_CROSS_RESET = (3, 4)
MAMBA_REFEED_LENS = (0, 1, 1, 1, 2, 1, 1, 0)
MAMBA_CROSS_REL_TOL = 1e-4


def mamba_matmul_shapes(cfg, chunk: int) -> dict[str, tuple[int, int, int]]:
    """name -> (K, N, launches per step) for every packed matmul of a
    mamba step of ``chunk`` lanes (each lane runs every layer's three)."""
    s = cfg.ssm_spec()
    n = cfg.n_layers * chunk
    return {"in_z": (cfg.d_model, s.d_inner, n), "in_xbc": (cfg.d_model, s.d_inner + 2 * s.d_state, n),
            "out_proj": (s.d_inner, cfg.d_model, n), "head": (cfg.d_model, cfg.vocab, 1)}


def mamba_step_bound(eng) -> dict:
    """The least bytes, and time at HBM_BYTES_PER_S, of one served mamba
    step: every weight read once (the layers' packed words and float
    leaves, the packed head) and the recurrent state read and written once
    (the step's function), or once a lane (the chunk loop as the reference
    writes it, each lane's state update reading and writing all of it)."""
    from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
    from repro_torch.models import transformer as T

    def nbytes(t):
        return t.data.numel() * t.data.element_size() if isinstance(t, PackedDenseParams) else (
            t.numel() * t.element_size())

    weights = []
    T.map_leaves(eng.params["layers"], lambda a: weights.append(nbytes(a)))
    weights = sum(weights) + nbytes(eng._head)
    state = sum(nbytes(t) for t in eng.state.values())
    C = eng.ecfg.chunk_tokens
    once, lanes = weights + 2 * state, weights + 2 * state * C
    return dict(weights_bytes=weights, state_bytes=state, bytes_once=once, bytes_lanes=lanes,
                bound_ms_once=once / HBM_BYTES_PER_S * 1e3, bound_ms_lanes=lanes / HBM_BYTES_PER_S * 1e3)


def _sampled_serve(torch, eng, prompts, max_new: int, skip_readmit_reset: bool = False,
                   keep: bool = False) -> dict:
    """Serve ``prompts`` on a captured engine (fresh, or one whose earlier
    run has ended), untimed (the virtual clock), keeping every sampled row
    by (request index in ``prompts``, token); the slots its admissions
    reset, and with ``skip_readmit_reset`` (a planted fault) a request's
    re-admissions keep the state their slot holds.  The engine is released
    after, unless ``keep``."""
    rows, resets, seen = {}, [], set()
    rid0, steps0, fed0, pre0 = eng._next_rid, eng.n_steps, eng.fed_tokens, eng.scheduler.n_preemptions
    eng.on_sample = lambda rid, t, row: rows.__setitem__((rid - rid0, t), row.copy())
    reset = eng._reset_slot

    def counted(slot):
        rid = next(r.rid for r in eng.scheduler.active.values() if r.slot == slot)
        resets.append(slot)
        if not (skip_readmit_reset and rid in seen):
            reset(slot)
        seen.add(rid)

    eng._reset_slot = counted
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run(realtime=False)
    eng._reset_slot = reset
    check(all(r.status == "ok" for r in reqs), f"statuses {[r.status for r in reqs]}")
    check_clean(eng, "the sampled run")
    eng.assert_no_leaks()
    captures = eng._program.captures
    if not keep:
        eng.close()
        torch.cuda.empty_cache()
    return dict(rows=rows, steps=eng.n_steps - steps0, preemptions=eng.scheduler.n_preemptions - pre0,
                fed_tokens=eng.fed_tokens - fed0, resets=len(resets), captures=captures,
                tokens={r.rid - rid0: list(r.out_tokens) for r in reqs})


def _rows_differ(a: dict, b: dict) -> list:
    """The (request, token) keys whose rows are not bit-identical."""
    check(a.keys() == b.keys(), "the runs sampled different (request, token) rows")
    return [k for k in a if a[k].tobytes() != b[k].tobytes()]


def _mamba_cross(torch, cfg, packed: bool, skip_reset: bool = False) -> dict:
    """(d): the card against the CPU at 2 layers of full width, float32, on
    the same weights (seed 1; ``packed``: w4a4 projections and the packed
    (4, 4) head, else float projections and the tied float head), 8 slots:
    two decode steps, a chunked step (lens ``CROSS_CHUNK_LENS``), the
    states of slots ``MAMBA_CROSS_RESET`` zeroed (a re-admission), and a
    chunked step (lens ``MAMBA_REFEED_LENS``).  Float: every row and the
    states after the run within MAMBA_CROSS_REL_TOL relative L2.  Packed:
    phase 5's rules on the activation levels every packed matmul
    quantizes (a zeroed slot carries no earlier flip).  ``skip_reset``
    plants a fault: the card keeps slot 3's state at the re-admission."""
    import numpy as np

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving.api import quantize_params_packed

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = T.init_params(cfg2, seed=1, device="cuda")
    head = None
    if packed:
        head = L.prepack_lm_head(params["embed"], w_bits=4, a_bits=4, device="cuda")
        params = quantize_params_packed(params, w_bits=4, a_bits=4, device="cuda")
    sides = {"cuda": (params, head),
             "cpu": (T.map_leaves(params, lambda a: a.to("cpu")), None if head is None else head.to("cpu"))}
    S = CROSS_SLOTS
    states = {dev: T.init_paged_state(cfg2, S, 1, 16, dtype=torch.float32, device=dev) for dev in sides}
    table = torch.zeros((S, 1), dtype=torch.int32)  # the SSM family reads no block table
    plan = [(1, None)] * 2 + [(CHUNK, CROSS_CHUNK_LENS), None, (CHUNK, MAMBA_REFEED_LENS)]
    rng = np.random.default_rng(5)
    levels: list = []
    inner = L.packed_dense

    def recording(x, w, **kw):
        n = (1 << w.a_bits) - 1
        levels.append(torch.round(torch.clamp(x.float(), 0.0, 1.0) * n).to(torch.int16).cpu())
        return inner(x, w, **kw)

    flipped = torch.zeros(S, dtype=torch.bool)
    steps = []
    L.packed_dense = recording
    try:
        for item in plan:
            if item is None:  # re-admission: the slots' states zeroed between steps
                for slot in MAMBA_CROSS_RESET:
                    T.reset_paged_slot(cfg2, states["cpu"], slot)
                    if not (skip_reset and slot == MAMBA_CROSS_RESET[0]):
                        T.reset_paged_slot(cfg2, states["cuda"], slot)
                    flipped[slot] = False
                continue
            C, lens = item
            tokens = torch.from_numpy(rng.integers(0, cfg2.vocab, (S, C)).astype(np.int32))
            tlens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
            read = torch.ones((S, C), dtype=torch.bool)
            if lens is not None:
                read = torch.arange(C)[None] < torch.clamp(tlens, min=1)[:, None]
            logs, lv = {}, {}
            for dev, (p, h) in sides.items():
                levels.clear()
                lg, _ = T.forward_decode_paged(p, cfg2, states[dev], table.to(dev), tokens.to(dev),
                                               torch.zeros(S, dtype=torch.int32, device=dev), head=h,
                                               lens=None if tlens is None else tlens.to(dev))
                logs[dev], lv[dev] = lg.cpu(), list(levels)
            n_calls = 3 * cfg2.n_layers * C + 1 if packed else 0
            check(len(lv["cuda"]) == len(lv["cpu"]) == n_calls, f"(d): {len(lv['cuda'])} packed matmuls")
            row_flip = torch.zeros((S, C), dtype=torch.bool)
            for i, (g, c) in enumerate(zip(lv["cuda"][:-1], lv["cpu"][:-1])):
                row_flip[:, (i // 3) % C] |= (g != c).any(dim=1)  # 3 a layer and lane, lanes inner
            row_flip &= read
            head_flip = ((lv["cuda"][-1] != lv["cpu"][-1]).any(dim=1) if packed
                         else torch.zeros(S, dtype=torch.bool))
            prior = flipped.clone()
            flipped |= row_flip.any(dim=1) | head_flip
            g_log, c_log = logs["cuda"], logs["cpu"]
            check(bool(torch.isfinite(g_log).all()), "(d): non-finite logits on the card")
            st = _row_stats(torch, g_log, c_log, flipped)
            first_hand, fresh, _ = _first_hand(prior, read, row_flip, head_flip)
            what = f"(d) {'w4a4' if packed else 'float'} step {len(steps)} (C={C}, lens {lens})"
            r = dict(step=len(steps), chunk=C, lens=lens, rows_flipped=row_flip.sum(dim=1).tolist(),
                     first_hand_rows=first_hand, first_hand_flips=fresh, **st["summary"])
            steps.append(r)
            if not packed:
                check(bool((st["row_rel"] <= MAMBA_CROSS_REL_TOL).all()),
                      f"{what}: a row differs by {float(st['row_rel'].max()):.3g} relative L2, past "
                      f"{MAMBA_CROSS_REL_TOL}")
                continue
            clean = st["clean"]
            check(bool((st["row_max"][clean] <= CROSS_CLEAN_ABS_TOL).all()),
                  f"{what}: a row without level flips differs by more than {CROSS_CLEAN_ABS_TOL}")
            check(bool((st["row_rel"][flipped] <= CROSS_FLIP_REL_TOL).all()),
                  f"{what}: a row with level flips differs by more than {CROSS_FLIP_REL_TOL} relative")
            check(bool((st["agree"] | ~st["decided"] | flipped).all()),
                  f"{what}: greedy token differs past the gap bound")
            if C == 1:
                check(int(clean.sum()) >= S // 2, f"{what}: level flips in most rows")
            else:
                check(2 * fresh <= first_hand, f"{what}: level flips in most first-hand rows")
    finally:
        L.packed_dense = inner
    state_rel = {k: float(torch.linalg.vector_norm(states["cuda"][k].cpu() - states["cpu"][k])
                          / torch.linalg.vector_norm(states["cpu"][k])) for k in states["cpu"]}
    if not packed:
        check(all(v <= MAMBA_CROSS_REL_TOL for v in state_rel.values()),
              f"(d) float: the states after the run differ by {state_rel} relative L2, past {MAMBA_CROSS_REL_TOL}")
    return dict(steps=steps, state_rel_l2=state_rel)


def phase_mamba(torch, card, report: dict) -> dict:
    """mamba2-130m at full width, the SSM family's serving path: w4a4
    projections (``in_z``, ``in_xbc``, ``out_proj``; ``in_dt`` float) and
    the packed (4, 4) head, random weights from seed 0, no K/V pool and no
    K3; the recurrent state written in place by the captured step and
    zeroed per slot on (re-)admission, between steps.  (a) K1 at the four
    shapes at M = 16, bit-exact against its plain version, timed by graph
    beside its bound and ``_int_mm``.  (b) The serve at C = 16 (16 slots,
    16 prompts of 512-1536 tokens, MAMBA_NEW new) and at C = 1 (16 prompts
    of 64-128 tokens): every request ``ok``, one capture, no leaks, launch
    counters and graph nodes 3 x 24 K1 a lane and the head a step; step
    p50, one replay's device time, tok/s, TTFT, the step's bytes bound;
    each traced on a short run.  (c) MAMBA_PREEMPT's requests with forced
    preemptions against the same requests with none: every sampled row
    bit-identical; with the reset skipped on re-admission (a planted
    fault) some row must differ.  (d) The card against the CPU at 2
    layers (:func:`_mamba_cross`), float and w4a4, and the planted fault
    on the float run, which must fail."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.serving import Engine, EngineConfig, build_engine

    t_phase = time.monotonic()
    cfg = get_config(MAMBA_ARCH)
    s = cfg.ssm_spec()
    check((cfg.n_layers, cfg.d_model, s.d_inner, s.n_heads, s.head_dim, s.d_state, s.conv_width, cfg.vocab)
          == (24, 768, 1536, 24, 64, 128, 4, 50432), f"mamba2-130m's config {cfg}")
    ecfg = EngineConfig(n_slots=MAMBA_SLOTS, page_size=16, max_len=2048, chunk_tokens=CHUNK, admit="on-demand",
                        packed_head=True, head_bits=(4, 4))
    ecfg1 = dataclasses.replace(ecfg, chunk_tokens=1)
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist() for n in rng.integers(*MAMBA_PROMPTS, size=MAMBA_SLOTS)]
    short = [rng.integers(0, cfg.vocab, int(n)).tolist()
             for n in rng.integers(*MAMBA_SHORT_PROMPTS, size=MAMBA_SLOTS)]
    out: dict = {}

    # (a) K1 at the step's shapes, the head included, all at M = 16
    print(f"  (a) K1 at mamba2-130m's shapes, M = {ecfg.n_slots}:", flush=True)
    t0 = time.monotonic()
    timer = Timer(torch)
    out["k1"] = phase_matmul_chunk(torch, card, timer, cfg, ecfg.n_slots, report, key="mamba_matmul",
                                   head_m=ecfg.n_slots, shapes=mamba_matmul_shapes(cfg, CHUNK))
    del timer
    out["k1"]["phase_s"] = time.monotonic() - t0
    torch.cuda.empty_cache()

    # (b) the serves, C = 16 and C = 1
    t0 = time.monotonic()
    eng = build_engine(cfg, ecfg, quant="packed", w_bits=4, a_bits=4, seed=0)
    torch.cuda.synchronize()
    t_build = time.monotonic() - t0
    params, head = eng.params, eng._head
    state_gb = {k: v.numel() * v.element_size() / 1e9 for k, v in eng.state.items()}
    per_step = {}
    for label, e, ps, c in (("C=16", ecfg, prompts, CHUNK), ("C=1", ecfg1, short, 1)):
        per_step[label] = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": 3 * cfg.n_layers * c + 1}
        if label != "C=16":
            eng = Engine(cfg, params, e, head=head)
        bound = mamba_step_bound(eng)
        t0 = time.monotonic()
        r = _timed_turn(torch, eng, ps, per_step[label], f"(b) {label}", memset=True, max_new=MAMBA_NEW,
                        keep=True)
        check(all(len(t) == MAMBA_NEW for t in r["tokens"].values()), f"(b) {label}: a request ended short")
        check(r["preemptions"] == 0, f"(b) {label}: {r['preemptions']} preemptions")
        eng.assert_no_leaks()
        r.update(bound, prompt_tokens=sum(map(len, ps)), serve_s=time.monotonic() - t0)
        # the trace: a short run on the same graph
        prompt_len, new = MAMBA_TRACE[label]
        r["profile"] = profile_engine(torch, eng, cfg, f"mamba2-130m {label}, captured",
                                      n_requests=MAMBA_SLOTS, max_new=new, prompt_len=prompt_len)
        check(eng._program.captures == 1, f"(b) {label}: {eng._program.captures} captures")
        r["phase_s"] = time.monotonic() - t0
        out[label] = r
        print(f"  (b) {label}: {len(ps)} prompts of {min(map(len, ps))}-{max(map(len, ps))} tokens, "
              f"{MAMBA_NEW} new: {r['steps']} steps, {r['tokens_per_s']:.1f} tok/s, step p50 "
              f"{r['step_ms_p50']:.2f} ms (min {r['step_ms_min']:.2f}), one replay {r['replay_ms']:.2f} ms, "
              f"TTFT p50 {r['ttft_ms_p50']:.1f} ms; launches {r['counts']}; graph nodes {r['graph']}; step "
              f"bound {bound['bound_ms_lanes']:.3f} ms with the state read and written a lane "
              f"({bound['bytes_lanes'] / 1e9:.2f} GB), {bound['bound_ms_once']:.3f} ms once "
              f"({bound['bytes_once'] / 1e9:.3f} GB); one capture, no leaks; {r['phase_s']:.1f} s with the "
              f"trace", flush=True)
    del eng
    out["b"] = dict(build_s=t_build, state_gb=state_gb)
    print(f"  (b) built in {t_build:.1f} s; state {state_gb} GB", flush=True)

    # (c) forced preemption against none, and the skipped reset
    t0 = time.monotonic()
    P = MAMBA_PREEMPT
    rng = np.random.default_rng(16)
    c_prompts = [rng.integers(0, cfg.vocab, int(n)).tolist() for n in rng.integers(*P["prompts"], size=MAMBA_SLOTS)]
    ecfg_c = dataclasses.replace(ecfg, page_size=P["page_size"], max_len=P["max_len"])
    worst = sum(-(-(len(p) + P["new"]) // P["page_size"]) for p in c_prompts)
    n_pages = int(P["share"] * worst) + 1
    runs = {"twin": _sampled_serve(torch, Engine(cfg, params, ecfg_c, head=head), c_prompts, P["new"])}
    # the preempted run and the planted fault, one after the other on one engine (one capture)
    eng_c = Engine(cfg, params, dataclasses.replace(ecfg_c, n_pages=n_pages), head=head)
    runs["preempted"] = _sampled_serve(torch, eng_c, c_prompts, P["new"], keep=True)
    runs["fault"] = _sampled_serve(torch, eng_c, c_prompts, P["new"], skip_readmit_reset=True)
    del eng_c
    twin, pre, fault = runs["twin"], runs["preempted"], runs["fault"]
    check(twin["preemptions"] == 0, f"(c): the twin preempted {twin['preemptions']} times")
    check(pre["preemptions"] >= P["min_preemptions"],
          f"(c): {pre['preemptions']} preemptions, fewer than {P['min_preemptions']}")
    check(all(r["captures"] == 1 for r in runs.values()), "(c): an engine captured more than once")
    check(pre["resets"] == MAMBA_SLOTS + pre["preemptions"], f"(c): {pre['resets']} resets")
    differ = _rows_differ(twin["rows"], pre["rows"])
    check(not differ and pre["tokens"] == twin["tokens"],
          f"(c): {len(differ)} of {len(twin['rows'])} sampled rows differ from the unpreempted twin's")
    fault_differ = _rows_differ(twin["rows"], fault["rows"])
    check(len(fault_differ) > 0, "(c): the run with the reset skipped on re-admission equals the twin")
    worst_fault = max(float(np.abs(fault["rows"][k] - twin["rows"][k]).max()) for k in fault_differ)
    out["c"] = dict(pages=n_pages, worst_case_pages=worst, rows=len(twin["rows"]),
                    fault_rows_differ=len(fault_differ), fault_max_abs=worst_fault,
                    **{k: {x: r[x] for x in ("steps", "preemptions", "fed_tokens", "resets")} for k, r in runs.items()})
    print(f"  (c) {MAMBA_SLOTS} prompts of {min(map(len, c_prompts))}-{max(map(len, c_prompts))} tokens, "
          f"{P['new']} new, C={CHUNK}, pages of {P['page_size']}: {n_pages} pages ({worst} worst case) "
          f"-> {pre['steps']} steps, {pre['preemptions']} preemptions, {pre['resets']} resets; twin "
          f"{twin['steps']} steps, none: all {len(twin['rows'])} sampled rows bit-identical; planted fault "
          f"(no reset on re-admission): {len(fault_differ)} rows differ (max |d| {worst_fault:.4g}), rejected; "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    del runs, twin, pre, fault, params, head
    torch.cuda.empty_cache()

    # (d) the card against the CPU at 2 layers, float and w4a4; the planted fault
    t0 = time.monotonic()
    out["d"] = {}
    for label, packed in (("float", False), ("w4a4", True)):
        d = out["d"][label] = _mamba_cross(torch, cfg, packed)
        for r in d["steps"]:
            print(f"  (d) {label} step {r['step']} (C={r['chunk']}): {r['clean_rows']}/{CROSS_SLOTS} slots "
                  f"with identical levels (max|d| {r['clean_max_abs']}), max rel L2 {r['max_rel']:.3g}, rows "
                  f"flipped by slot {r['rows_flipped']}, {r['first_hand_flips']} of {r['first_hand_rows']} "
                  f"first-hand rows flipped; tokens agree {r['tokens_agree']}/{CROSS_SLOTS}", flush=True)
        print(f"  (d) {label}: states after the run, rel L2 {d['state_rel_l2']}", flush=True)
    try:
        _mamba_cross(torch, cfg, False, skip_reset=True)
        planted = None
    except PhaseError as e:
        planted = str(e)
    check(planted is not None and planted.startswith("(d)"),
          "(d): the card keeping slot 3's state at its re-admission passes the float check")
    out["d_fault"] = planted
    out["d_s"] = time.monotonic() - t0
    print(f"  (d) {out['d_s']:.1f} s; the planted fault was rejected: {planted}", flush=True)
    out["phase_s"] = time.monotonic() - t_phase
    print(f"  phase 15 on {card.name} ({card.power_limit}): {out['phase_s']:.1f} s", flush=True)
    report["mamba"] = out
    return out


# -- phase 16 ------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
# 12 of the config's 48 layers, a cut forced by memory: init_params makes
# float32 experts, 2.42 GB a layer (116 GB at full depth); at 12 layers they
# are 29.0 GB and the packed words 15.3 GB, so the build peaks near 46 GB
MOE_LAYERS = 12
MOE_PROMPTS = (128, 385)
MOE_NEW = 32
# bucket rows a step: round(n_recv / 128 * 1.25) at 8 tokens (a decode step,
# C = 1) and at 128 (8 slots x a chunk of 16)
MOE_KERNEL_M = (1, 12)
MOE_BLOCK_K = 512
MOE_CROSS_STEPS = 3
MOE_CROSS_REL_TOL = 1e-4


def moe_expert_shapes(cfg) -> dict[str, tuple[int, int, int, int]]:
    """name -> (experts, K, N, launches per step) of the batched expert products."""
    E, d, f, L = cfg.n_experts, cfg.d_model, cfg.expert_d_ff, cfg.n_layers
    return {"w_up|w_gate": (E, d, f, 2 * L), "w_down": (E, f, d, L)}


def _moe_kernels(torch, card, timer, cfg, report: dict) -> dict:
    """(a) K1 and K2 (block_k MOE_BLOCK_K) over the experts in one launch at
    the served expert shapes, M rows a bucket (``MOE_KERNEL_M``), w4a4:
    bit-exact against their plain versions, one captured call one kernel
    node and nothing else, timed by graph beside the bytes bound and a bf16
    ``torch.bmm`` of the same shapes (the library yardstick; not the same
    rounding)."""
    from repro_torch.kernels.packed_matmul import ref as pm
    from repro_torch.kernels.packed_matmul.kernel import (
        BM, BN, grid_plan, packed_dense_fused_plain, packed_dense_fused_raw, packed_matmul_plain,
        packed_matmul_raw,
    )
    from repro_torch.kernels.packed_matmul.ops import choose_config

    g = torch.Generator(device="cuda")
    g.manual_seed(16)
    c = choose_config(4, 4)
    kw = dict(n_seg=c.n_seg, stride=c.stride, acc_chunk=c.acc_chunk, overlap=c.overlap)
    rows, max_err = [], 0.0
    for M in MOE_KERNEL_M:
        for name, (E, K, N, per_step) in moe_expert_shapes(cfg).items():
            x = torch.rand((E, M, K), generator=g, device="cuda") * 1.2 - 0.1
            wp = torch.empty((E, K, N // c.n_seg), dtype=torch.int32, device="cuda")
            for e in range(E):
                wp[e] = pm.pack_weights(torch.randint(0, 16, (K, N), generator=g, device="cuda",
                                                      dtype=torch.int32), c.n_seg, c.stride)
            a_lvl = torch.round(torch.clamp(x, 0, 1) * 15).to(torch.int32)
            k1 = lambda: packed_dense_fused_raw(x, wp, a_bits=4, **kw)  # noqa: E731
            k2 = lambda: packed_matmul_raw(a_lvl, wp, block_k=MOE_BLOCK_K, **kw)  # noqa: E731
            acc, a_sum = k1()
            acc2 = k2()
            p_acc, p_sum = packed_dense_fused_plain(x, wp, a_bits=4, **kw)
            p_acc2 = packed_matmul_plain(a_lvl, wp, block_k=MOE_BLOCK_K, **kw)
            torch.cuda.synchronize()
            err = max((acc - p_acc).abs().max().item(), (a_sum - p_sum).abs().max().item(),
                      (acc2 - p_acc2).abs().max().item())
            check(torch.equal(acc, p_acc) and torch.equal(a_sum, p_sum) and torch.equal(acc2, p_acc2),
                  f"(a) batched K1/K2 differ from their plain versions at {name} M={M}: max {err}")
            max_err = max(max_err, err)
            del acc, a_sum, acc2, p_acc, p_sum, p_acc2
            for kernel, fn in (("packed_dense_fused", k1), ("packed_matmul", k2)):
                census, launched = device_nodes(torch, fn)
                check(launched == {kernel: 1} and census == only_kernels(launched),
                      f"(a) a batched {kernel} call at {name} M={M} is not one kernel node: {census}")
            Np = wp.shape[-1]
            splits, k_per_split = grid_plan(M, K, Np, card.sms, batch=E)
            nbytes = E * (M * K * 4 + K * Np * 4 + M * N * 4 + M * 4)
            b_ms, b_by, t_b, t_o = k1_bound(card, E * M, K, N, nbytes)
            xb = x.to(torch.bfloat16)
            wb = torch.randn((E, K, N), generator=g, device="cuda", dtype=torch.bfloat16)
            row = dict(shape=name, E=E, K=K, N=N, M=M, per_step=per_step, splits=splits,
                       k_per_split=k_per_split, blocks=E * -(-M // BM) * -(-Np // BN) * splits,
                       k1_graph_ms=timer.graph(lambda i: k1()), k1_ms=timer(k1, reps=10),
                       k2_graph_ms=timer.graph(lambda i: k2()), k2_ms=timer(k2, reps=10),
                       plain_ms=timer(lambda: packed_dense_fused_plain(x, wp, a_bits=4, **kw), reps=1, warmup=0),
                       k2_plain_ms=timer(lambda: packed_matmul_plain(a_lvl, wp, block_k=MOE_BLOCK_K, **kw),
                                         reps=1, warmup=0),
                       bmm_graph_ms=timer.graph(lambda i: torch.bmm(xb, wb)),
                       bound_ms=b_ms, bound_by=b_by, t_bytes=t_b, t_ops=t_o, bytes=nbytes)
            row["k1_gbps"] = nbytes / row["k1_graph_ms"] / 1e6
            rows.append(row)
            print(f"  (a) {name:12s} {E} x [{M}, {K}] x [{K}, {N}]: {row['blocks']} blocks ({splits} K "
                  f"splits): K1 {row['k1_graph_ms']:.4f} ms by graph ({row['k1_gbps']:.0f} GB/s; events "
                  f"{row['k1_ms']:.4f}), K2 (block_k {MOE_BLOCK_K}) {row['k2_graph_ms']:.4f} ms; plain "
                  f"{row['plain_ms']:.2f} / {row['k2_plain_ms']:.2f} ms; bf16 bmm (not the same rounding) "
                  f"{row['bmm_graph_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB); "
                  f"bit-exact, one kernel node a call", flush=True)
            del x, wp, a_lvl, xb, wb
            torch.cuda.empty_cache()
    report["moe_matmul"] = rows
    return {"max_err": max_err, "rows": rows}


def moe_step_bound(eng) -> dict:
    """The least bytes, and time at HBM_BYTES_PER_S, of one served MoE step
    as the reference computes it: every weight read once (the layers'
    packed words, all experts included, since every expert's bucket runs,
    and their float leaves; the packed head) and the K/V pools once."""
    from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
    from repro_torch.models import transformer as T

    def nbytes(t):
        return t.data.numel() * t.data.element_size() if isinstance(t, PackedDenseParams) else (
            t.numel() * t.element_size())

    weights = []
    T.map_leaves(eng.params["layers"], lambda a: weights.append(nbytes(a)))
    weights = sum(weights) + nbytes(eng._head)
    pools = sum(nbytes(t) for t in eng.state.values())
    return dict(weights_bytes=weights, pool_bytes=pools, bytes=weights + pools,
                bound_ms=(weights + pools) / HBM_BYTES_PER_S * 1e3)


def _dispatch_stats(torch, params, s, x, valid) -> tuple:
    """The copies one ``_local_moe`` call drops, rederived from its routing
    (one expert group): a copy past the send buffer, or past its expert's
    capacity among that expert's copies in token order, is dropped; the
    copy kept in the last expert's last bucket row is overwritten by a
    later zero row (the reference's collision) when that expert overflows
    or the send buffer has padding rows.  ``valid`` marks the tokens the
    step's logits read (a slot's valid lanes).  Returns device scalars
    (dropped copies, of them of valid tokens, overwritten copies, copies
    of valid tokens): reading them waits for the step."""
    from repro_torch.models import moe as X
    from repro_torch.models.layers import rmsnorm

    t, k, E = x.shape[0], s.top_k, s.n_experts
    n_copy = t * k
    c_send = int(max(1, round(n_copy * s.capacity_factor)))
    c_exp = int(max(1, round(c_send / E * s.capacity_factor)))
    _, topi = X._route(params, s, rmsnorm(params["ln"], x))
    # the send buffer's last row is overwritten by a dropped copy when copies overflow it
    n_sent = min(n_copy, c_send) - (n_copy > c_send)
    e = topi.reshape(n_copy)[:n_sent]
    order = torch.argsort(e, stable=True)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n_sent, device=e.device) - torch.searchsorted(e[order], e[order])
    dropped = torch.ones(n_copy, dtype=torch.bool, device=e.device)
    dropped[:n_sent] = pos >= c_exp
    count = (e == E - 1).sum()
    lost = (e == E - 1) & (pos == c_exp - 1) & ((count > c_exp) | (c_send != n_copy))
    of_valid = valid.repeat_interleave(k)
    return dropped.sum(), (dropped & of_valid).sum(), lost.sum(), of_valid.sum()


def _eager_rows(torch, cfg, params, ecfg, head, prompts) -> dict:
    """``prompts`` served by an eager engine (``capture=False``) of the same
    weights: every sampled row and each request's tokens, and the copies the
    dispatch drops a step (:func:`_dispatch_stats`): of the step's S x C
    tokens, and of its valid ones (a lane below its slot's ``lens``; at
    C = 1 an active slot's)."""
    from repro_torch.models import moe as X
    from repro_torch.serving import Engine

    eng = Engine(cfg, params, ecfg, head=head, capture=False)
    eng.warmup()  # its zero batch is no step of the run
    stats, inner = [], X._local_moe
    S, C = ecfg.n_slots, ecfg.chunk_tokens

    def valid():
        lens = eng._program._args[2]
        if lens is not None:
            return (torch.arange(C, device=lens.device)[None] < lens[:, None]).reshape(-1)
        active = torch.zeros(S, dtype=torch.bool)
        active[list(eng.scheduler.active)] = True
        return active.to(eng.device)

    def counting(p, s, x, **kw):
        stats.append(_dispatch_stats(torch, p, s, x, valid()))
        return inner(p, s, x, **kw)

    X._local_moe = counting
    try:
        run = _sampled_serve(torch, eng, prompts, MOE_NEW)
    finally:
        X._local_moe = inner
    steps = run["steps"]
    check(len(stats) == cfg.n_layers * steps, f"{len(stats)} MoE calls in {steps} steps")
    sums = [sum(int(v[i]) for v in stats) / steps for i in range(4)]
    run.update(dropped_per_step=sums[0], dropped_valid_per_step=sums[1], overwritten_per_step=sums[2],
               copies_valid_per_step=sums[3], copies_per_step=cfg.n_layers * S * C * cfg.top_k)
    return run


def _memset_ops(prof) -> dict:
    """The PyTorch ops of a trace whose device work includes a memset, by
    name (which op puts a memset node in a captured step)."""
    out: dict = {}
    for ev in prof.events():
        if any("memset" in k.name.lower() for k in getattr(ev, "kernels", [])):
            out[ev.name] = out.get(ev.name, 0) + 1
    return out


def _moe_cross(torch, cfg, packed: bool) -> dict:
    """(c): the card against the CPU at 2 layers of full width, float32, on
    the same weights (seed 1; ``packed``: w4a4 projections and experts and
    the packed (4, 4) head, else float and the tied float head), 8 slots of
    4 pages: MOE_CROSS_STEPS decode steps and a chunked step (lens
    ``CROSS_CHUNK_LENS``).  Per step, the tokens whose top-8 experts (ids or
    order) differ in a layer (routing flips) and the rows with a differing
    activation level (attention projections by row; expert buckets by
    expert: every token routed there counts).  A slot's logits row is
    clean when neither touched a row it reads: not its own lanes, an
    earlier lane of its slot (attention), a lane routed to an expert that a
    routing flip moved a copy into or out of (capacity), or its slot at an
    earlier step (its K/V rows).  Clean rows: within MOE_CROSS_REL_TOL
    relative L2 (float) or equal (packed)."""
    import numpy as np

    from repro_torch.models import layers as L
    from repro_torch.models import moe as X
    from repro_torch.models import transformer as T
    from repro_torch.serving.api import quantize_params_packed

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = T.init_params(cfg2, seed=1, device="cuda")
    head = None
    if packed:
        head = L.prepack_lm_head(params["embed"], w_bits=4, a_bits=4, device="cuda")
        params = quantize_params_packed(params, w_bits=4, a_bits=4, device="cuda")
    sides = {"cuda": (params, head),
             "cpu": (T.map_leaves(params, lambda a: a.to("cpu")), None if head is None else head.to("cpu"))}
    S, nb, ps, E = CROSS_SLOTS, CROSS_BLOCKS, 16, cfg.n_experts
    states = {dev: T.init_paged_state(cfg2, S, S * nb + 1, ps, dtype=torch.float32, device=dev) for dev in sides}
    table = torch.arange(1, S * nb + 1, dtype=torch.int32).reshape(S, nb)
    plan = [(1, None)] * MOE_CROSS_STEPS + [(CHUNK, CROSS_CHUNK_LENS)]
    rng = np.random.default_rng(5)
    rec: list = []
    inner, inner_top = L.packed_dense, X.top_k  # moe.py calls the same packed_dense

    def levels(x, w, **kw):
        n = (1 << w.a_bits) - 1
        rec.append(("lv", torch.round(torch.clamp(x.float(), 0.0, 1.0) * n).to(torch.int16).cpu()))
        return inner(x, w, **kw)

    def routing(gates, k):
        v, i = inner_top(gates, k)
        rec.append(("top", i.cpu()))
        return v, i

    dirty_prev = torch.zeros(S, dtype=torch.bool)
    steps = []
    L.packed_dense, X.packed_dense, X.top_k = levels, levels, routing
    try:
        for t, (C, lens) in enumerate(plan):
            tokens = torch.from_numpy(rng.integers(0, cfg2.vocab, (S, C)).astype(np.int32))
            pos = torch.full((S,), t, dtype=torch.int32)
            tlens = None if lens is None else torch.tensor(lens, dtype=torch.int32)
            n_read = torch.ones(S, dtype=torch.long) if lens is None else torch.clamp(tlens, min=1).long()
            logs, recs = {}, {}
            for dev, (p, h) in sides.items():
                rec.clear()
                lg, _ = T.forward_decode_paged(p, cfg2, states[dev], table.to(dev), tokens.to(dev),
                                               pos.to(dev), head=h, lens=None if tlens is None else tlens.to(dev),
                                               gather="kernel")
                logs[dev], recs[dev] = lg.cpu(), list(rec)
            kinds = [k for k, _ in recs["cuda"]]
            check(kinds == [k for k, _ in recs["cpu"]], "(c): the two sides ran different calls")
            dirty = torch.zeros((S, C), dtype=torch.bool)
            route_flips = level_rows = 0
            head_flip = torch.zeros(S, dtype=torch.bool)
            tops = [(g, c) for (k, g), (_, c) in zip(recs["cuda"], recs["cpu"]) if k == "top"]
            lvs = [(g, c) for (k, g), (_, c) in zip(recs["cuda"], recs["cpu"]) if k == "lv"]
            check(len(tops) == cfg2.n_layers and len(lvs) == (7 * cfg2.n_layers + 1 if packed else 0),
                  f"(c): {len(tops)} routings, {len(lvs)} packed matmuls")
            for layer, (g_top, c_top) in enumerate(tops):
                flip = (g_top != c_top).any(dim=1)  # [S * C] tokens
                route_flips += int(flip.sum())
                moved = torch.zeros(E, dtype=torch.bool)
                moved[g_top[flip].flatten()] = True
                moved[c_top[flip].flatten()] = True
                bad = moved.clone()
                if packed:
                    for g_lv, c_lv in lvs[7 * layer: 7 * layer + 7]:
                        diff = (g_lv != c_lv)
                        if diff.ndim == 3:  # an expert bucket [E, c_exp, K]
                            bad |= diff.any(dim=2).any(dim=1)
                            level_rows += int(diff.any(dim=2).sum())
                        else:  # an attention projection, a row a token
                            dirty |= diff.any(dim=1).reshape(S, C)
                            level_rows += int(diff.any(dim=1).sum())
                dirty |= (flip | bad[c_top].any(dim=1)).reshape(S, C)
            if packed:
                head_flip = (lvs[-1][0] != lvs[-1][1]).any(dim=1)
                level_rows += int(head_flip.sum())
            # a dirty lane reaches every later lane of its slot (attention);
            # a slot's logits read its lanes up to its last valid one
            reach = torch.cumsum(dirty.long(), dim=1) > 0
            read_dirty = reach[torch.arange(S), n_read - 1]
            clean = ~(read_dirty | head_flip | dirty_prev)
            dirty_prev = dirty_prev | reach.any(dim=1) | head_flip
            g_log, c_log = logs["cuda"], logs["cpu"]
            check(bool(torch.isfinite(g_log).all()), "(c): non-finite logits on the card")
            rel = torch.linalg.vector_norm(g_log - c_log, dim=1) / torch.linalg.vector_norm(c_log, dim=1)
            equal = (g_log == c_log).all(dim=1)
            r = dict(step=t, chunk=C, lens=lens, routing_flips=route_flips, level_flip_rows=level_rows,
                     clean_slots=int(clean.sum()), clean_max_rel=float(rel[clean].max()) if clean.any() else None,
                     clean_equal=int((equal & clean).sum()), max_rel=float(rel.max()),
                     tokens_agree=int((g_log.argmax(1) == c_log.argmax(1)).sum()))
            steps.append(r)
            what = f"(c) {'w4a4' if packed else 'float'} step {t} (C={C})"
            if packed:
                check(bool(equal[clean].all()), f"{what}: a clean row is not equal to the CPU's")
            else:
                check(bool((rel[clean] <= MOE_CROSS_REL_TOL).all()),
                      f"{what}: a clean row differs by {float(rel[clean].max()):.3g} relative L2, past "
                      f"{MOE_CROSS_REL_TOL}")
    finally:
        L.packed_dense, X.packed_dense, X.top_k = inner, inner, inner_top
    check(sum(r["clean_slots"] for r in steps) > 0, "(c): no clean row to hold against the CPU")
    return dict(steps=steps)


def phase_moe(torch, card, report: dict) -> dict:
    """qwen3-moe-30b-a3b at full width (MOE_LAYERS of its layers): MoE with
    w4a4 packed experts, K1 over the expert grid axis.  (a)
    :func:`_moe_kernels`.  (b) The serve, w4a4 projections and experts,
    the packed (4, 4) head and the kernel gather, 8 slots, page 16,
    ``max_len`` 512, reserve: at C = 16 on 8 prompts of 128-384 tokens and
    at C = 1 on phase 4's 8 prompts of 16-64 tokens, MOE_NEW new tokens
    each; every request ``ok`` with finite logits, one capture, no leaks,
    launch counters and graph nodes 7 K1 a layer and the head and one K3 a
    layer a step, memset nodes only where a PyTorch op puts them (named
    from a trace); step p50, one replay's device time, tok/s, TTFT, a
    one-step trace by kernel group, the step's bytes bound; an eager step
    reads nothing back to the host, and an eager engine (``capture=False``)
    of the same weights samples the captured run's rows bit for bit and
    counts the copies the dispatch drops a step.  (c) :func:`_moe_cross`,
    float and w4a4."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.serving import Engine, EngineConfig, build_engine

    t_phase = time.monotonic()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.hd, cfg.kv_heads, cfg.n_experts, cfg.top_k, cfg.expert_d_ff,
           cfg.vocab, cfg.capacity_factor) == (2048, 32, 64, 4, 128, 8, 768, 151936, 1.25),
          f"qwen3-moe-30b-a3b's config {cfg}")
    ecfg = EngineConfig(n_slots=8, page_size=16, max_len=512, chunk_tokens=CHUNK, admit="reserve",
                        packed_head=True, head_bits=(4, 4), gather_backend="kernel")
    ecfg1 = dataclasses.replace(ecfg, chunk_tokens=1)
    rng = np.random.default_rng(16)
    long_prompts = [rng.integers(0, cfg.vocab, int(n)).tolist() for n in rng.integers(*MOE_PROMPTS, size=8)]
    rng = np.random.default_rng(0)  # phase 4's prompt lengths
    short = [rng.integers(0, cfg.vocab, int(rng.integers(16, 65))).tolist() for _ in range(8)]
    out: dict = {}

    print(f"  (a) K1/K2 over the expert axis at qwen3-moe-30b-a3b's expert shapes:", flush=True)
    t0 = time.monotonic()
    timer = Timer(torch)
    out["k1"] = _moe_kernels(torch, card, timer, cfg, report)
    del timer
    out["k1"]["phase_s"] = time.monotonic() - t0
    torch.cuda.empty_cache()

    # (b) the serves
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    eng = build_engine(cfg, ecfg, quant="packed", w_bits=4, a_bits=4, seed=0)
    torch.cuda.synchronize()
    out["b"] = dict(build_s=time.monotonic() - t0, build_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                    **moe_step_bound(eng))
    params, head = eng.params, eng._head
    print(f"  (b) {MOE_LAYERS} of 48 layers built in {out['b']['build_s']:.1f} s, peak "
          f"{out['b']['build_peak_gb']:.2f} GB; weights {out['b']['weights_bytes'] / 1e9:.2f} GB, KV pools "
          f"{out['b']['pool_bytes'] / 1e9:.3f} GB: a step's bytes bound {out['b']['bound_ms']:.3f} ms", flush=True)
    _sync_free_step(torch, Engine(cfg, params, ecfg, head=head, capture=False))
    per_step = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": 7 * cfg.n_layers + 1,
                "paged_gather": cfg.n_layers}
    for label, e, ps, c in (("C=16", ecfg, long_prompts, CHUNK), ("C=1", ecfg1, short, 1)):
        if label != "C=16":
            eng = Engine(cfg, params, e, head=head)
        t0 = time.monotonic()
        r = _timed_turn(torch, eng, ps, per_step, f"(b) {label}", memset=True, max_new=MOE_NEW, keep=True)
        check(all(len(t) == MOE_NEW for t in r["tokens"].values()), f"(b) {label}: a request ended short")
        # a one-step trace of the same graph: one chunk of c prompt tokens a slot, one new token
        rng, steps0 = np.random.default_rng(2), eng.n_steps
        for _ in range(e.n_slots):
            eng.submit(rng.integers(0, cfg.vocab, c).tolist(), 1)
        eng.warmup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.monotonic()
            m = eng.run(realtime=True)
            torch.cuda.synchronize()
            wall = time.monotonic() - t1
        check(eng.n_steps - steps0 == 1, f"(b) {label}: the traced run took {eng.n_steps - steps0} steps")
        check_clean(eng, f"(b) {label}: the traced run")
        r["profile"] = trace_summary(prof, wall, 1, f"qwen3-moe {label}, one captured step")
        check(eng._program.captures == 1, f"(b) {label}: {eng._program.captures} captures")
        eng.close()
        torch.cuda.empty_cache()
        memsets = r["graph"]["kinds"].get("memset", 0)
        r["memset_ops"] = _memset_ops(prof) if memsets else {}
        check(not memsets or r["memset_ops"], f"(b) {label}: {memsets} memset nodes, no op named in the trace")
        # captured against eager, bit for bit; the dispatch's drops
        cap = _sampled_serve(torch, Engine(cfg, params, e, head=head), ps, MOE_NEW)
        eag = _eager_rows(torch, cfg, params, e, head, ps)
        differ = _rows_differ(cap["rows"], eag["rows"])
        check(not differ and cap["tokens"] == eag["tokens"] and cap["steps"] == eag["steps"],
              f"(b) {label}: {len(differ)} of {len(cap['rows'])} captured rows differ from capture=False's")
        r.update(prompt_tokens=sum(map(len, ps)), rows=len(cap["rows"]), serve_s=time.monotonic() - t0,
                 **{k: eag[k] for k in ("dropped_per_step", "dropped_valid_per_step", "overwritten_per_step",
                                        "copies_per_step", "copies_valid_per_step")})
        out[label] = r
        print(f"  (b) {label}: {len(ps)} prompts of {min(map(len, ps))}-{max(map(len, ps))} tokens, {MOE_NEW} "
              f"new: {r['steps']} steps, {r['tokens_per_s']:.1f} tok/s, step p50 {r['step_ms_p50']:.2f} ms "
              f"(min {r['step_ms_min']:.2f}), one replay {r['replay_ms']:.2f} ms, TTFT p50 "
              f"{r['ttft_ms_p50']:.1f} ms; launches {r['counts']}; graph nodes {r['graph']}; memset ops "
              f"{r['memset_ops']}; the dispatch drops {r['dropped_valid_per_step']:.1f} of "
              f"{r['copies_valid_per_step']:.1f} copies of valid tokens a step ({r['dropped_per_step']:.1f} of "
              f"{r['copies_per_step']} over every lane), and overwrites the copy in the last bucket row "
              f"{r['overwritten_per_step']:.2f} times a step; all {r['rows']} sampled rows of the captured "
              f"run equal capture=False's; {r['serve_s']:.1f} s", flush=True)
    del eng, params, head
    torch.cuda.empty_cache()

    # (c) the card against the CPU at 2 layers, float and w4a4
    t0 = time.monotonic()
    out["c"] = {}
    for label, packed in (("float", False), ("w4a4", True)):
        d = out["c"][label] = _moe_cross(torch, cfg, packed)
        for r in d["steps"]:
            print(f"  (c) {label} step {r['step']} (C={r['chunk']}): routing flips {r['routing_flips']}, "
                  f"activation-level flip rows {r['level_flip_rows']}; {r['clean_slots']}/{CROSS_SLOTS} clean "
                  f"slots (max rel L2 {r['clean_max_rel']}, {r['clean_equal']} equal); max rel L2 "
                  f"{r['max_rel']:.3g}; tokens agree {r['tokens_agree']}/{CROSS_SLOTS}", flush=True)
    out["c_s"] = time.monotonic() - t0
    out["phase_s"] = time.monotonic() - t_phase
    print(f"  (c) {out['c_s']:.1f} s; phase 16 on {card.name} ({card.power_limit}): {out['phase_s']:.1f} s",
          flush=True)
    report["moe"] = out
    return out


# -- main ------------------------------------------------------------------------


# -- phase 17 ------------------------------------------------------------------

# phase 17's faults: tests/test_chaos.py's combined scenario (every family at
# rate 0.2, seed 3), a request struck any number of times (64 strikes), and
# hard faults planted by wrapping the step program's run, each (engine step,
# after): before that step runs, or after its replay has written the state
# (its logits then discarded).  (a) snapshots every 4 steps; (b) every 16,
# since its state is 80 MB a snapshot against a 7 ms step.
CHAOS = dict(seed=3, step_fault_rate=0.2, alloc_fault_rate=0.2, nan_rate=0.2)
CHAOS_RETRIES = 64
CHAOS_FAULTS = {"a": ((6, False), (20, True)), "b": ((24, True),)}
CHAOS_SNAPSHOT_EVERY = {"a": 4, "b": 16}
# (b)'s requests: phase 15 (c)'s 16 prompts of 2-8 tokens (seed 16), not its
# C = 1 prompts of 64-128: a state left from before a restore decays by
# about exp(-0.8) a token in the slowest head (phase 15), so only a short
# replay shows a stale state in its rows
CHAOS_MAMBA_NEW = 16
SNAPSHOT_ROOT = ROOT / "build" / "chaos_snapshots"
# what the fault layer decides from the schedule alone (never a token's value)
CHAOS_DECISIONS = ("statuses", "steps", "preemptions", "quarantines", "step_retries", "hard_recoveries",
                   "injected")


def chaos_decisions(m: dict, reqs) -> dict:
    """The fault layer's decisions of a run: its counters and, per request,
    its status, strikes, preemptions and token count."""
    return dict(**{k: m[k] for k in CHAOS_DECISIONS},
                requests=[(r.rid, r.status, r.n_faults, r.n_preempted, len(r.out_tokens)) for r in reqs])


def plant_hard_faults(eng, faults) -> list:
    """Wrap ``eng``'s step program so that it raises once at each (engine
    step, after) of ``faults``; returns the list of the faults that fired."""
    run, fired = eng._program.run, []

    def dying(*args):
        for step, after in faults:
            if eng.n_steps == step and (step, after) not in fired:
                fired.append((step, after))
                if after:
                    run(*args)
                raise ValueError(f"planted hard fault at step {step}" + (" after the step" if after else ""))
        return run(*args)

    eng._program.run = dying
    return fired


def rebinding_engine():
    """Phase 17's planted fault: an engine whose restore rebinds the state,
    as the reference's does (``self.state = restored``), where the port's
    writes into it in place."""
    import torch

    from repro_torch.serving import Engine

    class RebindingEngine(Engine):
        def _restore_state(self):
            if self._ckpt is not None:
                self._ckpt.wait()
                if self._ckpt.latest_step() is not None:
                    _, self.state = self._ckpt.restore(self.state)
                    return
            self.state = {k: torch.zeros_like(t) for k, t in self.state.items()}

    return RebindingEngine


def chaos_ecfg(ecfg, label: str, chaos: bool, snapshots: bool):
    """``ecfg`` with the fault layer of phase 17's run ``label``: chaos,
    snapshots into a fresh directory under build/, or neither."""
    import shutil

    from repro_torch.serving import ChaosConfig

    kw = dict(max_request_retries=CHAOS_RETRIES, chaos=ChaosConfig(**CHAOS) if chaos else ChaosConfig())
    if snapshots:
        d = SNAPSHOT_ROOT / label
        shutil.rmtree(d, ignore_errors=True)
        kw.update(snapshot_every=CHAOS_SNAPSHOT_EVERY[label[0]], snapshot_dir=str(d))
    return dataclasses.replace(ecfg, **kw)


def chaos_serve(torch, eng, prompts, max_new: int, faults=(), *, realtime: bool = True, max_steps=None,
                trace=None) -> dict:
    """Serve ``prompts`` on ``eng`` (fresh; warmed up first), with hard
    faults planted at ``faults``: its metrics and requests, every sampled
    row by (request, token), the launch counters of the run, the steps
    its restores found a snapshot at (None: zeros), whether the state's
    tensors kept their addresses, and the step times."""
    import numpy as np

    from repro_torch.kernels import build

    rows, restored = {}, []
    eng.on_sample = lambda rid, t, row: rows.__setitem__((rid, t), row.copy())
    ptrs = {k: t.data_ptr() for k, t in eng.state.items()}
    restore = eng._restore_state

    def spied():
        if eng._ckpt is not None:
            eng._ckpt.wait()  # the step the restore reads, once the writer is done
        restored.append(eng._ckpt.latest_step() if eng._ckpt is not None else None)
        restore()

    eng._restore_state = spied
    snap_ms, snapshot = [], eng._snapshot

    def timed():
        t0 = time.monotonic()
        snapshot()
        snap_ms.append(1e3 * (time.monotonic() - t0))

    eng._snapshot = timed
    fired = plant_hard_faults(eng, faults)
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.warmup()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    build.reset_counts()
    m = eng.run(realtime=realtime, max_steps=max_steps, trace=trace)
    counts = build.counts()
    step_ms = [1e3 * s for s in eng.step_seconds]
    return dict(m=m, reqs=reqs, rows=rows, counts=counts, restored=restored, fired=list(fired),
                in_place={k: t.data_ptr() for k, t in eng.state.items()} == ptrs,
                step_ms_p50=float(np.median(step_ms)) if step_ms else None, snapshot_ms=snap_ms,
                state_bytes=sum(t.numel() * t.element_size() for t in eng.state.values()),
                decisions=chaos_decisions(m, reqs))


def check_in_place(r: dict, what: str) -> None:
    """The state's tensors kept their addresses over the run: a restore
    wrote into them, and the step's graph reads what the engine wrote."""
    check(r["in_place"], f"{what}: the state's tensors were rebound (a data_ptr changed)")


def check_chaos_run(torch, r: dict, eng, per_step: dict, what: str, memset: bool = False) -> dict:
    """A fault layer's run at full width: every request ``ok`` (and with
    no chaos and no planted fault, nothing struck), the launch counters the per-step counts times the steps (and the replays of
    faults after the step), the graph's kernel nodes those counts, one
    capture, the state written in place, no leaks; the engine is released."""
    m = r["m"]
    check(m["statuses"] == {"ok": len(r["reqs"])}, f"{what}: statuses {m['statuses']}")
    if eng._chaos is None and not r["fired"]:
        check_clean(eng, what)
    replays = m["steps"] + sum(after for _, after in r["fired"])
    check(r["counts"] == {k: v * replays for k, v in per_step.items()},
          f"{what}: launch counters {r['counts']} != {per_step} x {replays} replays")
    census = check_graph(eng, per_step, what, memset=memset)
    check(eng._program.captures == 1, f"{what}: the engine captured {eng._program.captures} graphs, not 1")
    check_in_place(r, what)
    eng.assert_no_leaks()
    eng.close()
    torch.cuda.empty_cache()
    return census


def phase_chaos(torch, card, cfg, ecfg, prompts4: list, report: dict) -> dict:
    """Chaos and snapshots at full width, each engine's step one captured
    graph: injected step, allocation and NaN faults (CHAOS), retries, slot
    quarantine and hard faults (CHAOS_FAULTS) restored from snapshots in
    place.  (a) Phase 9's on-demand cell (llama3.2-3b, C = 16, phase 4's
    prompts and weights, built again from seed 0) fault-free, with
    snapshots only, and under chaos:
    every run's checks (:func:`check_chaos_run`); under chaos every sampled
    row bit-identical to the fault-free run's, every fault family,
    quarantines and retries seen, two hard recoveries, one from a snapshot
    at least, and the decisions equal to the CPU's at the smoke size; the
    planted rebinding restore must fail the address check.  (b)
    mamba2-130m at full width, C = 1, 16 slots, fault-free and under chaos
    with one hard fault: the same checks; the planted rebinding restore
    leaves the step on a stale recurrent state, and its rows must differ."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.serving import Engine, build_engine

    t_phase = time.monotonic()
    cells = chaos_configs(ecfg, prompts4)
    t0 = time.monotonic()
    cpu = chaos_cpu(torch, cells)
    print(f"  the CPU's runs at the smoke size ({time.monotonic() - t0:.1f} s): (a) {cpu['a']['steps']} steps, "
          f"injected {cpu['a']['injected']}; (b) {cpu['b']['steps']} steps, injected {cpu['b']['injected']}",
          flush=True)
    out: dict = {"cpu": cpu}

    # (a) phase 9's on-demand cell: fault-free, snapshots only, chaos
    ecfg_a, prompts, new = cells["a"]
    base = build_engine(cfg, ecfg, quant="packed", w_bits=4, a_bits=4, seed=0)
    params, head = base.params, base._head
    del base
    per_step = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": cfg.n_layers * 7 + 1,
                "paged_gather": cfg.n_layers}
    runs = {}
    for label, chaos, snapshots in (("fault-free", False, False), ("snapshots", False, True), ("chaos", True, True)):
        eng = Engine(cfg, params, chaos_ecfg(ecfg_a, f"a-{label}", chaos, snapshots), head=head)
        r = chaos_serve(torch, eng, prompts, new, CHAOS_FAULTS["a"] if chaos else ())
        r["graph"] = check_chaos_run(torch, r, eng, per_step, f"(a) {label}")
        del eng
        runs[label] = r
    free, snap, ch = runs["fault-free"], runs["snapshots"], runs["chaos"]
    m = ch["m"]
    check(not _rows_differ(free["rows"], snap["rows"]), "(a): the snapshots-only run sampled other rows")
    differ = _rows_differ(free["rows"], ch["rows"])
    check(not differ, f"(a): {len(differ)} of {len(free['rows'])} sampled rows under chaos differ from the "
                      f"fault-free run's")
    check(min(m["injected"].values()) > 0, f"(a): injected {m['injected']}: a fault family never fired")
    check(m["quarantines"] > 0 and m["step_retries"] > 0,
          f"(a): {m['quarantines']} quarantines, {m['step_retries']} step retries")
    check(m["hard_recoveries"] == 2 and len(ch["fired"]) == 2, f"(a): {m['hard_recoveries']} hard recoveries")
    check(any(s is not None for s in ch["restored"]), f"(a): no restore found a snapshot: {ch['restored']}")
    check(ch["decisions"] == cpu["a"], f"(a): decisions differ from the CPU's: {ch['decisions']} against {cpu['a']}")
    snap_cost = snap["step_ms_p50"] - free["step_ms_p50"]
    out["a"] = {k: dict(steps=r["m"]["steps"], preemptions=r["m"]["preemptions"], step_ms_p50=r["step_ms_p50"],
                        tokens_per_s=r["m"]["tokens_per_s"], counts=r["counts"], graph=r["graph"],
                        snapshots=len(r["snapshot_ms"]), snapshot_ms=r["snapshot_ms"], restored=r["restored"],
                        decisions=r["decisions"]) for k, r in runs.items()}
    state_mb = out["a"]["state_mib"] = free["state_bytes"] / 2**20
    print(f"  (a) llama3.2-3b C={CHUNK} on demand, {ecfg_a.pool_pages() - 1} usable pages, state {state_mb:.1f} "
          f"MiB: fault-free {free['m']['steps']} steps, step p50 {free['step_ms_p50']:.2f} ms; snapshots every "
          f"{CHAOS_SNAPSHOT_EVERY['a']} steps {snap['m']['steps']} steps, step p50 {snap['step_ms_p50']:.2f} ms "
          f"({snap_cost:+.2f}), a snapshot p50 {float(np.median(snap['snapshot_ms'])):.2f} ms (max "
          f"{max(snap['snapshot_ms']):.2f}) on the host; chaos {m['steps']} steps, step p50 {ch['step_ms_p50']:.2f} "
          f"ms, {m['tokens_per_s']:.1f} tok/s", flush=True)
    print(f"  (a) chaos: injected {m['injected']}, {m['step_retries']} step retries, {m['quarantines']} "
          f"quarantines, {m['preemptions']} preemptions, hard faults {ch['fired']} restored from snapshot steps "
          f"{ch['restored']}; all {len(free['rows'])} sampled rows bit-identical to the fault-free run's; decisions "
          f"equal the CPU's; launches {ch['counts']}; one capture, state in place, no leaks", flush=True)

    # the planted rebinding restore, stopped two steps past its first hard fault
    eng = rebinding_engine()(cfg, params, chaos_ecfg(ecfg_a, "a-planted", True, True), head=head)
    r = chaos_serve(torch, eng, prompts, new, CHAOS_FAULTS["a"], max_steps=CHAOS_FAULTS["a"][0][0] + 2)
    eng.close()
    del eng, params, head
    torch.cuda.empty_cache()
    check(r["m"]["hard_recoveries"] == 1, f"(a) planted: {r['m']['hard_recoveries']} hard recoveries")
    try:
        check_in_place(r, "(a) planted")
        planted_a = None
    except PhaseError as e:
        planted_a = str(e)
    check(planted_a is not None, "(a): the checks pass a restore that rebinds the state")
    out["a"]["planted"] = planted_a
    print(f"  (a) planted fault (the restore rebinds the state): rejected: {planted_a}", flush=True)

    # (b) mamba2-130m at C = 1: fault-free, chaos, and the planted rebinding restore
    mcfg = get_config(MAMBA_ARCH)
    ecfg_b, prompts_b, new_b = cells["b"]
    per_step_b = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": 3 * mcfg.n_layers + 1}
    base = build_engine(mcfg, ecfg_b, quant="packed", w_bits=4, a_bits=4, seed=0)
    params_b, head_b = base.params, base._head
    runs_b = {}
    for label, cls in (("fault-free", None), ("chaos", Engine), ("planted", rebinding_engine())):
        eng = base if cls is None else cls(mcfg, params_b, chaos_ecfg(ecfg_b, f"b-{label}", True, True),
                                           head=head_b)
        r = runs_b[label] = chaos_serve(torch, eng, prompts_b, new_b, () if cls is None else CHAOS_FAULTS["b"])
        if label == "planted":
            eng.close()
            torch.cuda.empty_cache()
        else:
            r["graph"] = check_chaos_run(torch, r, eng, per_step_b, f"(b) {label}", memset=True)
        del eng
    del base
    free_b, ch_b, pl_b = runs_b["fault-free"], runs_b["chaos"], runs_b["planted"]
    mb = ch_b["m"]
    differ = _rows_differ(free_b["rows"], ch_b["rows"])
    check(not differ, f"(b): {len(differ)} of {len(free_b['rows'])} sampled rows under chaos differ from the "
                      f"fault-free run's")
    check(min(mb["injected"].values()) > 0 and mb["quarantines"] > 0 and mb["step_retries"] > 0,
          f"(b): injected {mb['injected']}, {mb['quarantines']} quarantines, {mb['step_retries']} retries")
    check(mb["hard_recoveries"] == 1 and ch_b["restored"][:1] != [None] and len(ch_b["restored"]) == 1,
          f"(b): {mb['hard_recoveries']} hard recoveries, restored from {ch_b['restored']}")
    check(ch_b["decisions"] == cpu["b"], f"(b): decisions differ from the CPU's: {ch_b['decisions']} against "
                                         f"{cpu['b']}")
    planted_b = _rows_differ(free_b["rows"], pl_b["rows"])
    check(len(planted_b) > 0 and not pl_b["in_place"],
          "(b): the run whose restore rebinds the state samples the fault-free rows")
    worst = max(float(np.abs(pl_b["rows"][k] - free_b["rows"][k]).max()) for k in planted_b)
    out["b"] = {k: dict(steps=r["m"]["steps"], preemptions=r["m"]["preemptions"], step_ms_p50=r["step_ms_p50"],
                        tokens_per_s=r["m"]["tokens_per_s"], counts=r["counts"], graph=r.get("graph"),
                        snapshots=len(r["snapshot_ms"]), snapshot_ms=r["snapshot_ms"], restored=r["restored"],
                        decisions=r["decisions"]) for k, r in runs_b.items()}
    out["b"]["state_mib"] = free_b["state_bytes"] / 2**20
    out["b"]["planted_rows_differ"] = len(planted_b)
    out["b"]["planted_max_abs"] = worst
    print(f"  (b) mamba2-130m C=1, {MAMBA_SLOTS} prompts of {min(map(len, prompts_b))}-{max(map(len, prompts_b))} "
          f"tokens, {new_b} new, state {out['b']['state_mib']:.1f} MiB: fault-free {free_b['m']['steps']} steps, step p50 {free_b['step_ms_p50']:.2f} ms; "
          f"chaos {mb['steps']} steps, step p50 {ch_b['step_ms_p50']:.2f} ms, snapshots every "
          f"{CHAOS_SNAPSHOT_EVERY['b']} steps p50 {float(np.median(ch_b['snapshot_ms'])):.2f} ms; injected "
          f"{mb['injected']}, {mb['step_retries']} retries, {mb['quarantines']} quarantines, {mb['preemptions']} "
          f"preemptions, hard fault restored from snapshot step {ch_b['restored']}; all {len(free_b['rows'])} rows "
          f"bit-identical to the fault-free run's; decisions equal the CPU's", flush=True)
    print(f"  (b) planted fault (the restore rebinds the state): {len(planted_b)} of {len(free_b['rows'])} rows "
          f"differ (max |d| {worst:.4g}), state rebound: rejected", flush=True)
    out["phase_s"] = time.monotonic() - t_phase
    print(f"  phase 17 on {card.name} ({card.power_limit}): {out['phase_s']:.1f} s", flush=True)
    report["chaos"] = out
    return out


def chaos_configs(ecfg, prompts4: list) -> dict:
    """(engine config, prompts, new tokens) of (a) and (b) at full width:
    (a) phase 9's on-demand cell on phase 4's prompts, (b) mamba2-130m at
    C = 1 on 16 prompts of 2-8 tokens."""
    import numpy as np

    from repro_torch.serving import EngineConfig

    worst = sum(-(-(len(p) + 32) // ecfg.page_size) for p in prompts4)
    ecfg_a = dataclasses.replace(ecfg, chunk_tokens=CHUNK, admit="on-demand",
                                 n_pages=round(ON_DEMAND_POOL_SHARE * worst) + 1)
    ecfg_b = EngineConfig(n_slots=MAMBA_SLOTS, page_size=16, max_len=2048, chunk_tokens=1, admit="on-demand",
                          packed_head=True, head_bits=(4, 4))
    rng = np.random.default_rng(16)
    short = [rng.integers(0, 50432, int(n)).tolist() for n in rng.integers(*MAMBA_PREEMPT["prompts"], size=MAMBA_SLOTS)]
    return {"a": (ecfg_a, prompts4, 32), "b": (ecfg_b, short, CHAOS_MAMBA_NEW)}


def chaos_cpu(torch, cells: dict) -> dict:
    """(a) and (b) on the CPU at the smoke size (the port's plain versions,
    the same engine configs, faults and prompt lengths, the prompts folded
    into the smoke vocabulary), on the virtual clock: their decisions."""
    from repro_torch.configs import get_config
    from repro_torch.serving import build_engine

    out = {}
    for label, arch in (("a", "llama3.2-3b"), ("b", MAMBA_ARCH)):
        e, prompts, new = cells[label]
        cfg = get_config(arch, smoke=True)
        eng = build_engine(cfg, chaos_ecfg(e, f"{label}-cpu", chaos=True, snapshots=True), quant="packed",
                           w_bits=4, a_bits=4, device="cpu")
        r = chaos_serve(torch, eng, [[t % cfg.vocab for t in p] for p in prompts], new, CHAOS_FAULTS[label],
                        realtime=False)
        out[label] = r["decisions"]
    return out


# -- phase 18 ------------------------------------------------------------------

# phase 18: attribution periods of (a) and (b), (c)'s slice length, and how
# far a sample's summed segment device time may lie from one replay of the
# step's graph at that step (each segment graph adds its launch to the sum)
ATTRIB_EVERY = {"a": 8, "b": 16}
OBS_SLICE_STEPS = 20
ATTRIB_GRAPH_TOL = 0.25


def trace_gate():
    """``benchmarks/check_invariants.py`` (stdlib only), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("check_invariants", ROOT / "benchmarks" / "check_invariants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step_spans(d: dict, steps: int) -> None:
    """One ``dispatch``, ``device_wait`` and ``step`` span a step."""
    for name in ("dispatch", "device_wait", "step"):
        got = sorted(e["args"]["step"] for e in d["traceEvents"] if e.get("ph") == "X" and e["name"] == name)
        check(got == list(range(1, steps + 1)), f"{name} spans at steps {got[:5]}..., not one a step of {steps}")


def phase_obs(torch, card, cfg, ecfg, prompts4: list, chaos: dict, report: dict) -> dict:
    """Observability at full width: (a) phase 4's cell traced and
    attributed every 8 steps against an untraced run, (b) phase 17 (a)'s
    chaos run traced and attributed every 16 steps against phase 17's
    decisions, (c) live readings between ``run(max_steps=)`` slices."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.obs.promcheck import check_exposition
    from repro_torch.obs.trace import TraceRecorder
    from repro_torch.serving import Engine, ObsConfig, build_engine

    t_phase = time.monotonic()
    ci = trace_gate()
    base = build_engine(cfg, ecfg, quant="packed", w_bits=4, a_bits=4, seed=0)
    params, head = base.params, base._head
    per_step = {**dict.fromkeys(build.COUNTS, 0), "packed_dense_fused": cfg.n_layers * 7 + 1,
                "paged_gather": cfg.n_layers}
    new = 32
    plain_rows, plain_tokens = _sampled_run(torch, base, prompts4, new)
    del base
    out: dict = {}

    # (a) phase 4's cell, traced, attributed every 8 steps
    every = ATTRIB_EVERY["a"]
    eng = Engine(cfg, params, dataclasses.replace(ecfg, obs=ObsConfig(attrib_every=every)), head=head)
    at, prog = eng._attrib, eng._program
    rows, checks = {}, []
    eng.on_sample = lambda rid, t, row: rows.__setitem__((rid, t), row.copy())
    inner = at.sample

    def sample(*args, **kw):
        # one replay of the step's graph at this step (it rewrites the
        # step's pool rows with the same values), then the sample
        with torch.cuda.stream(prog.stream):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            prog.graph.replay()
            e1.record()
        e1.synchronize()
        s = inner(*args, **kw)
        seg_ms = 1e3 * (s["embed_seconds"] + s["total_layer_seconds"] + s["head_seconds"])
        same = None
        if not checks:  # the first sample: the head segment's rows against the step's logits
            same = bool(np.array_equal(at.logits.float().cpu().numpy(), prog._host_np))
        checks.append(dict(step=s["step"], replay_ms=e0.elapsed_time(e1), segments_ms=seg_ms, head_rows_equal=same))
        return s

    at.sample = sample
    for p in prompts4:
        eng.submit(p, new)
    eng.warmup()
    torch.cuda.synchronize()
    build.reset_counts()
    tr = TraceRecorder()
    t0 = time.monotonic()
    m = eng.run(realtime=True, trace=tr)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = build.counts()
    steps = m["steps"]
    check_clean(eng, "(a) traced")
    check(m["statuses"] == {"ok": len(prompts4)}, f"(a): statuses {m['statuses']}")
    differ = _rows_differ(plain_rows, rows)
    check(not differ, f"(a): {len(differ)} of {len(rows)} sampled rows differ from the untraced run's")
    check({r.rid: list(r.out_tokens) for r in eng.finished} == plain_tokens, "(a): other tokens than untraced")
    check(counts == {k: v * steps for k, v in per_step.items()},
          f"(a): launch counters {counts} != {per_step} x {steps} steps")
    census = check_graph(eng, per_step, "(a) traced")
    check(prog.captures == 1, f"(a): the step was captured {prog.captures} times")
    d = tr.to_chrome()
    errs = ci.check_trace(d)
    check(errs == [], f"(a): the trace gate: {errs}")
    _step_spans(d, steps)
    n_samples = len(at.samples)
    check([s["step"] for s in at.samples] == list(range(every, steps + 1, every)),
          f"(a): samples at steps {[s['step'] for s in at.samples]}, not every {every}")
    for s in at.samples:
        check(len(s["layers"]) == cfg.n_layers and abs(sum(r["share"] for r in s["layers"]) - 1.0) < 1e-9,
              f"(a): sample at step {s['step']}: {len(s['layers'])} layer rows, shares sum "
              f"{sum(r['share'] or 0 for r in s['layers'])}")
    check(at.captures == 1 and at.launches == {k: v * n_samples for k, v in per_step.items() if v},
          f"(a): the segment graphs were captured {at.captures} times and launched {at.launches}")
    ratios = [c["segments_ms"] / c["replay_ms"] for c in checks]
    check(all(abs(r - 1.0) <= ATTRIB_GRAPH_TOL for r in ratios),
          f"(a): summed segment device time / one step replay {[round(r, 3) for r in ratios]} outside "
          f"1 +- {ATTRIB_GRAPH_TOL}")
    check(checks[0]["head_rows_equal"] is True, "(a): the head segment's rows differ from the step's logits")
    text = eng.prometheus_text()
    errs = check_exposition(text)
    check(errs == [], f"(a): the exposition: {errs}")
    summ = at.summary()
    embed_us = float(np.mean([s["embed_seconds"] for s in at.samples])) * 1e6
    head_us = float(np.mean([s["head_seconds"] for s in at.samples])) * 1e6
    step_ms = [1e3 * x for x in eng.step_seconds]
    out["a"] = dict(steps=steps, wall_s=wall, tokens_per_s=m["tokens_per_s"],
                    step_ms_p50=float(np.median(step_ms)), counts=counts, graph=census, n_samples=n_samples,
                    attrib_launches=at.launches, samples=checks, summary=summ, embed_us=embed_us,
                    head_us=head_us, n_events=len(tr), state_copy_mib=sum(
                        t.numel() * t.element_size() for t in at._pre.values()) / 2**20)
    eng.close()
    del eng, at, prog
    torch.cuda.empty_cache()
    print(f"  (a) C=1 traced, attributed every {every} steps: {steps} steps, {m['tokens_per_s']:.1f} tok/s, step "
          f"p50 {out['a']['step_ms_p50']:.2f} ms (sampled steps included), {n_samples} samples; rows and tokens "
          f"bit-identical to the untraced run; launches {counts}; one capture; gate clean; {len(tr)} events; "
          f"summed segments / one step replay: min {min(ratios):.3f}, max {max(ratios):.3f}; head rows equal "
          f"the step's logits; state copy {out['a']['state_copy_mib']:.0f} MiB", flush=True)
    print(f"  (a) per layer (mean of {n_samples} samples, {card.name}, {card.power_limit}): embed "
          f"{embed_us:.1f} us, head {head_us:.1f} us", flush=True)
    for r in summ["layers"]:
        print(f"    layer{r['index']:02d} {r['pair']}: {1e6 * r['mean_seconds']:8.1f} us, share "
              f"{r['mean_share']:.4f}", flush=True)
    for r in summ["pairs"]:
        print(f"    pair {r['pair']}: {r['n_layers']} layers, {1e6 * r['mean_seconds']:.1f} us, share "
              f"{r['mean_share']:.4f}", flush=True)

    # (b) phase 17 (a)'s chaos run, traced, attributed every 16 steps
    every_b = ATTRIB_EVERY["b"]
    ecfg_a, prompts, new_a = chaos_configs(ecfg, prompts4)["a"]
    ecfg_b = dataclasses.replace(chaos_ecfg(ecfg_a, "a-traced", True, True), obs=ObsConfig(attrib_every=every_b))
    eng = Engine(cfg, params, ecfg_b, head=head)
    tr_b = TraceRecorder()
    r = chaos_serve(torch, eng, prompts, new_a, CHAOS_FAULTS["a"], trace=tr_b)
    n_b = len(eng._attrib.samples)
    summ_b = eng._attrib.summary()
    head_b_us = float(np.mean([s["head_seconds"] for s in eng._attrib.samples])) * 1e6 if n_b else None
    r["graph"] = check_chaos_run(torch, r, eng, per_step, "(b) traced chaos")
    del eng
    d_b = tr_b.to_chrome()
    errs = ci.check_trace(d_b)
    check(errs == [], f"(b): the trace gate: {errs}")
    injected = {f: sum(1 for e in d_b["traceEvents"] if e["name"] == f"inject_{f}") for f in r["m"]["injected"]}
    check(injected == r["m"]["injected"], f"(b): inject_* instants {injected} != injected {r['m']['injected']}")
    terminal = [e["id"] for e in d_b["traceEvents"] if e.get("ph") == "e" and e["name"] == "request"]
    check(sorted(terminal) == sorted(q.rid for q in r["reqs"]), f"(b): terminal spans {sorted(terminal)}")
    want = chaos["a"]["chaos"]["decisions"]
    check(r["decisions"] == want, f"(b): decisions {r['decisions']} differ from phase 17's {want}")
    check(n_b >= 1, "(b): no attribution sample")
    layer_b_us = [1e6 * x["mean_seconds"] for x in summ_b["layers"]]
    out["b"] = dict(steps=r["m"]["steps"], injected=r["m"]["injected"], n_samples=n_b, n_events=len(tr_b),
                    step_ms_p50=r["step_ms_p50"], counts=r["counts"], decisions=r["decisions"], summary=summ_b,
                    head_us=head_b_us)
    print(f"  (b) C={CHUNK} on demand under chaos, traced, attributed every {every_b} steps: {r['m']['steps']} steps, "
          f"injected {r['m']['injected']} with as many inject_* instants, one terminal span for each of "
          f"{len(terminal)} requests, {n_b} samples, {len(tr_b)} events; decisions equal phase 17's", flush=True)
    print(f"  (b) per layer at C={CHUNK} (mean of {n_b} samples, prefill and decode steps): {min(layer_b_us):.1f}-"
          f"{max(layer_b_us):.1f} us, {sum(layer_b_us):.1f} us in all; head {head_b_us:.1f} us", flush=True)

    # (c) (a)'s cell in run(max_steps=k) slices, read between them
    eng = Engine(cfg, params, ecfg, head=head)
    for p in prompts4:
        eng.submit(p, new)
    eng.warmup()
    readings = []
    while eng._pending or not eng.scheduler.all_done():
        eng.run(realtime=True, max_steps=eng.n_steps + OBS_SLICE_STEPS)
        live, text = eng.live_metrics(), eng.prometheus_text()
        errs = check_exposition(text)
        check(errs == [], f"(c): the exposition after {eng.n_steps} steps: {errs}")
        readings.append(dict(steps=live["steps"], tokens_per_s_window=live["tokens_per_s_window"],
                             steps_per_s_window=live["steps_per_s_window"], active_slots=live["active_slots"],
                             queue_depth=live["queue_depth"], free_pages=live["free_pages"],
                             steps_total=eng.registry.counter("repro_steps_total").value(),
                             tokens_total=eng.registry.counter("repro_generated_tokens_total").value()))
    eng.close()
    del eng, params, head
    torch.cuda.empty_cache()
    check(len(readings) >= 3, f"(c): {len(readings)} slices")
    mid = readings[:-1]
    check([x["steps"] for x in readings] == sorted({x["steps"] for x in readings}),
          "(c): the step count did not grow between slices")
    # C = 1 prefills the 16-64-token prompts a token a step, so the first
    # slice may sample no token: the token window moves in later slices
    check(all(x["steps_per_s_window"] > 0 and x["active_slots"] > 0 for x in mid)
          and any(x["tokens_per_s_window"] for x in mid)
          and len({x["tokens_per_s_window"] for x in readings}) > 1
          and len({x["free_pages"] for x in readings}) > 1, f"(c): a mid-run window or gauge did not move: {mid}")
    tokens = [x["tokens_total"] for x in readings]
    check(tokens == sorted(tokens) and tokens[-1] == len(prompts4) * new,
          f"(c): repro_generated_tokens_total {tokens}, not rising to {len(prompts4) * new}")
    check(readings[-1]["active_slots"] == 0 and readings[-1]["free_pages"] > min(x["free_pages"] for x in mid),
          "(c): the gauges did not return when the run drained")
    check(all(x["steps_total"] == x["steps"] for x in readings), "(c): repro_steps_total lags the steps")
    out["c"] = readings
    out["phase_s"] = time.monotonic() - t_phase
    print(f"  (c) {len(readings)} slices of {OBS_SLICE_STEPS} steps: steps "
          f"{[x['steps'] for x in readings]}, tok/s in the window "
          f"{[round(x['tokens_per_s_window'] or 0, 1) for x in readings]}, active slots "
          f"{[x['active_slots'] for x in readings]}, free pages {[x['free_pages'] for x in readings]}; every "
          f"exposition conforms", flush=True)
    print(f"  phase 18 on {card.name} ({card.power_limit}): {out['phase_s']:.1f} s", flush=True)
    report["obs"] = out
    return out


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
    ptx = {k: ptxas_kernels(reports[lib], k) for k, lib in (
        ("packed_ring_kernel", "packed_matmul"), ("quant_packed_mma_kernel", "quant_matmul"),
        ("quant_mma_kernel", "quant_matmul"), ("filter_tile_kernel", "filter_conv"))}
    report["ptxas"] = ptx
    for kernel, rows in ptx.items():
        for r in rows:
            args = ", ".join(f"{k}={r[k]}" for k in PTXAS_KERNELS[kernel][1])
            print(f"  {kernel} {args}: {r['registers']} registers, {r['smem']} B static smem (+ "
                  f"dynamic), spills {r['spill_stores']}/{r['spill_loads']} B", flush=True)
    for kernel, lib, n in (("packed_ring_kernel", "packed_matmul", 32),
                           ("quant_packed_mma_kernel", "quant_matmul", 6),
                           ("quant_mma_kernel", "quant_matmul", 12),
                           ("filter_tile_kernel", "filter_conv", 12)):
        check(not reports[lib] or len(ptx[kernel]) == n,
              f"expected {n} {kernel} instantiations, ptxas showed {len(ptx[kernel])}")
    # the instantiations the served path (K1) and phases 6-7 launch must not spill
    served = ([r for r in ptx["packed_ring_kernel"] if (r["n_seg"], r["overlap"], r["fused"]) == (2, 1, 1)]
              + [r for r in ptx["quant_packed_mma_kernel"] if r["copy"] == 16]
              + [r for r in ptx["quant_mma_kernel"] if r["copy"] == 16 and r["bm"] in (8, 128)]
              + [r for r in ptx["filter_tile_kernel"]
                 if (r["nseg"], r["overlap"], r["v2"]) in ((4, 1, 1), (3, 0, 1), (2, 1, 1), (4, 1, 0))])
    check(all(r["spill_stores"] == r["spill_loads"] == 0 for r in served),
          "a served K1, phase-6 K4 or K5 or phase-7 K6 instantiation spills registers")
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

    def peak(phase: str) -> None:
        """Print and keep the phase's peak device memory, then start the next."""
        gb = torch.cuda.max_memory_allocated() / 1e9
        report.setdefault("peak_mem_gb", {})[phase] = gb
        print(f"  phase {phase} peak device memory {gb:.2f} GB", flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    print("phase 2: K1/K2 vs plain at the full-width decode shapes", flush=True)
    mm = phase_matmul(torch, card, timer, cfg, ecfg.n_slots, report)
    print(f"  K1 at the chunked step's rows (M = {ecfg.n_slots} x {CHUNK}):", flush=True)
    mm_chunk = phase_matmul_chunk(torch, card, timer, cfg, ecfg.n_slots * CHUNK, report)
    peak("2")
    print("phase 3: K3 vs plain at the engine geometry and a long-context one", flush=True)
    ga = phase_gather(torch, card, timer, cfg, ecfg, report)
    del timer
    peak("3")
    print("phase 4: engine, llama3.2-3b full width, w4a4 packed, packed (4,4) head, kernel gather, "
          "step captured", flush=True)
    en = phase_engine(torch, cfg, ecfg, report)
    c1 = en.pop("c1")
    peak("4")
    print("phase 5: whole-path cross-check, 2 layers at full width, card vs CPU", flush=True)
    report["crosscheck"] = phase_crosscheck(torch, cfg)
    peak("5")
    timer = Timer(torch)
    print("phase 6: K4/K5 (int8 lane) at the full-width decode shapes, entry points card vs CPU",
          flush=True)
    i8 = phase_int8(torch, card, timer, cfg, ecfg.n_slots, report)
    peak("6")
    print("phase 7: K6 (Filter Packing) at the UltraNet row shapes", flush=True)
    fc = phase_filter(torch, card, timer, report)
    del timer
    peak("7")
    print("phase 8: engine at the default bits (w4a8, (8, 8) head), 2 layers at full width, "
          "card vs CPU", flush=True)
    phase_default_engine(torch, cfg, report)
    peak("8")
    print(f"phase 9: chunked prefill (C={CHUNK}), reserve and on-demand admission, on phase 4's "
          f"weights and prompts, step captured", flush=True)
    ch = phase_chunked(torch, card, cfg, ecfg, c1, en["fused"], report)
    peak("9")
    print(f"phase 10: the captured step against the eager one, C=1 and C={CHUNK}, on phase 4's weights "
          f"and prompts", flush=True)
    phase_capture(torch, card, cfg, ecfg, c1, report)
    peak("10")
    print("phase 11: deployment plans: search, on-card autotune, K1/K2 at the plan's placements, the "
          "tuned plan served at full width beside phase 4's cell, card vs CPU at 3 layers, a uniform "
          "(4, 4) plan against phase 4", flush=True)
    pl = phase_plan(torch, card, cfg, ecfg, c1, report)
    peak("11")
    print("phase 12: int8 KV pools and int8 serving weights at full width: phase 4's cell on int8 pools "
          "beside its bf16 pools, phase 9's on-demand cell on int8 pools, card vs CPU on int8 pools, "
          "quant=\"int8\" beside quant=None", flush=True)
    i8s = phase_int8_serving(torch, card, cfg, ecfg, c1, ch, report)
    peak("12")
    print("phase 13: the request lifecycle at full width on phase 4's weights: deadlines, SLO classes, "
          "cancels and a bounded queue on the virtual clock against the CPU, static against continuous "
          "admission, the same schedule on the wall clock", flush=True)
    lc = phase_lifecycle(torch, card, cfg, ecfg, c1, en["fused"], report)
    prompts4 = c1["prompts"]
    del c1
    peak("13")
    print(f"phase 14: gemma3-1b at full width past its 1024-token window: K1 at its shapes, the serve "
          f"(C={CHUNK}, 8 slots x {GEMMA_MAX_LEN} tokens) on bf16 and int8 KV pools, K3 on the served "
          f"pools, card vs CPU past the window", flush=True)
    gm = phase_gemma(torch, card, report)
    peak("14")
    print(f"phase 15: mamba2-130m at full width (the SSM family): K1 at its shapes, the serve at C={CHUNK} "
          f"(16 slots, 16 x 512-1536-token prompts) and C=1, forced preemption against none with a "
          f"skipped-reset fault, card vs CPU at 2 layers", flush=True)
    mb = phase_mamba(torch, card, report)
    peak("15")
    print(f"phase 16: qwen3-moe-30b-a3b at full width ({MOE_LAYERS} of 48 layers), w4a4 packed experts: K1/K2 "
          f"over the expert grid axis, the serve at C={CHUNK} and C=1 against capture=False, card vs CPU at "
          f"2 layers", flush=True)
    mo = phase_moe(torch, card, report)
    peak("16")
    print(f"phase 17: chaos and snapshots at full width: injected step, allocation and NaN faults, retries, "
          f"quarantine and hard faults restored from snapshots in place, on phase 9's on-demand cell (C={CHUNK}) "
          f"and mamba2-130m (C=1), against the fault-free runs and the CPU's decisions", flush=True)
    cs = phase_chaos(torch, card, cfg, ecfg, prompts4, report)
    peak("17")
    print(f"phase 18: observability at full width: phase 4's cell traced and attributed every "
          f"{ATTRIB_EVERY['a']} steps against an untraced run, phase 17's chaos run traced and attributed "
          f"every {ATTRIB_EVERY['b']} steps against phase 17's decisions, live readings between run(max_steps=) "
          f"slices", flush=True)
    ob = phase_obs(torch, card, cfg, ecfg, prompts4, cs, report)
    peak("18")

    # per-decode-step totals per kernel: the sum over the launches of one step
    def step_sum(rows, key):
        return sum(r[key] * r["per_step"] for r in rows)

    served = [r for r in mm["rows"] if r["placement"] == "w4a4 overlap=1"]
    layers = [r for r in served if r["shape"] != "head"]
    head = [r for r in served if r["shape"] == "head"]

    def k3_rows(case, chunk, geometry="served"):
        return [r for r in ga["rows"] if (r["geometry"], r["case"], r["chunk"]) == (geometry, case, chunk)]

    gather = k3_rows("bf16 pool, full causal", 1)
    gather_chunk = k3_rows("bf16 pool, full causal", CHUNK)
    gather_i8 = k3_rows("int8 pool -> bf16, full causal", 1)
    gather_i8_chunk = k3_rows("int8 pool -> bf16, full causal", CHUNK)
    # K3 per launch at the long-context geometry, full causal (window 40's
    # rows are in the report)
    gather_long = [dict(case=r["case"], chunk=r["chunk"], ms=r["k3_graph_ms"], events_ms=r["k3_ms"],
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        fraction_of_bound=r["fraction_of_bound"],
                        library_ms=r.get("dequant_graph_ms", r["library_graph_ms"]))
                   for case in ("bf16 pool, full causal", "int8 pool -> bf16, full causal")
                   for chunk in (1, CHUNK) for r in k3_rows(case, chunk, "long")]
    long0 = k3_rows("int8 pool -> bf16, full causal", 1, "long")[0]
    i8_first = next(t for t in i8s["a"]["turns"] if t["cell"] == "int8 KV")
    chunk_step = mm_chunk["rows"] + head  # a chunked step: the layers at M = 128, the head at M = 8
    gemma_k1 = gm["k1"]["rows"]  # phase 14's chunked step: the layers at M = 128, the head at M = 8
    mamba_k1 = mb["k1"]["rows"]  # phase 15's C = 16 step: 16 lanes x 24 layers x 3 and the head, M = 16
    # phase 16's batched expert products a step (the layers' experts; the
    # attention projections and head are K1's 2-D launches), M = 12 at C = 16
    moe_k = [r for r in mo["k1"]["rows"] if r["M"] == max(MOE_KERNEL_M)]
    moe_k1_decode = [r for r in mo["k1"]["rows"] if r["M"] == min(MOE_KERNEL_M)]
    chunked_launches = {k: {admit: r["counts"][k] for admit, r in ch.items()}
                        for k in ("packed_dense_fused", "paged_gather")}

    def by_t(rows, weight):
        t_b = sum(r["t_bytes"] * weight(r) for r in rows)
        t_o = sum(r["t_ops"] * weight(r) for r in rows)
        return "bytes" if t_b >= t_o else "operations"

    def once(rows, key):
        return sum(r[key] for r in rows)

    def by_gbps(rows, key):  # achieved bytes per second over a step's launches
        return sum(r["bytes"] * r["per_step"] for r in rows) / step_sum(rows, key) / 1e6

    # each kernel's launches come from the run of the path it serves: K1 and
    # K3 from the fused (whole-K) run, K2 from the block_k=512 run, K4-K6 from
    # their entry points' runs in phases 6 and 7 (no engine path runs them)
    fused, blocked = en["fused"], en["blocked"]
    k4 = [r for r in i8["rows"] if r["kernel"] == "quant_matmul"]
    k5 = [r for r in i8["rows"] if r["kernel"] == "quant_packed_matmul" and r["pair"] == "w2a2"]
    k5_w2a3 = [r for r in i8["rows"] if r["kernel"] == "quant_packed_matmul" and r["pair"] == "w2a3"]
    k6 = fc["rows"]
    kernels = [
        dict(name="packed_dense_fused", route="cuda", source="src/repro_torch/csrc/packed_matmul.cu",
             replaces="src/repro/kernels/packed_matmul/kernel.py:111",
             launches=fused["counts"]["packed_dense_fused"],
             max_abs_err=max(mm["max_err"], mm_chunk["max_err"], gm["k1"]["max_err"], mb["k1"]["max_err"],
                             mo["k1"]["max_err"]),
             ms=step_sum(served, "k1_graph_ms"), events_ms=step_sum(served, "k1_ms"),
             plain_ms=step_sum(served, "plain_ms"),
             bound_ms=step_sum(served, "bound_ms"), bound_by=by_t(served, lambda r: r["per_step"]),
             library_ms=step_sum(served, "int_mm_graph_ms"), library="torch._int_mm, M padded to 32",
             bf16_ms=step_sum(served, "bf16_graph_ms"), gbps=by_gbps(served, "k1_graph_ms"),
             path="fused", path_steps=fused["steps"],
             per="decode step", timing=GRAPH_TIMING,
             chunk_step_ms=step_sum(chunk_step, "k1_graph_ms"),
             chunk_step_plain_ms=step_sum(chunk_step, "plain_ms"),
             chunk_step_bound_ms=step_sum(chunk_step, "bound_ms"), chunk_step_bound_by=by_t(chunk_step, lambda r: r["per_step"]),
             chunk_step_library_ms=step_sum(chunk_step, "int_mm_graph_ms"),
             chunk_step_gbps=by_gbps(chunk_step, "k1_graph_ms"),
             chunk_step=f"chunked step: the layers at M = {ecfg.n_slots * CHUNK}, the head at M = {ecfg.n_slots}",
             launches_chunked=chunked_launches["packed_dense_fused"],
             steps_chunked={admit: r["steps"] for admit, r in ch.items()},
             launches_lifecycle=lc["a"]["counts"]["packed_dense_fused"], steps_lifecycle=lc["a"]["steps"],
             launches_chaos=cs["a"]["chaos"]["counts"]["packed_dense_fused"], steps_chaos=cs["a"]["chaos"]["steps"],
             launches_obs=ob["a"]["counts"]["packed_dense_fused"], steps_obs=ob["a"]["steps"],
             launches_obs_attrib=ob["a"]["attrib_launches"]["packed_dense_fused"],
             samples_obs=ob["a"]["n_samples"],
             launches_chaos_mamba=cs["b"]["chaos"]["counts"]["packed_dense_fused"],
             steps_chaos_mamba=cs["b"]["chaos"]["steps"],
             launches_gemma=gm["a"]["counts"]["packed_dense_fused"], steps_gemma=gm["a"]["steps"],
             gemma=dict(
                 per="gemma3-1b chunked step (phase 14): the layers at M = 128, the head at M = 8",
                 ms=step_sum(gemma_k1, "k1_graph_ms"), events_ms=step_sum(gemma_k1, "k1_ms"),
                 plain_ms=step_sum(gemma_k1, "plain_ms"), bound_ms=step_sum(gemma_k1, "bound_ms"),
                 bound_by=by_t(gemma_k1, lambda r: r["per_step"]),
                 library_ms=step_sum(gemma_k1, "int_mm_graph_ms"), library="torch._int_mm, M padded to 32",
                 gbps=by_gbps(gemma_k1, "k1_graph_ms"), max_abs_err=gm["k1"]["max_err"]),
             launches_mamba=mb["C=16"]["counts"]["packed_dense_fused"], steps_mamba=mb["C=16"]["steps"],
             launches_mamba_c1=mb["C=1"]["counts"]["packed_dense_fused"], steps_mamba_c1=mb["C=1"]["steps"],
             mamba=dict(
                 per="mamba2-130m C = 16 step (phase 15): in_z, in_xbc and out_proj of 24 layers in each of "
                     "16 lanes and the head, all at M = 16",
                 ms=step_sum(mamba_k1, "k1_graph_ms"), events_ms=step_sum(mamba_k1, "k1_ms"),
                 plain_ms=step_sum(mamba_k1, "plain_ms"), bound_ms=step_sum(mamba_k1, "bound_ms"),
                 bound_by=by_t(mamba_k1, lambda r: r["per_step"]),
                 library_ms=step_sum(mamba_k1, "int_mm_graph_ms"), library="torch._int_mm, M padded to 32",
                 gbps=by_gbps(mamba_k1, "k1_graph_ms"), max_abs_err=mb["k1"]["max_err"]),
             launches_moe=mo["C=16"]["counts"]["packed_dense_fused"], steps_moe=mo["C=16"]["steps"],
             launches_moe_c1=mo["C=1"]["counts"]["packed_dense_fused"], steps_moe_c1=mo["C=1"]["steps"],
             moe=dict(
                 per=f"qwen3-moe-30b-a3b step (phase 16, {MOE_LAYERS} layers): the batched expert products "
                     f"(128 experts, w_up|w_gate 2048x768, w_down 768x2048) at M = 12 a bucket (C = 16); "
                     f"*_decode at M = 1 (C = 1); one launch a projection",
                 ms=step_sum(moe_k, "k1_graph_ms"), events_ms=step_sum(moe_k, "k1_ms"),
                 plain_ms=step_sum(moe_k, "plain_ms"), bound_ms=step_sum(moe_k, "bound_ms"),
                 bound_by=by_t(moe_k, lambda r: r["per_step"]),
                 library_ms=step_sum(moe_k, "bmm_graph_ms"),
                 library="torch.bmm in bf16 (not the same rounding)",
                 gbps=by_gbps(moe_k, "k1_graph_ms"),
                 ms_decode=step_sum(moe_k1_decode, "k1_graph_ms"),
                 bound_ms_decode=step_sum(moe_k1_decode, "bound_ms"),
                 library_ms_decode=step_sum(moe_k1_decode, "bmm_graph_ms"),
                 max_abs_err=mo["k1"]["max_err"])),
        dict(name="packed_matmul", route="cuda", source="src/repro_torch/csrc/packed_matmul.cu",
             replaces="src/repro/kernels/packed_matmul/kernel.py:168",
             launches=blocked["counts"]["packed_matmul"], max_abs_err=max(mm["max_err"], mo["k1"]["max_err"]),
             ms=step_sum(layers, "k2_graph_ms"), events_ms=step_sum(layers, "k2_ms"),
             plain_ms=step_sum(layers, "plain_ms"),
             bound_ms=step_sum(layers, "bound_ms"), bound_by=by_t(layers, lambda r: r["per_step"]),
             library_ms=step_sum(layers, "int_mm_graph_ms"), library="torch._int_mm, M padded to 32",
             bf16_ms=step_sum(layers, "bf16_graph_ms"), gbps=by_gbps(layers, "k2_graph_ms"),
             path="block_k=512",
             path_steps=blocked["steps"], per="decode step", timing=GRAPH_TIMING,
             moe=dict(
                 per=f"phase 16's batched expert products at block_k {MOE_BLOCK_K}, a step of {MOE_LAYERS} "
                     f"layers at M = 12 (checked on the card, not served)",
                 ms=step_sum(moe_k, "k2_graph_ms"), events_ms=step_sum(moe_k, "k2_ms"),
                 plain_ms=step_sum(moe_k, "k2_plain_ms"), bound_ms=step_sum(moe_k, "bound_ms"),
                 library_ms=step_sum(moe_k, "bmm_graph_ms"),
                 library="torch.bmm in bf16 (not the same rounding)")),
        dict(name="paged_gather", route="cuda", source="src/repro_torch/csrc/paged_gather.cu",
             replaces="src/repro/kernels/paged_gather/kernel.py:121",
             launches=fused["counts"]["paged_gather"], max_abs_err=max(ga["max_err"], gm["c"]["max_err"]),
             ms=step_sum(gather, "k3_graph_ms"), events_ms=step_sum(gather, "k3_ms"),
             plain_ms=step_sum(gather, "plain_ms"),
             bound_ms=step_sum(gather, "bound_ms"), bound_by="bytes",
             library_ms=step_sum(gather, "library_graph_ms"),
             library_events_ms=step_sum(gather, "library_ms"), path="fused", path_steps=fused["steps"],
             per="decode step", timing=GRAPH_TIMING,
             chunk_step_ms=step_sum(gather_chunk, "k3_graph_ms"),
             chunk_step_plain_ms=step_sum(gather_chunk, "plain_ms"),
             chunk_step_bound_ms=step_sum(gather_chunk, "bound_ms"),
             chunk_step_library_ms=step_sum(gather_chunk, "library_graph_ms"),
             chunk_step=f"chunked step: chunk = {CHUNK}",
             launches_chunked=chunked_launches["paged_gather"],
             launches_lifecycle=lc["a"]["counts"]["paged_gather"], steps_lifecycle=lc["a"]["steps"],
             launches_chaos=cs["a"]["chaos"]["counts"]["paged_gather"], steps_chaos=cs["a"]["chaos"]["steps"],
             launches_obs=ob["a"]["counts"]["paged_gather"], steps_obs=ob["a"]["steps"],
             launches_obs_attrib=ob["a"]["attrib_launches"]["paged_gather"], samples_obs=ob["a"]["n_samples"],
             launches_gemma=gm["a"]["counts"]["paged_gather"], steps_gemma=gm["a"]["steps"],
             launches_gemma_int8=gm["b"]["counts"]["paged_gather"],
             launches_moe=mo["C=16"]["counts"]["paged_gather"], steps_moe=mo["C=16"]["steps"],
             gemma=dict(
                 per="launch on phase 14's served pools and block table, every slot decoding",
                 **{k: gm["c"][k] for k in ("live_pages", "positions", "max_err", "window_drops")},
                 rows=[{k: r[k] for k in ("pool", "window", "chunk", "k3_graph_ms", "k3_warm_graph_ms", "k3_ms",
                                          "plain_ms", "bound_ms", "bound_by", "fraction_of_bound",
                                          "library_graph_ms")}
                       | ({"dequant_graph_ms": r["dequant_graph_ms"]} if "dequant_graph_ms" in r else {})
                       for r in gm["c"]["rows"]]),
             instantiations={"gather_fp": "bf16 pools: phases 4, 9, 10, 11, 12 (a) bf16 turns, 12 (d)",
                             "gather_i8<true>": "int8 pools, bf16 views: phase 12 (a), (b)",
                             "gather_i8<false>": "int8 pools, float32 views: phase 12 (c)"},
             int8_pool=dict(
                 launches=i8_first["counts"]["paged_gather"], path_steps=i8_first["steps"],
                 path="phase 12 (a), first int8 KV turn",
                 ms=step_sum(gather_i8, "k3_graph_ms"), events_ms=step_sum(gather_i8, "k3_ms"),
                 plain_ms=step_sum(gather_i8, "plain_ms"), bound_ms=step_sum(gather_i8, "bound_ms"),
                 bound_by="bytes", library_ms=step_sum(gather_i8, "dequant_graph_ms"),
                 library="pool[table].to(bf16) * scale[table].to(bf16), K and V",
                 levels_only_ms=step_sum(gather_i8, "library_graph_ms"),
                 chunk_step_ms=step_sum(gather_i8_chunk, "k3_graph_ms"),
                 chunk_step_plain_ms=step_sum(gather_i8_chunk, "plain_ms"),
                 chunk_step_bound_ms=step_sum(gather_i8_chunk, "bound_ms"),
                 chunk_step_library_ms=step_sum(gather_i8_chunk, "dequant_graph_ms"),
                 launches_chunked={k: r["counts"]["paged_gather"] for k, r in i8s["b"].items()
                                   if "counts" in r}),
             long_context=dict(
                 **{k: long0[k] for k in ("S", "n_blocks", "page_size", "D", "live_pages")},
                 live_tokens=LONG_GATHER["lengths"], per="launch",
                 library="pool[table]; int8 pools: the gather, then the dequantization", rows=gather_long)),
        dict(name="quant_matmul", route="cuda", source="src/repro_torch/csrc/quant_matmul.cu",
             replaces="src/repro/kernels/quant_matmul/kernel.py:63",
             launches=i8["counts"]["quant_matmul"], max_abs_err=i8["max_err"]["quant_matmul"],
             ms=step_sum(k4, "ms"), events_ms=step_sum(k4, "events_ms"), plain_ms=step_sum(k4, "plain_ms"),
             bound_ms=step_sum(k4, "bound_ms"), bound_by=by_t(k4, lambda r: r["per_step"]),
             library_ms=step_sum(k4, "library_ms"), gbps=by_gbps(k4, "ms"), path="quant_dense, phase 6",
             per="decode step at M=8 (W8A8 at every projection and the head)", timing=GRAPH_TIMING),
        dict(name="quant_packed_matmul", route="cuda", source="src/repro_torch/csrc/quant_matmul.cu",
             replaces="src/repro/kernels/quant_matmul/kernel.py:103",
             launches=i8["counts"]["quant_packed_matmul"],
             max_abs_err=i8["max_err"]["quant_packed_matmul"],
             ms=step_sum(k5, "ms"), events_ms=step_sum(k5, "events_ms"), plain_ms=step_sum(k5, "plain_ms"),
             bound_ms=step_sum(k5, "bound_ms"), bound_by=by_t(k5, lambda r: r["per_step"]),
             library_ms=step_sum(k5, "library_ms"), path="quant_packed_dense, phase 6",
             per="decode step at M=8, w2a2 (the w2a3 step beside it, *_w2a3)", timing=GRAPH_TIMING,
             ms_w2a3=step_sum(k5_w2a3, "ms"), events_ms_w2a3=step_sum(k5_w2a3, "events_ms"),
             plain_ms_w2a3=step_sum(k5_w2a3, "plain_ms"), bound_ms_w2a3=step_sum(k5_w2a3, "bound_ms"),
             library_ms_w2a3=step_sum(k5_w2a3, "library_ms"),
             gbps=by_gbps(k5, "ms"), gbps_w2a3=by_gbps(k5_w2a3, "ms")),
        dict(name="filter_conv", route="cuda", source="src/repro_torch/csrc/filter_conv.cu",
             replaces="src/repro/kernels/filter_conv/kernel.py:155",
             launches=fc["counts"]["filter_conv"], max_abs_err=fc["max_err"],
             ms=once(k6, "ms"), events_ms=once(k6, "events_ms"), plain_ms=once(k6, "plain_ms"),
             bound_ms=once(k6, "bound_ms"),
             bound_by=by_t(k6, lambda r: 1), library_ms=once(k6, "library_ms"),
             path="packed_conv1d, phase 7",
             per=f"the {len(k6)} launches of phase 7, one each, summed", timing=GRAPH_TIMING),
    ]
    # K1/K2 at the tuned plan's placements: launches from the plan's first
    # timed run (its counters equal its per-step counts times its steps)
    plan_steps = pl["first"]["steps"]
    for (kernel, pair), rows in itertools.groupby(pl["kernels"], key=lambda r: (r["kernel"], r["pair"])):
        rows = list(rows)
        line = 111 if kernel == "packed_dense_fused" else 168
        kernels.append(dict(
            name=f"{kernel} ({pair}, plan)", route="cuda", source="src/repro_torch/csrc/packed_matmul.cu",
            replaces=f"src/repro/kernels/packed_matmul/kernel.py:{line}",
            launches=sum(r["per_step"] for r in rows) * plan_steps,
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=step_sum(rows, "graph_ms"),
            events_ms=step_sum(rows, "events_ms"), plain_ms=step_sum(rows, "plain_ms"),
            bound_ms=step_sum(rows, "bound_ms"), bound_by=by_t(rows, lambda r: r["per_step"]),
            library_ms=step_sum(rows, "int_mm_graph_ms"), library="torch._int_mm, M padded to 32",
            gbps=by_gbps(rows, "graph_ms"), placement=rows[0]["placement"], path="plan",
            path_steps=plan_steps, per=f"decode step of the tuned plan (its {pair} projections)",
            timing=GRAPH_TIMING))
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
