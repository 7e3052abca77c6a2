#!/usr/bin/env python3
"""Time chip_smoke.py phase 4's served cell against phase 13's realtime
lifecycle cell on one card, in alternating turns, in one process.

    python3 perf/ab_lifecycle.py [--pairs 5] [--out FILE]

Both cells serve the same packed weights (llama3.2-3b at full width,
w4a4 projections, the packed (4, 4) head, the kernel gather, 8 slots, page
16, max_len 256, C = 1, reserve admission, random weights from seed 0)
through a fresh engine per turn whose step is one captured CUDA graph.
"plain" serves phase 4's 8 requests (16-64 prompt, 32 new tokens) with no
hook set; "lifecycle" serves phase 13's 20-request schedule
(``chip_smoke.lifecycle_schedule``, ``max_waiting=6``) on the wall clock,
one step unit = the first plain turn's step p50, its cancels armed on the
sample hook.  Turns alternate plain, lifecycle, lifecycle, plain, ...
Each turn prints its step p50 and min, and the device time of one replay
of its graph (``chip_smoke.graph_replay_ms``), so that the host's share of
a step (p50 minus replay) can be told from the device's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.serving import Engine, EngineConfig, build_engine

    if not torch.cuda.is_available():
        raise SystemExit("ab_lifecycle: no CUDA device")
    build.build_all(("packed_matmul", "paged_gather"))
    card = cs.smi("name,power.limit")
    cfg = get_config("llama3.2-3b")
    ecfg = EngineConfig(n_slots=8, page_size=16, max_len=256, chunk_tokens=1, admit="reserve",
                        packed_head=True, head_bits=(4, 4), gather_backend="kernel")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(16, 65))).tolist() for _ in range(8)]
    packed = build_engine(cfg, ecfg, quant="packed", w_bits=4, a_bits=4, seed=0)
    params, head = packed.params, packed._head
    packed.close()
    schedule = cs.lifecycle_schedule(prompts, cfg.vocab)
    unit = None
    turns = []
    order = [c for k in range(args.pairs) for c in (("plain", "lifecycle") if k % 2 == 0
                                                     else ("lifecycle", "plain"))]
    for i, cell in enumerate(order):  # the first turn is plain, and sets the unit
        e = ecfg if cell == "plain" else dataclasses.replace(ecfg, max_waiting=cs.LIFE_MAX_WAITING)
        eng = Engine(cfg, params, e, head=head)
        eng.warmup()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if cell == "plain":
            for p in prompts:
                eng.submit(p, 32)
            m = eng.run(realtime=True)
        else:
            m, _ = cs.serve_schedule(eng, schedule, unit=unit, realtime=True)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        step_ms = [1e3 * s for s in eng.step_seconds]
        replay = cs.graph_replay_ms(torch, eng)
        eng.close()
        del eng
        torch.cuda.empty_cache()
        t = dict(turn=i + 1, cell=cell, steps=m["steps"], statuses=m["statuses"], wall_s=wall,
                 step_ms_p50=float(np.median(step_ms)), step_ms_min=min(step_ms), replay_ms=replay)
        t["host_ms"] = t["step_ms_p50"] - replay
        if unit is None:
            unit = t["step_ms_p50"] / 1e3
        turns.append(t)
        print(f"turn {i + 1} {cell:9s}: {t['steps']} steps, step p50 {t['step_ms_p50']:.2f} ms (min "
              f"{t['step_ms_min']:.2f}), one replay {replay:.2f} ms, host {t['host_ms']:.2f} ms, statuses "
              f"{t['statuses']}; {card}", flush=True)
    med = {cell: {k: float(np.median([t[k] for t in turns if t["cell"] == cell]))
                  for k in ("step_ms_p50", "replay_ms", "host_ms")} for cell in ("plain", "lifecycle")}
    print(json.dumps({"medians": med, "card": card}))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(card=card, unit_s=unit, turns=turns, medians=med), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
