#!/usr/bin/env python3
"""Time the served engine run (chip_smoke.py phase 4) of several checkouts
on one card, in turns.

    python3 perf/ab_engine.py --trees OLD NEW NEW OLD OLD NEW NEW OLD [--out FILE]

Each tree is a repository root (this checkout, or an older commit unpacked
with ``git archive``).  Each turn runs in a process of its own, builds that
tree's K1 and K3 libraries, and serves phase 4's cell through the tree's
own ``build_engine``: llama3.2-3b at full width, w4a4 packed projections,
the packed (4, 4) head, the kernel gather, 8 slots, page 16, max_len 256,
C = 1, reserve admission, random weights from seed 0, 8 prompts of 16-64
tokens from seed 0, 32 new tokens each.  Only the public engine API is
called with its defaults (a tree whose engine captures its step in a CUDA
graph does so) and no hook is set, so every tree runs the same timed code
it ships.  Prints one line per turn (step p50, tok/s, TTFT p50, steps,
whether the step was captured, launches and a digest of the tokens), then
the step p50 of each tree's turns, and writes everything to ``--out``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path


def worker(root: Path) -> dict:
    sys.path[:0] = [str(root / "src")]
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.serving import EngineConfig, build_engine

    if not torch.cuda.is_available():
        raise SystemExit("ab_engine: no CUDA device")
    build.build_all(("packed_matmul", "paged_gather"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = get_config("llama3.2-3b")
    ecfg = EngineConfig(n_slots=8, page_size=16, max_len=256, chunk_tokens=1, admit="reserve",
                        packed_head=True, head_bits=(4, 4), gather_backend="kernel")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(16, 65))).tolist() for _ in range(8)]
    eng = build_engine(cfg, ecfg, quant="packed", w_bits=4, a_bits=4, seed=0)
    for p in prompts:
        eng.submit(p, 32)
    eng.warmup()
    torch.cuda.synchronize()
    build.reset_counts()
    t0 = time.monotonic()
    m = eng.run(realtime=True)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    tokens = sorted((r.rid, list(r.out_tokens)) for r in eng.finished)
    step_ms = [1e3 * s for s in eng.step_seconds]
    program = getattr(eng, "_program", None)  # absent in trees from before the captured step
    return dict(tree=str(root), card=card, steps=m["steps"], statuses=m["statuses"], wall_s=wall,
                tokens_per_s=m["tokens_per_s"], step_ms_p50=float(np.median(step_ms)),
                step_ms_min=min(step_ms), step_ms=step_ms, ttft_ms_p50=1e3 * m["ttft_p50"],
                captured=program is not None and program.graph is not None, counts=build.counts(),
                tokens_sha=hashlib.sha256(json.dumps(tokens).encode()).hexdigest()[:16])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=Path, help="repository roots, run in this order")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker.resolve())))
        return 0
    turns = []
    for i, root in enumerate(args.trees):
        out = subprocess.run([sys.executable, __file__, "--worker", str(root)], capture_output=True,
                             text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        t = json.loads(out.stdout.strip().splitlines()[-1])
        turns.append(dict(turn=i + 1, **t))
        print(f"turn {i + 1} {t['tree']}: {t['steps']} steps, step p50 {t['step_ms_p50']:.2f} ms "
              f"(min {t['step_ms_min']:.2f}), {t['tokens_per_s']:.1f} tok/s, TTFT p50 "
              f"{t['ttft_ms_p50']:.1f} ms, captured {t['captured']}, statuses {t['statuses']}, "
              f"launches {t['counts']}, tokens {t['tokens_sha']}; {t['card']}", flush=True)
    by_tree: dict[str, list] = {}
    for t in turns:
        by_tree.setdefault(t["tree"], []).append(round(t["step_ms_p50"], 2))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(turns, indent=1))
    print(json.dumps({"step_ms_p50_by_tree": by_tree}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
