#!/usr/bin/env python3
"""Time K1 and K2 of two checkouts on one card, in turns.

    python3 perf/ab_packed_matmul.py --trees OLD NEW NEW OLD [--out FILE]

Each tree is a repository root (this checkout, or an older commit unpacked
with ``git archive``).  Each turn runs in a process of its own, builds that
tree's ``packed_matmul`` library and times its K1 (``packed_dense_fused``)
and K2 (``packed_matmul``, block_k=512) at every full-width llama3.2-3b
decode shape (M = 8, w4a4 overpacked, and the no-overpack placement at
wq|wo and w_down), with that tree's own ``chip_smoke.py`` CUDA-graph timer
and cold weights, the operands made from the same seeds in every turn.
Prints one JSON line per turn, then the per-decode-step sums per tree,
and writes everything to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def worker(root: Path) -> dict:
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.packed_matmul import ref as pm
    from repro_torch.kernels.packed_matmul.kernel import packed_dense_fused_raw, packed_matmul_raw
    from repro_torch.kernels.packed_matmul.ops import choose_config

    if not torch.cuda.is_available():
        raise SystemExit("ab_packed_matmul: no CUDA device")
    build.build_all(("packed_matmul",))
    timer = chip_smoke.Timer(torch)
    cfg = get_config("llama3.2-3b")
    over, plain_cfg = choose_config(4, 4), choose_config(4, 4, allow_overpack=False)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    rows = []
    for name, (K, N, per_step) in chip_smoke.decode_matmul_shapes(cfg).items():
        for c, label in ((over, "overlap=1"), (plain_cfg, "overlap=0")):
            if c is plain_cfg and name not in ("wq|wo", "w_down"):
                continue
            x = torch.rand((8, K), generator=g, device="cuda") * 1.2 - 0.1
            w_lvl = torch.randint(0, 16, (K, N), generator=g, device="cuda", dtype=torch.int32)
            wps = chip_smoke.cold_copies(pm.pack_weights(w_lvl, c.n_seg, c.stride))
            del w_lvl
            a_lvl = torch.round(torch.clamp(x, 0, 1) * 15).to(torch.int32)
            kw = dict(n_seg=c.n_seg, stride=c.stride, acc_chunk=c.acc_chunk, overlap=c.overlap)
            rows.append(dict(
                shape=name, placement=label, per_step=per_step,
                k1_ms=timer.graph(lambda i: packed_dense_fused_raw(x, wps[i % len(wps)], a_bits=4, **kw)),
                k2_ms=timer.graph(lambda i: packed_matmul_raw(a_lvl, wps[i % len(wps)], block_k=512, **kw)),
            ))
            del x, a_lvl, wps
            torch.cuda.empty_cache()
    served = [r for r in rows if r["placement"] == "overlap=1"]
    return dict(
        tree=str(root), card=chip_smoke.smi("name,power.limit"), rows=rows,
        k1_step_ms=sum(r["k1_ms"] * r["per_step"] for r in served),
        k2_step_ms=sum(r["k2_ms"] * r["per_step"] for r in served if r["shape"] != "head"),
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=Path, help="repository roots, timed in this order")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker.resolve())))
        return 0
    turns = []
    for root in args.trees:
        out = subprocess.run([sys.executable, __file__, "--worker", str(root)], capture_output=True,
                             text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
        t = turns[-1]
        print(f"{t['tree']}: K1 {t['k1_step_ms']:.4f} ms/step, K2 {t['k2_step_ms']:.4f} ms/step; "
              + ", ".join(f"{r['shape']} {r['placement']} {r['k1_ms']:.4f}/{r['k2_ms']:.4f}"
                          for r in t["rows"]), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(turns, indent=1))
    print(json.dumps([{k: t[k] for k in ("tree", "card", "k1_step_ms", "k2_step_ms")} for t in turns]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
