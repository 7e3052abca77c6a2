#!/usr/bin/env python3
"""Time K3 of two checkouts on one card, in turns.

    python3 perf/ab_paged_gather.py --trees OLD NEW NEW OLD ... [--out FILE]

Each tree is a repository root (this checkout, or an older commit unpacked
with ``git archive``).  Each turn runs in a process of its own, builds that
tree's ``paged_gather`` library and times its K3 (``paged_gather_raw``) by
CUDA graph at phase 3's two geometries (the engine's 8 slots x 16 blocks,
and ``chip_smoke.LONG_GATHER``'s 32 slots x 256 blocks): bf16 pools and int8
pools to bf16 views at one lane and at the chunk width, full causal, and at
the engine's geometry int8 pools to float32 views.  The operands, the
timer and the byte counts are this checkout's (``chip_smoke.gather_operands``,
``Timer.graph``, ``gather_bytes``), made from the same seeds in every turn,
so only the kernel differs between trees; every result is checked against
the tree's plain version once.  Prints one line per turn, then the medians
per tree and case, and writes everything to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(root: Path) -> dict:
    sys.path[:0] = [str(root / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_gather.kernel import paged_gather_plain, paged_gather_raw
    from repro_torch.serving import EngineConfig

    if not torch.cuda.is_available():
        raise SystemExit("ab_paged_gather: no CUDA device")
    build.build_all(("paged_gather",))
    timer = chip_smoke.Timer(torch)
    cfg = get_config("llama3.2-3b")
    ecfg = EngineConfig(n_slots=8, page_size=16, max_len=256)
    ps, D, lg = ecfg.page_size, cfg.kv_heads * cfg.hd, chip_smoke.LONG_GATHER
    geometries = [("served", ecfg.n_slots, ecfg.blocks_per_slot, ecfg.pool_pages(), 1, (17, 96)),
                  ("long", lg["S"], lg["max_len"] // ps, lg["S"] * (lg["max_len"] // ps) + 1, lg["seed"],
                   lg["lengths"])]
    rows = []
    for geometry, S, nb, P, seed, lengths in geometries:
        table, pos, n_live, bf, lv, sc = chip_smoke.gather_operands(torch, S, nb, ps, D, P, seed, lengths)
        cases = [("bf16 pool", (bf[0], bf[1]), (None, None), torch.bfloat16),
                 ("int8 pool -> bf16", (lv[0], lv[1]), (sc[0], sc[1]), torch.bfloat16)]
        if geometry == "served":
            cases.append(("int8 pool -> f32", (lv[0], lv[1]), (sc[0], sc[1]), torch.float32))
        for (label, pools, scales, out), chunk in ((c, ch) for c in cases for ch in (1, chip_smoke.CHUNK)):
            if out == torch.float32 and chunk != 1:
                continue
            args = (table, pos, 0, *pools, *scales)
            kw = dict(chunk=chunk, out_dtype=out)
            got, want = paged_gather_raw(*args, **kw), paged_gather_plain(*args, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"ab_paged_gather: {root}: K3 differs at {geometry} {label} chunk {chunk}")
            del got, want
            nbytes = chip_smoke.gather_bytes(S, nb, ps, D, n_live, chunk, pools[0].element_size(),
                                             scales[0] is not None) + (
                2 * S * nb * ps * D * 2 if out == torch.float32 else 0)  # float32 views: twice the bytes
            ms = timer.graph(lambda i: paged_gather_raw(*args, **kw))
            bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
            rows.append(dict(geometry=geometry, case=label, chunk=chunk, ms=ms, bound_ms=bound,
                             fraction_of_bound=bound / ms, bytes=nbytes, live_pages=n_live))
        del table, pos, bf, lv, sc, cases, args, pools, scales
        torch.cuda.empty_cache()
    return dict(tree=str(root), card=chip_smoke.smi("name,power.limit"), rows=rows)


def key(r: dict) -> str:
    return f"{r['geometry']}, {r['case']}, chunk {r['chunk']}"


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
        print(f"{t['tree']}: " + "; ".join(f"{key(r)} {1e3 * r['ms']:.2f} us ({100 * r['fraction_of_bound']:.0f} %)"
                                           for r in t["rows"]), flush=True)
    medians = {}
    for tree in dict.fromkeys(t["tree"] for t in turns):
        mine = [t for t in turns if t["tree"] == tree]
        medians[tree] = {key(r): statistics.median(t["rows"][i]["ms"] for t in mine)
                         for i, r in enumerate(mine[0]["rows"])}
    report = dict(card=turns[0]["card"], order=[t["tree"] for t in turns], medians_ms=medians, turns=turns)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k] for k in ("card", "medians_ms")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
