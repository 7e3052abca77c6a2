#!/usr/bin/env python3
"""Time variants of K4's kernel against it on one card, at the phase-6 shapes.

    python3 perf/k4_variants.py [--out FILE]

Each variant is ``csrc/quant_matmul.cu`` with one documented text change,
built with ``nvcc`` into ``build/k4_variants/<name>/`` (``k5_variants.py``'s
builder) and loaded in place of the port's library; every shape (the
full-width llama3.2-3b decode shapes at M = 8 and wq|wo at M = 128) is timed
with ``chip_smoke.py``'s CUDA-graph timer and cold weights, as in phase 6:

* ``base``: the kernel as committed; also with the K split forced to 1, 2,
  4, 6, 8, 12, 16, 24 and 32 ranges (``grid_plan`` replaced for the launch);
* ``stages6``: a deeper ring, 6 stages below the 128-row tile (3 at it);
* ``noswizzle``: the weight stage in plain row-major order, whose fragment
  reads conflict 4-way in shared memory;
* ``nocompute``, ``noreduce``: anatomy only, their outputs are wrong: every
  warp skips its slabs' transposes and mma's, or every block of a split
  launch writes its partials and exits without the arrival and the last
  block's sum.

``base``, ``stages6``, ``noswizzle`` and the forced splits are checked
against the plain version; the anatomy variants are not.  Prints one line
per (shape, variant) and the per-decode-step sums, and writes everything to
``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> [(text in csrc/quant_matmul.cu, replacement)]
VARIANTS = {
    "base": [],
    "stages6": [("static constexpr int STAGES = BM == 128 ? 3 : 4;", "static constexpr int STAGES = BM == 128 ? 3 : 6;")],
    "noswizzle": [("  return row * BN + ((gran ^ (((row >> 2) & 3) << 1)) << 4);", "  return row * BN + (gran << 4);")],
    "nocompute": [("      if (kt + s * SLAB >= k_end) break;", "      if (kt + s * SLAB >= k_end || p.K > 0) break;")],
    "noreduce": [("  int32_t* counter = p.counters + ct * p.mtiles + mt;\n  if (!last_to_arrive(counter, p.splits, &last_s)) return;\n  // this tile's partials",
                  "  int32_t* counter = p.counters + ct * p.mtiles + mt;\n  if (p.K > 0) return;\n  if (!last_to_arrive(counter, p.splits, &last_s)) return;\n  // this tile's partials")],
}
CHECKED = ("base", "stages6", "noswizzle")
SPLITS = (1, 2, 4, 6, 8, 12, 16, 24, 32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "perf")]
    import torch

    import chip_smoke
    from k5_variants import build_variants
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.packed_matmul import kernel as pmk
    from repro_torch.kernels.quant_matmul.kernel import (
        K4_PLAN, K4_SLAB, k4_bm, quant_matmul_plain, quant_matmul_raw,
    )

    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build_variants(build, VARIANTS, "k4_variants")
    timer = chip_smoke.Timer(torch)
    cfg = get_config("llama3.2-3b")
    shapes = [(n, K, N, 8, ps) for n, (K, N, ps) in chip_smoke.decode_matmul_shapes(cfg).items()]
    shapes.append(("wq|wo, M=128", cfg.d_model, cfg.n_heads * cfg.hd, 128, 0))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = pmk.grid_plan
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    rows = []
    for name, K, N, m, per_step in shapes:
        a = torch.randint(-128, 128, (m, K), generator=g, device="cuda", dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
        sc = torch.rand((1, N), generator=g, device="cuda") * 1e-4
        want = quant_matmul_plain(a, w, sc)
        ws = chip_smoke.cold_copies(w)
        auto = planned(m, K, N, sms, bm=k4_bm(m), **K4_PLAN)
        runs = [(v, None) for v in libs] + [("base", s) for s in SPLITS]
        for variant, forced in runs:
            build._LIBS["quant_matmul"] = libs[variant]
            plan = auto
            if forced is not None:
                kps = -(-K // forced)
                kps = -(-kps // K4_SLAB) * K4_SLAB
                if -(-K // kps) != forced or forced == auto[0]:
                    continue
                plan = (forced, kps)
            pmk.grid_plan = lambda *a_, _p=plan, **k_: _p
            try:
                got = quant_matmul_raw(a, w, sc)
                torch.cuda.synchronize()
                if variant in CHECKED and not torch.equal(got, want):
                    raise SystemExit(f"k4_variants: {variant} splits {plan[0]} differs at {name}")
                ms = timer.graph(lambda i: quant_matmul_raw(a, ws[i % len(ws)], sc))
            finally:
                pmk.grid_plan = planned
            rows.append(dict(shape=name, M=m, K=K, N=N, per_step=per_step, variant=variant, splits=plan[0],
                             k_per_split=plan[1], planned=forced is None, ms=ms))
            print(f"{name:13s} {variant:9s} splits {plan[0]:2d}{' (plan)' if forced is None else '       '} "
                  f"{1e3 * ms:8.2f} us", flush=True)
        del a, w, ws, want
        torch.cuda.empty_cache()
    build._LIBS["quant_matmul"] = libs["base"]
    steps = {v: sum(r["ms"] * r["per_step"] for r in rows if r["variant"] == v and r["planned"]) for v in libs}
    steps["base, best split per shape"] = sum(
        per_step * min(r["ms"] for r in rows if r["shape"] == name and r["variant"] == "base")
        for name, *_, per_step in shapes)
    for k, v in steps.items():
        print(f"per decode step, {k}: {v:.4f} ms", flush=True)
    smi = chip_smoke.smi("name,power.limit")
    print(smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "steps_ms": steps, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
