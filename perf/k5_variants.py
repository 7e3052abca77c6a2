#!/usr/bin/env python3
"""Time variants of K5's kernel against it on one card, at the phase-6 shapes.

    python3 perf/k5_variants.py [--out FILE]

Each variant is ``csrc/quant_matmul.cu`` with one documented text change,
built with ``nvcc`` into ``build/k5_variants/<name>/`` and loaded in place of
the port's library; every shape (the full-width llama3.2-3b decode shapes
at M = 8 and wq|wo at M = 128, w2a2 and w2a3) is timed with
``chip_smoke.py``'s CUDA-graph timer and cold weights, as in phase 6:

* ``base``: the kernel as committed; also with the K split forced to 1, 2,
  4, 8, 16 and 32 ranges (``grid_plan`` replaced for the launch);
* ``stages6``, ``stages8``: a deeper ring (6 or 8 stages of 8 KB);
* ``noswizzle``: the ring stage in plain row-major order, whose fragment
  reads conflict 2-way in shared memory;
* ``nocompute``, ``noreduce``: anatomy only, their outputs are wrong: every
  warp skips its slab's mma's and decode, or every block of a split launch
  writes its partials and exits without the arrival and the last block's
  sum.

``base`` and the forced splits are checked against the plain version; the
anatomy variants are not.  Prints one line per (shape, pair, variant) and
the per-decode-step sums, and writes everything to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> [(text in csrc/quant_matmul.cu, replacement)]
VARIANTS = {
    "base": [],
    "stages6": [("constexpr int STAGES = 4;", "constexpr int STAGES = 6;")],
    "stages8": [("constexpr int STAGES = 4;", "constexpr int STAGES = 8;")],
    "noswizzle": [("  return line * 128 + gi * 16;\n}", "  (void)gi;\n  return row * 64 + gran * 16;\n}")],
    "nocompute": [("    if (kt + warp * SLAB >= k_end) continue;", "    if (kt + warp * SLAB >= k_end || p.K > 0) continue;")],
    "noreduce": [("  int32_t* counter = p.counters + ct * p.mtiles + mt;\n  if (!last_to_arrive(",
                  "  int32_t* counter = p.counters + ct * p.mtiles + mt;\n  if (p.K > 0) return;\n  if (!last_to_arrive(")],
}
CHECKED = ("base",)
SPLITS = (1, 2, 4, 8, 16, 32)


def build_variants(build, variants=VARIANTS, out_name="k5_variants") -> dict:
    """Build each of ``variants`` (name -> text substitutions in
    ``csrc/quant_matmul.cu``) into ``build/<out_name>/<name>/``, all in
    parallel; returns the loaded libraries by name."""
    out_dir = ROOT / "build" / out_name
    procs = {}
    for name, subs in variants.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        src = (build.CSRC / "quant_matmul.cu").read_text()
        for a, b in subs:
            if a not in src:
                raise SystemExit(f"{out_name}: {name}: text not found in quant_matmul.cu: {a!r}")
            src = src.replace(a, b)
        (d / "quant_matmul.cu").write_text(src)
        for h in build.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "quant_matmul.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{out_name}: nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        for fn, argtypes in build.SIGNATURES["quant_matmul"].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.packed_matmul import kernel as pmk
    from repro_torch.kernels.packed_matmul import ref as pm
    from repro_torch.kernels.quant_matmul.kernel import (
        K5_PLAN, K5_SLAB, quant_packed_matmul_plain, quant_packed_matmul_raw,
    )
    from repro_torch.kernels.quant_matmul.ops import choose_mxu_config

    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build_variants(build)
    timer = chip_smoke.Timer(torch)
    cfg = get_config("llama3.2-3b")
    shapes = [(n, K, N, 8, ps) for n, (K, N, ps) in chip_smoke.decode_matmul_shapes(cfg).items()]
    shapes.append(("wq|wo, M=128", cfg.d_model, cfg.n_heads * cfg.hd, 128, 0))
    planned = pmk.grid_plan
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    rows = []
    for name, K, N, m, per_step in shapes:
        for pair in ((2, 2), (2, 3)):
            c = choose_mxu_config(*pair)
            a = torch.randint(0, 1 << pair[1], (m, K), generator=g, device="cuda", dtype=torch.int8)
            w_lvl = torch.randint(0, 1 << pair[0], (K, N), generator=g, device="cuda", dtype=torch.int32)
            wp = pm.pack_weights(w_lvl, c.n_seg, c.stride).to(torch.int8)
            del w_lvl
            kw = dict(n_seg=c.n_seg, stride=c.stride, acc_chunk=c.acc_chunk, overlap=c.overlap)
            want = quant_packed_matmul_plain(a, wp, **kw)
            wps = chip_smoke.cold_copies(wp)
            auto = planned(m, K, N // 2, 132, **K5_PLAN)
            runs = [(v, None) for v in libs] + [("base", s) for s in SPLITS]
            for variant, forced in runs:
                build._LIBS["quant_matmul"] = libs[variant]
                plan = auto
                if forced is not None:
                    kps = -(-K // forced)
                    kps = -(-kps // K5_SLAB) * K5_SLAB
                    if -(-K // kps) != forced or (forced > 1 and kps < K5_SLAB):
                        continue
                    plan = (forced, kps)
                pmk.grid_plan = lambda *a_, _p=plan, **k_: _p
                try:
                    got = quant_packed_matmul_raw(a, wp, **kw)
                    torch.cuda.synchronize()
                    if variant in CHECKED and not torch.equal(got, want):
                        raise SystemExit(f"k5_variants: {variant} splits {plan[0]} differs at {name} {pair}")
                    ms = timer.graph(lambda i: quant_packed_matmul_raw(a, wps[i % len(wps)], **kw))
                finally:
                    pmk.grid_plan = planned
                rows.append(dict(shape=name, pair=f"w{pair[0]}a{pair[1]}", M=m, K=K, N=N, per_step=per_step,
                                 variant=variant, splits=plan[0], k_per_split=plan[1], planned=forced is None,
                                 ms=ms))
                print(f"{name:13s} w{pair[0]}a{pair[1]} {variant:9s} splits {plan[0]:2d}"
                      f"{' (plan)' if forced is None else '       '} {1e3 * ms:8.2f} us", flush=True)
            del a, wp, wps, want
            torch.cuda.empty_cache()
    build._LIBS["quant_matmul"] = libs["base"]
    steps = {}
    for variant in libs:
        for pair in ("w2a2", "w2a3"):
            steps[f"{variant} {pair}"] = sum(r["ms"] * r["per_step"] for r in rows if r["variant"] == variant
                                            and r["pair"] == pair and r["planned"])
    for pair in ("w2a2", "w2a3"):
        best = 0.0
        for name, *_ , per_step in shapes:
            best += per_step * min(r["ms"] for r in rows if r["shape"] == name and r["pair"] == pair
                                   and r["variant"] == "base")
        steps[f"base, best split per shape {pair}"] = best
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
