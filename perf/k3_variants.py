#!/usr/bin/env python3
"""Time variants and launch plans of K3 on int8 pools on one card.

    python3 perf/k3_variants.py [--out FILE]

Each variant is ``csrc/paged_gather.cu`` with one documented text change,
built with ``nvcc`` into ``build/k3_variants/<name>/`` and loaded in place
of the port's library; each is timed at phase 3's two geometries (the
engine's 8 slots x 16 blocks, and ``chip_smoke.LONG_GATHER``'s 32 slots x
256 blocks), int8 pools to bf16 views, one lane and full causal, with
``chip_smoke.py``'s CUDA-graph timer, on the operands phase 3 makes:

* ``base``: the kernel as committed, at ``gather_plan``'s launch (256
  threads a block) and with the plan forced to the block sizes in
  :data:`THREADS`;
* ``vpt1``, ``vpt2``, ``vpt8``: each thread takes 1, 2 or 8 units instead
  of 4 (the plan's rows a block follow);
* ``bulk``: a live row group's levels come into shared memory by two 1-D
  bulk copies (``cp.async.bulk``, completion on an mbarrier), one for each
  pool, issued by one thread; the threads then dequantize from shared
  memory.  The scales are loaded as in ``base``;
* ``vec16``: a thread's unit is 16 levels (one 16-byte load) instead of
  one 16-byte store's 8, so its 32 bytes of bf16 output take two stores
  that leave every other 16 bytes of a warp's span to the other.

Every run is checked against the plain version (bit-exact).  Prints one
line per (geometry, variant, plan), and writes everything to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

BULK_KERNEL = r'''
template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS)
gather_i8_bulk(const int32_t* __restrict__ table, const int32_t* __restrict__ pos, int window,
               const int8_t* __restrict__ pool_k, const int8_t* __restrict__ pool_v,
               const float* __restrict__ k_scale, const float* __restrict__ v_scale,
               void* __restrict__ k_out, void* __restrict__ v_out, bool* __restrict__ mask,
               int NB, int PS, int D, int C, int R) {
  extern __shared__ __align__(128) unsigned char lvl[];  // [2][R * D]: K's levels, then V's
  __shared__ __align__(8) uint64_t bar;
  constexpr int L = unit_levels(BF16);
  constexpr int STORES = L * (BF16 ? 2 : 4) / 16;
  using T = typename Unit<L>::T;
  const int x = blockIdx.x;
  const int s = x / NB;
  const int b = x - s * NB;
  const int r0 = blockIdx.y * R;
  const int upr = D / L;
  const int n = R * upr;
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int page = __ldg(table + x);
  const size_t out_row = static_cast<size_t>(x) * PS + r0;
  uint4* dk = static_cast<uint4*>(k_out) + out_row * upr * STORES;
  uint4* dv = static_cast<uint4*>(v_out) + out_row * upr * STORES;
  if (page == 0) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = t + k * nt;
      if (j < n) {
#pragma unroll
        for (int q = 0; q < STORES; ++q) {
          dk[j * STORES + q] = zero;
          dv[j * STORES + q] = zero;
        }
      }
    }
  } else {
    const size_t src_row = static_cast<size_t>(page) * PS + r0;
    const uint32_t bar_addr = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
    const uint32_t lvl_addr = static_cast<uint32_t>(__cvta_generic_to_shared(lvl));
    const uint32_t bytes = static_cast<uint32_t>(R * D);
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar_addr) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar_addr), "r"(2u * bytes) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                   :: "r"(lvl_addr), "l"(reinterpret_cast<uint64_t>(pool_k + src_row * D)), "r"(bytes),
                      "r"(bar_addr) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                   :: "r"(lvl_addr + bytes), "l"(reinterpret_cast<uint64_t>(pool_v + src_row * D)), "r"(bytes),
                      "r"(bar_addr) : "memory");
    }
    float ks[VPT], vs[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = t + k * nt;
      if (j < n) {
        ks[k] = __ldg(k_scale + src_row + j / upr);
        vs[k] = __ldg(v_scale + src_row + j / upr);
      }
    }
    __syncthreads();  // the barrier's initialisation is seen by every thread
    uint32_t done = 0;
    while (!done) {
      asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                   " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar_addr) : "memory");
    }
    const T* lk = reinterpret_cast<const T*>(lvl);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = t + k * nt;
      if (j < n) {
        const T qk = lk[j], qv = lk[n + j];
        dequant_store<BF16, L>(qk, ks[k], dk + j * STORES);
        dequant_store<BF16, L>(qv, vs[k], dv + j * STORES);
      }
    }
  }
  write_mask(mask, pos[s], window, s, b, NB, PS, C, r0, R);
}

'''

NAMESPACE_END = "}  // namespace"
# name -> [(text in csrc/paged_gather.cu, replacement, count)]
VARIANTS = {
    "base": [],
    "bulk": [(NAMESPACE_END, BULK_KERNEL + NAMESPACE_END, 1),
             ("    gather_i8<true><<<grid, threads, 0, st>>>", "    gather_i8_bulk<true><<<grid, threads, 2 * rows * D, st>>>", 1),
             ("    gather_i8<false><<<grid, threads, 0, st>>>", "    gather_i8_bulk<false><<<grid, threads, 2 * rows * D, st>>>", 1)],
    # the unit a 16-byte load of 16 levels, whose bf16 outputs (32 bytes) take
    # two 16-byte stores a thread, 32 bytes apart across a warp
    "vec16": [("template <> struct Unit<8> { using T = uint2; };",
               "template <> struct Unit<8> { using T = uint2; };\ntemplate <> struct Unit<16> { using T = uint4; };", 1),
              ("__device__ __forceinline__ uint32_t word(const uint2& q, int i) { return i == 0 ? q.x : q.y; }",
               "__device__ __forceinline__ uint32_t word(const uint2& q, int i) { return i == 0 ? q.x : q.y; }\n"
               "__device__ __forceinline__ uint32_t word(const uint4& q, int i) {\n"
               "  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;\n}", 1),
              ("return bf16 ? 8 : 4;", "return bf16 ? 16 : 16;", 1)],
    **{f"vpt{v}": [("constexpr int VPT = 4;", f"constexpr int VPT = {v};", 1)] for v in (1, 2, 8)},
}
LEVELS = {"vec16": 16}  # levels a unit, where a variant's differ from bf16's 8
VPTS = {"vpt1": 1, "vpt2": 2, "vpt8": 8}  # units a thread, where a variant's differ from 4
THREADS = (128, 512)  # threads a block forced on base, beside the plan's 256


def build_variants(build) -> dict:
    """Build every variant into ``build/k3_variants/<name>/``, all in
    parallel; returns the loaded libraries by name."""
    out_dir = ROOT / "build" / "k3_variants"
    procs = {}
    for name, subs in VARIANTS.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        src = (build.CSRC / "paged_gather.cu").read_text()
        for a, b, count in subs:
            if src.count(a) != count:
                raise SystemExit(f"k3_variants: {name}: {a!r} found {src.count(a)} times, not {count}")
            src = src.replace(a, b)
        (d / "paged_gather.cu").write_text(src)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "paged_gather.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k3_variants: nvcc failed for {name}:\n{log[-3000:]}")
        print(f"{name}: " + "; ".join(ln.strip() for ln in log.splitlines() if "gather_i8" in ln
                                      or "registers" in ln), flush=True)
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        for fn, argtypes in build.SIGNATURES["paged_gather"].items():
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
    from repro_torch.kernels.paged_gather import kernel as pgk
    from repro_torch.serving import EngineConfig

    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build_variants(build)
    timer = chip_smoke.Timer(torch)
    cfg = get_config("llama3.2-3b")
    ecfg = EngineConfig(n_slots=8, page_size=16, max_len=256)
    ps, D, lg = ecfg.page_size, cfg.kv_heads * cfg.hd, chip_smoke.LONG_GATHER
    geometries = [("served", ecfg.n_slots, ecfg.blocks_per_slot, ecfg.pool_pages(), 1, (17, 96)),
                  ("long", lg["S"], lg["max_len"] // ps, lg["S"] * (lg["max_len"] // ps) + 1, lg["seed"],
                   lg["lengths"])]
    planned = pgk.gather_plan
    rows = []
    for geometry, S, nb, P, seed, lengths in geometries:
        table, pos, n_live, _, lv, sc = chip_smoke.gather_operands(torch, S, nb, ps, D, P, seed, lengths)
        nbytes = chip_smoke.gather_bytes(S, nb, ps, D, n_live, 1, 1, True)
        bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
        args_ = (table, pos, 0, lv[0], lv[1], sc[0], sc[1])
        kw = dict(chunk=1, out_dtype=torch.bfloat16)
        want = pgk.paged_gather_plain(*args_, **kw)
        runs = [(v, None) for v in libs] + [("base", t) for t in THREADS]
        for variant, forced in runs:
            build._LIBS["paged_gather"] = libs[variant]
            kw_plan = dict(vpt=VPTS.get(variant, 4), **({} if forced is None else {"threads": forced}))
            plan = planned(S, nb, ps, D, LEVELS.get(variant, 8), **kw_plan)
            pgk.gather_plan = lambda *a_, _p=plan, **k_: _p
            try:
                got = pgk.paged_gather_raw(*args_, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"k3_variants: {variant} {plan} differs at the {geometry} geometry")
                del got
                ms = timer.graph(lambda i: pgk.paged_gather_raw(*args_, **kw))
            finally:
                pgk.gather_plan = planned
            rows.append(dict(geometry=geometry, variant=variant, planned=forced is None, rows=plan.rows,
                             vpt=plan.vpt, threads=plan.threads, grid=list(plan.grid), ms=ms, bound_ms=bound,
                             fraction_of_bound=bound / ms, live_pages=n_live, bytes=nbytes))
            print(f"{geometry:6s} {variant:6s} rows {plan.rows:2d} vpt {plan.vpt} threads {plan.threads:3d}"
                  f"{' (plan)' if forced is None else '       '} {1e3 * ms:9.2f} us, {100 * bound / ms:5.1f} % "
                  f"of its {1e3 * bound:.2f} us bound", flush=True)
        del table, pos, lv, sc, want, args_
        torch.cuda.empty_cache()
    build._LIBS["paged_gather"] = libs["base"]
    smi = chip_smoke.smi("name,power.limit")
    print(smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
