#!/usr/bin/env python3
"""Measure the s8 ``mma.sync`` rate of the card: m16n8k16 against m16n8k32.

    python3 perf/mma_rate.py [--out FILE]

Builds a small CUDA probe with ``nvcc`` (into ``build/``) in which every
warp issues a long loop of independent ``mma.sync ... .s32.s8.s8.s32`` on
``chains`` accumulators, launched with 8 warps on each SM, and times it with
CUDA events.  Prints, for each shape and chain count, the dense int8 rate
(Tops/s, 2 operations a multiply-add) and the SM cycles per instruction on
one SM sub-partition (4 per SM) at the card's maximum SM clock.  K5
(``csrc/quant_matmul.cu``) issues one m16n8k16 per chunk and m-tile; this
says what an instruction costs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

template <int K, int CH>
__global__ void __launch_bounds__(256) probe(int32_t* out, int iters, uint32_t seed) {
  uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u, b0 = a0 * 11u, b1 = a0 * 13u;
  int32_t d[CH][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (K == 16) {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                     : "+r"(d[c][0]), "+r"(d[c][1]), "+r"(d[c][2]), "+r"(d[c][3]) : "r"(a0), "r"(a1), "r"(b0));
      } else {
        asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+r"(d[c][0]), "+r"(d[c][1]), "+r"(d[c][2]), "+r"(d[c][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  int32_t s = 0;
#pragma unroll
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run(int k, int chains, void* out, int blocks, int iters) {
#define P(KK, C) if (k == KK && chains == C) probe<KK, C><<<blocks, 256>>>(static_cast<int32_t*>(out), iters, 12345u);
  P(16, 1) P(16, 2) P(16, 4) P(16, 8) P(32, 1) P(32, 2) P(32, 4) P(32, 8)
#undef P
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 2
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    src, lib_path = build / "mma_rate.cu", build / "mma_rate.so"
    src.write_text(SOURCE)
    nvcc = "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.run.restype = ctypes.c_int
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    clock_hz = float(smi.split(",")[-1].split()[0]) * 1e6
    blocks = 2 * sms  # 8 warps a block, two blocks an SM: 4 warps on each sub-partition
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    rows = []
    for k in (16, 32):
        for chains in (1, 2, 4, 8):
            iters = 4096 // chains
            for _ in range(2):
                assert lib.run(k, chains, out.data_ptr(), blocks, iters) == 0
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(5):
                lib.run(k, chains, out.data_ptr(), blocks, iters)
            e1.record()
            torch.cuda.synchronize()
            sec = e0.elapsed_time(e1) / 5 / 1e3
            instr = blocks * 8 * iters * chains  # warp-level mma instructions
            ops = instr * 16 * 8 * k * 2
            per_smsp = instr / (sms * 4)
            rows.append(dict(k=k, chains=chains, ms=sec * 1e3, tops=ops / sec / 1e12,
                             cycles_per_instr_smsp=sec * clock_hz / per_smsp))
            r = rows[-1]
            print(f"m16n8k{k} s8, {chains} chains a warp: {r['tops']:.0f} Tops/s, "
                  f"{r['cycles_per_instr_smsp']:.2f} cycles an instruction per sub-partition", flush=True)
    print(smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
