// int8-lane matmuls for Hopper (sm_90a), kernels K4 and K5.
//
// Replaces the Pallas TPU kernels
//   K4 quant_matmul: repro/kernels/quant_matmul/kernel.py:63 quant_matmul_raw
//      (bodies _kernel_single_k :44, _kernel_blocked :48): int8 levels
//      [M, K] x int8 levels [K, N] -> int32, then one float multiply by the
//      combined (weight x activation) scale [1, N] -> f32 [M, N];
//   K5 quant_packed_matmul: repro/kernels/quant_matmul/kernel.py:103
//      quant_packed_matmul_raw: int8 activation levels [M, K] x int8 words
//      [K, N / n_seg] that each pack n_seg sub-4-bit weight levels
//      (TPU_MXU7 placements), decoded by the segment peel (peel.cuh) and
//      interleaved to channel order -> int32 [M, N].
// Plain versions: repro_torch/kernels/quant_matmul/kernel.py.
//
// K4.  What bounds it on this card: it reads every weight byte once and does
// 2 * M int8 operations per weight byte, far below the ridge of the int8
// tensor cores (1979 Tops/s over 3.35 TB/s, about 590 operations a byte), so
// at decode (M = 8; M <= 32 alike) it is bound by HBM bytes: a llama3.2-3b
// decode step of W8A8 projections and head reads 3.2 GB, 0.97 ms.  At M = 128
// a weight byte must still come from HBM only once, or the bound moves up
// with the row tiles.
//
// What the design does about it.
// - s8 tensor cores, transposed form (as K5): mma.sync m16n8k32
//   .s32.s8.s8.s32, weight columns as the 16 rows of A, activation rows as
//   the 8 columns of B.  int8 x int8 sums into int32 exactly for K < 2^17, so
//   each 32-row slab takes one mma per (m16, n8) tile: no chunk masks, no
//   peel.
// - Weight ring (ring.cuh).  Weights stay [K, N] row-major.  Each block
//   streams [TK = 128] x [BN = 128] byte tiles through cp.async stages, 16-,
//   4- or 1-byte copies by N and alignment (kernel.py copy_width), with the
//   block's activation rows [BM] x [TK] in the same stage.  Lane (g, t)
//   reads 8 bytes of rows 4t .. 4t+3 and 16 + 4t .. of a slab and transposes
//   them with prmt into the A fragments of 4 m-tiles (columns 8g + 2i, 8g +
//   2i + 1); the stage is swizzled (ring_offset) so that these reads and the
//   copies are free of bank conflicts, and activation rows sit at a pitch of
//   16 mod 128 bytes so that the B reads are too.
// - A tile that scales with M (kernel.py k4_bm): BM = 8, 32, 64 or 128
//   activation rows a block.  Eight warps split a block as (K groups) x (row
//   groups) x (2 column groups of 64); a warp holds up to 4 n8 tiles of rows,
//   so the A fragments it builds from a slab serve up to 16 mma's, and at
//   M = 128 one block reads each weight byte once for all 128 rows.
// - Grid and K split (kernel.py K4_PLAN: K1/K2's grid_plan with K4's tile).
//   One block per (row tile, column tile, K split); K is split in multiples
//   of 32 rows until the blocks fill two per SM.  The warps' K groups are
//   summed in shared memory; a split's int32 partials go to a workspace and
//   the last block to arrive at a tile (ring.cuh last_to_arrive) sums them
//   and applies the scale: out = float(acc) * scale[n], one rounding, as the
//   plain version.  One kernel node a call: no memset, no atomics on
//   outputs, no second kernel.
// - Ragged M, N and K are masked (zero-filled copies).
//
// Measured (chip_smoke.py phase 6, perf/ab_int8_filter.py, perf/k4_variants.py;
// H100 80GB HBM3 at 700 W, PERF.md section 6): 2.13-2.15 ms per decode step
// at M = 8 (from 9.70 with the earlier __dp4a kernel; bytes bound 0.97), the
// head at 2.6 TB/s (0.151 ms), wq|wo at M = 128 0.025 ms (torch._int_mm and
// the scale 0.117).  The layer shapes pay a fixed cost: without the split
// reduction a step takes 0.55 ms less, without the mma's 0.05 less; the
// split count is capped at 8, since the last block's sum grows with it.
//
// K5.  What bounds it on this card: a decode step (llama3.2-3b, M = 8) reads
// 1.6 GB of packed int8 words, 0.49 ms at 3.35 TB/s.  Its integer work cannot
// run at that rate on the CUDA cores: one IMAD per product plus the parity
// is about 24 int32 operations per packed byte, 2.3 ms a step at the card's
// IMAD peak even with perfect issue.  So the packed multiply runs on the s8
// tensor cores (mma.sync m16n8k16 .s32.s8.s8.s32): one packed int8 word times
// one int8 level in a tensor-core lane gives two products, the paper's "two
// low-bit MACs per int8 multiplier" on this card's multiplier.
//
// What the design does about it.
// - Transposed form.  The packed weight columns are the 16 rows of A, the
//   activation rows the 8 columns of B, so M = 8 fills one instruction.
// - Chunks.  No accumulator that is decoded may hold more than acc_chunk
//   products, or segments carry into each other.  Within each k16 slab the B
//   fragment is ANDed with each chunk's byte mask and each chunk gets its own
//   mma (w2a2: 7 + 7 + 2 rows, w2a3: 3 x 5 + 1); overpacked, a second mma of
//   (a & 1) against (wp & 1 << stride) gives the chunk's parity bit.  Any
//   chunking of at most acc_chunk products gives the same integers, so
//   chunks follow the slabs and not the plain version's cadence.
// - Decode as a sum (peel.cuh peel_low2).  A chunk's segment 0 is one LOP3
//   of its packed sum and parity; segment 1 is never peeled per chunk: a
//   fifth mma per slab, unmasked, sums the packed dot over all rows, and
//   segment 1 = (that sum - the summed segment 0) >> stride, once per warp.
//   Per slab and m-tile that is 7 mma's at w2a2 (3 chunks, each with its
//   parity, and the sum) or 13 at w2a3, and two integer operations per chunk
//   and output.
// - Weight-tile ring (ring.cuh, shared with K1/K2).  Weights stay [K, Np]
//   row-major.  Each block streams [TK = 128] x [BN = 64] byte tiles through
//   STAGES = 4 shared-memory stages filled by cp.async: 16-byte copies when
//   Np % 16 == 0, 4-byte copies when Np % 4 == 0, else byte loads (kernel.py
//   copy_width).  Warp w takes slab w of every stage; lane (g, t) reads 8
//   bytes of four rows and transposes them with __byte_perm into the A
//   fragments of 4 m-tiles (packed columns 8g + 2i, 8g + 2i + 1).  The stage
//   layout is swizzled (ring_offset) so that these reads and the copies are
//   free of bank conflicts.
// - Activations.  The block's 8 rows are staged in shared memory (16-byte
//   loads when K % 16 == 0), 4096 K rows at a time, at a pitch of 16 mod
//   128 bytes so that the B reads hit 32 distinct banks.
// - Grid and K split (kernel.py K5_PLAN: K1/K2's grid_plan with K5's
//   tile).  One block per (row tile of 8, column tile of 64, K split); K is
//   split in multiples of 16 rows until the blocks fill two per SM; the last
//   block to arrive at a tile sums the splits' slabs (ring.cuh
//   last_to_arrive): no memset, no atomics on outputs, graph-safe.
// - Ragged M, K (zero rows past K, masked chunks) and Np are masked.
//
// Measured (chip_smoke.py phase 6, perf/k5_variants.py, perf/mma_rate.py;
// H100 SXM at 700 W, PERF.md section 6): 2.2 ms per w2a2 decode step and
// 2.6 at w2a3 (from 20.8 and 22.7; bytes bound 0.49), the head at 1.9 TB/s.
// Of the w2a2 step, the chunk mma's and decodes take 0.38 ms, the split
// reductions 0.47 and the launches with their weight streams the rest; a
// deeper ring does not help.  m16n8k16 s8 issues every 4.9 cycles per SM
// sub-partition, m16n8k32 every 7.1: k32 would waste most of its depth on
// the masked chunks.
#include <cuda_runtime.h>

#include <cstdint>

#include "peel.cuh"
#include "ring.cuh"

namespace {

// r0..r3: four bytes (columns) of four consecutive rows; c[j]: column j's four
// rows, row i in byte i
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                             uint32_t* c) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void add4(int4& v, int4 t) {
  v.x += t.x;
  v.y += t.y;
  v.z += t.z;
  v.w += t.w;
}

// ---- K4 -----------------------------------------------------------------

namespace k4 {

constexpr int BN = 128;               // weight columns per block: two 64-column warp groups
constexpr int WN = 2;                 // column groups of 64 (4 m16 tiles each)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SLAB = 32;              // K rows of one mma (k32)
constexpr int TK = 128;               // K rows per ring stage: four slabs
constexpr int W_BYTES = TK * BN;      // a stage's weight tile, 16 KB
constexpr int ACT_LD = TK + 16;       // a stage's activation row pitch: 16 mod 128 bytes
constexpr int MAX_K = 1 << 17;        // int8 x int8 sums of fewer rows fit int32

// The warp layout of a block of BM activation rows: NT n8 tiles a warp, WM
// row groups, WK K groups (the slabs of a stage dealt round robin); a
// stage holds the weight tile and the block's activation rows.
template <int BM>
struct Tile {
  static constexpr int NT = BM < 32 ? BM / 8 : 4;
  static constexpr int WM = BM / (8 * NT);
  static constexpr int WK = WARPS / (WM * WN);
  static constexpr int SPW = TK / SLAB / WK;        // slabs a warp takes per stage
  static constexpr int STAGES = BM == 128 ? 3 : 4;  // two blocks an SM fit in shared memory
  static constexpr int STAGE = W_BYTES + BM * ACT_LD;
  static constexpr int SMEM = STAGES * STAGE;
  static constexpr int QUADS = BM * BN / 4;         // int4 of a block's outputs
  static_assert(WM * WN * WK == WARPS && SPW * WK * SLAB == TK, "warp layout");
  static_assert(WK * QUADS * 16 <= SMEM, "the K groups' partial sums reuse the ring");
  static_assert(QUADS % THREADS == 0, "whole int4 of outputs per thread");
};

struct Args {
  const int8_t* a;      // [M, K] activation levels
  const int8_t* w;      // [K, N] weight levels
  const float* scale;   // [N] combined scales
  float* out;           // [M, N]
  int32_t* ws;          // splits > 1: QUADS int4 of partials per block
  int32_t* counters;    // splits > 1: one arrival counter per (row, column) tile, all 0
  int M, K, N, splits, k_per_split, mtiles, ctiles;
  bool act_vec;         // K % 16 == 0 and a 16-byte aligned: 16-byte activation copies
};

// Byte offset in a stage's weight tile of the 16-byte granule `gran` (0..7)
// of row `row`: the granule index is XORed with 2 * ((row / 4) % 4).  A
// half-warp's fragment reads (lane (g, t) takes 8 bytes of granule 4 cg + g
// / 2 of row 4t + r) then hit 8 distinct granules, all 32 banks once, and a
// row's 16-byte copies stay on distinct banks.
__device__ __forceinline__ int ring_offset(int row, int gran) {
  return row * BN + ((gran ^ (((row >> 2) & 3) << 1)) << 4);
}

// d += A (16 x 32, s8; registers: rows g / g + 8 at k 4t.., rows g / g + 8 at
// k 16 + 4t..) x B (32 x 8, s8; k 4t.. and 16 + 4t.. of column g), s32
__device__ __forceinline__ void mma_k32(int32_t (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int BM, int COPY>
__global__ void __launch_bounds__(THREADS, 2) quant_mma_kernel(const Args p) {
  using T = Tile<BM>;
  extern __shared__ __align__(16) uint8_t smem[];  // ring [STAGES][weights, activations]
  __shared__ int last_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int cg = warp % WN, rg = (warp / WN) % T::WM, kg = warp / (WN * T::WM);
  // blockIdx.x = (split * ctiles + ct) * mtiles + mt: blocks that run together
  // read the same weight columns (row tiles) or adjacent ones
  int u = blockIdx.x;
  const int mt = u % p.mtiles;
  u /= p.mtiles;
  const int ct = u % p.ctiles;
  const int split = u / p.ctiles;
  const int m0 = mt * BM, c0 = ct * BN;
  const int k_begin = split * p.k_per_split;
  const int k_end = min(p.K, k_begin + p.k_per_split);
  const int n_tiles = max(0, (k_end - k_begin + TK - 1) / TK);
  const uint32_t ring_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // stage `tile` <- weight rows [kt, kt + TK) x columns [c0, c0 + BN) and
  // activation rows [m0, m0 + BM) x K [kt, kt + TK), zeros outside
  auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      const int kt = k_begin + tile * TK;
      const int slot = (tile % T::STAGES) * T::STAGE;
      if (COPY == 16) {
#pragma unroll
        for (int j = 0; j < W_BYTES / 16 / THREADS; ++j) {
          const int i = tid + j * THREADS, row = i >> 3, gran = i & 7;
          const int k = kt + row, col = c0 + gran * 16;
          const bool ok = k < k_end && col < p.N;
          cp_async16(ring_base + slot + ring_offset(row, gran),
                     ok ? p.w + static_cast<size_t>(k) * p.N + col : p.w, ok ? 16 : 0);
        }
      } else if (COPY == 4) {
#pragma unroll
        for (int j = 0; j < W_BYTES / 4 / THREADS; ++j) {
          const int i = tid + j * THREADS, row = i >> 5, word = i & 31;
          const int k = kt + row, col = c0 + word * 4;
          const bool ok = k < k_end && col < p.N;
          cp_async4(ring_base + slot + ring_offset(row, word >> 2) + (word & 3) * 4,
                    ok ? p.w + static_cast<size_t>(k) * p.N + col : p.w, ok ? 4 : 0);
        }
      } else {  // N % 4 != 0: rows are not 4-byte aligned; byte loads, stored as words
#pragma unroll 1
        for (int j = 0; j < W_BYTES / 4 / THREADS; ++j) {
          const int i = tid + j * THREADS, row = i >> 5, word = i & 31;
          const int k = kt + row, col = c0 + word * 4;
          uint32_t v = 0;
          if (k < k_end) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              if (col + b < p.N) {
                v |= static_cast<uint32_t>(static_cast<uint8_t>(
                         __ldg(p.w + static_cast<size_t>(k) * p.N + col + b))) << (8 * b);
              }
            }
          }
          *reinterpret_cast<uint32_t*>(smem + slot + ring_offset(row, word >> 2) + (word & 3) * 4) = v;
        }
      }
      const int act = slot + W_BYTES;
      if (p.act_vec) {  // k_end is a multiple of 16: a granule is all in or all out
        for (int i = tid; i < BM * (TK / 16); i += THREADS) {
          const int r = i >> 3, gran = i & 7, m = m0 + r, k = kt + gran * 16;
          const bool ok = m < p.M && k < k_end;
          cp_async16(ring_base + act + r * ACT_LD + gran * 16,
                     ok ? p.a + static_cast<size_t>(m) * p.K + k : p.a, ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < BM * (TK / 4); i += THREADS) {
          const int r = i / (TK / 4), q = i % (TK / 4), m = m0 + r, k = kt + 4 * q;
          uint32_t v = 0;
          if (m < p.M) {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              if (k + b < k_end) {
                v |= static_cast<uint32_t>(static_cast<uint8_t>(p.a[static_cast<size_t>(m) * p.K + k + b]))
                     << (8 * b);
              }
            }
          }
          *reinterpret_cast<uint32_t*>(smem + act + r * ACT_LD + 4 * q) = v;
        }
      }
    }
    cp_commit();  // one group per stage, empty past the end, so the waits count stages
  };

#pragma unroll
  for (int i = 0; i < T::STAGES - 1; ++i) fetch(i);

  // acc[j][i]: n8 tile j (activation rows rg * NT * 8 + 8j ..) x m-tile i
  // (columns cg * 64 + 8g + 2i as A row g, + 1 as A row g + 8); fragment e:
  // column + (e >> 1), activation row 2t + (e & 1)
  int32_t acc[T::NT][4][4];
#pragma unroll
  for (int j = 0; j < T::NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0;
    }
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_wait<T::STAGES - 2>();  // this thread's copies of stage `tile` have landed
    __syncthreads();           // everyone's have, and stage tile - 1 is consumed
    fetch(tile + T::STAGES - 1);
    const int kt = k_begin + tile * TK;
    const uint8_t* wst = smem + (tile % T::STAGES) * T::STAGE;
    const uint8_t* ast = wst + W_BYTES + (rg * T::NT * 8 + g) * ACT_LD + 4 * t;
#pragma unroll
    for (int ss = 0; ss < T::SPW; ++ss) {
      const int s = ss * T::WK + kg;
      if (kt + s * SLAB >= k_end) break;  // warp-uniform: only zero rows left
      // A fragments: 8 bytes (columns 8g ..) of slab rows 4t + r and 16 + 4t + r
      uint32_t w[4][4], clo[8], chi[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint2 lo = *reinterpret_cast<const uint2*>(
            wst + ring_offset(s * SLAB + 4 * t + r, cg * 4 + (g >> 1)) + (g & 1) * 8);
        const uint2 hi = *reinterpret_cast<const uint2*>(
            wst + ring_offset(s * SLAB + 16 + 4 * t + r, cg * 4 + (g >> 1)) + (g & 1) * 8);
        w[0][r] = lo.x;
        w[1][r] = lo.y;
        w[2][r] = hi.x;
        w[3][r] = hi.y;
      }
      transpose4x4(w[0][0], w[0][1], w[0][2], w[0][3], clo);
      transpose4x4(w[1][0], w[1][1], w[1][2], w[1][3], clo + 4);
      transpose4x4(w[2][0], w[2][1], w[2][2], w[2][3], chi);
      transpose4x4(w[3][0], w[3][1], w[3][2], w[3][3], chi + 4);
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        // B fragments: activation row g of n8 tile j, k's 4t .. and 16 + 4t ..
        const uint8_t* ar = ast + j * 8 * ACT_LD + s * SLAB;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(ar);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(ar + 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_k32(acc[j][i], clo[2 * i], clo[2 * i + 1], chi[2 * i], chi[2 * i + 1], b0, b1);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it now holds the K groups' sums

  // quad q = ((pos * NT + j) * 4 + 2h + p) * 32 + lane (pos = rg * WN + cg):
  // activation row 2t + h, columns 8g + 4p .. 8g + 4p + 3 of the warp's 64
  int4* red = reinterpret_cast<int4*>(smem);  // [WK][QUADS]
  const int pos = rg * WN + cg;
#pragma unroll
  for (int j = 0; j < T::NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        red[kg * T::QUADS + ((pos * T::NT + j) * 4 + 2 * h + pp) * 32 + lane] =
            make_int4(acc[j][2 * pp][h], acc[j][2 * pp][2 + h], acc[j][2 * pp + 1][h],
                      acc[j][2 * pp + 1][2 + h]);
      }
    }
  }
  __syncthreads();
  auto quad = [&](int q) {
    int4 v = red[q];
#pragma unroll
    for (int kk = 1; kk < T::WK; ++kk) add4(v, red[kk * T::QUADS + q]);
    return v;
  };
  // one rounding: float(acc) times the combined scale, as the plain version
  auto store = [&](int q, int4 v) {
    const int l = q & 31, rest = q >> 5, pp = rest & 1, h = (rest >> 1) & 1;
    const int j = (rest >> 2) % T::NT, wpos = (rest >> 2) / T::NT;
    const int m = m0 + ((wpos / WN) * T::NT + j) * 8 + 2 * (l & 3) + h;
    const int n = c0 + (wpos % WN) * 64 + 8 * (l >> 2) + 4 * pp;
    if (m >= p.M || n >= p.N) return;
    float* dst = p.out + static_cast<size_t>(m) * p.N + n;
    const int32_t vals[4] = {v.x, v.y, v.z, v.w};
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      o[c] = n + c < p.N ? __fmul_rn(__int2float_rn(vals[c]), __ldg(p.scale + n + c)) : 0.f;
    }
    if ((p.N & 3) == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (n + c < p.N) dst[c] = o[c];
      }
    }
  };
  if (p.splits == 1) {
#pragma unroll 4
    for (int q = tid; q < T::QUADS; q += THREADS) store(q, quad(q));
    return;
  }
  int4* mine = reinterpret_cast<int4*>(p.ws) + static_cast<size_t>(blockIdx.x) * T::QUADS;
#pragma unroll 4
  for (int q = tid; q < T::QUADS; q += THREADS) mine[q] = quad(q);
  int32_t* counter = p.counters + ct * p.mtiles + mt;
  if (!last_to_arrive(counter, p.splits, &last_s)) return;
  // this tile's partials: split s at first + s * step
  const int4* first = reinterpret_cast<const int4*>(p.ws) + (static_cast<size_t>(ct) * p.mtiles + mt) * T::QUADS;
  const size_t step = static_cast<size_t>(p.ctiles) * p.mtiles * T::QUADS;
  for (int q = tid; q < T::QUADS; q += THREADS) {
    int4 total = make_int4(0, 0, 0, 0);
#pragma unroll 8
    for (int s = 0; s < p.splits; ++s) add4(total, __ldcg(first + s * step + q));
    store(q, total);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch, or the next replay of a graph
}

template <int BM, int COPY>
cudaError_t launch(const Args& p, cudaStream_t s) {
  auto kern = quant_mma_kernel<BM, COPY>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BM>::SMEM);
  if (attr != cudaSuccess) return attr;
  kern<<<p.mtiles * p.ctiles * p.splits, THREADS, Tile<BM>::SMEM, s>>>(p);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_copy(const Args& p, int copy, cudaStream_t s) {
  return copy == 16 ? launch<BM, 16>(p, s) : copy == 4 ? launch<BM, 4>(p, s) : launch<BM, 1>(p, s);
}

}  // namespace k4

// ---- K5 -----------------------------------------------------------------

namespace k5 {

constexpr int BM = 8;                 // activation rows per block: the n8 of one mma
constexpr int MT = 4;                 // m16 tiles per warp
constexpr int BN = 16 * MT;           // packed columns (weight-row bytes) per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SLAB = 16;              // K rows of one mma (k16)
constexpr int TK = WARPS * SLAB;      // K rows per ring stage: one slab per warp
constexpr int STAGES = 4;             // ring depth
constexpr int STAGE_BYTES = TK * BN;  // 8 KB
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int KR = 4096;              // K rows of activations staged at a time
constexpr int MAX_CHUNKS = SLAB;      // chunks of one slab at acc_chunk 1
constexpr int TILE4 = 2 * MT * 32;    // int4 of a warp's (and the block's) outputs
constexpr size_t MAX_SMEM = RING_BYTES + BM * (KR + 16);
static_assert(KR % TK == 0, "activation pieces start on a ring stage");
static_assert(WARPS * TILE4 * 16 <= RING_BYTES, "the warps' partial sums reuse the ring");
static_assert(TILE4 == THREADS, "one int4 of the block's outputs per thread");
static_assert(BN == 64 && BM == 8, "the ring swizzle and the fragment maps assume 64-byte rows and n8");

struct Args {
  const int8_t* a;     // [M, K] activation levels
  const int8_t* wp;    // [K, Np] packed words
  int32_t* out;        // [M, 2 * Np], channel order
  int32_t* ws;         // splits > 1: TILE4 int4 of partials per block
  int32_t* counters;   // splits > 1: one arrival counter per (row, column) tile, all 0
  int M, K, Np, stride, acc_chunk, splits, k_per_split, mtiles, ctiles, act_ld;
};

// Byte offset in a ring stage of the 16-byte granule `gran` (0..3) of weight
// row `row`.  Rows pair into 128-byte lines and a granule's index in its line
// is XORed with 2 * ((line / 2) % 4): the fragment read below (lane (g, t)
// takes bytes [8g, 8g + 8) of row 4t + r) then hits all 16 bank pairs once
// in each half-warp, and a warp's 16-byte copies hit all 32 banks.
__device__ __forceinline__ int ring_offset(int row, int gran) {
  const int line = row >> 1;
  const int gi = (((row & 1) << 2) | gran) ^ (((line >> 1) & 3) << 1);
  return line * 128 + gi * 16;
}

// d += A (16 x 16, s8, rows a0: g, a1: g + 8) x B (16 x 8, s8), s32 accumulate
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// d = A x B, a fresh accumulator (one chunk)
__device__ __forceinline__ void mma_s8_new(int32_t (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(0));
}

template <bool OVERLAP, int COPY>
__global__ void __launch_bounds__(THREADS, 2) quant_packed_mma_kernel(const Args p) {
  extern __shared__ __align__(16) uint8_t smem[];   // ring [STAGES][STAGE_BYTES], then act
  uint8_t* act = smem + RING_BYTES;                  // [BM][act_ld] levels of the current piece
  __shared__ uint32_t cmask_s[MAX_CHUNKS][4];        // chunk j's bytes of k quad q = 4q .. 4q+3
  __shared__ int last_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  // blockIdx.x = (split * ctiles + ct) * mtiles + mt: blocks that run together
  // read adjacent columns of the same weight rows
  int u = blockIdx.x;
  const int mt = u % p.mtiles;
  u /= p.mtiles;
  const int ct = u % p.ctiles;
  const int split = u / p.ctiles;
  const int m0 = mt * BM, c0 = ct * BN;
  const int k_begin = split * p.k_per_split;
  const int k_end = min(p.K, k_begin + p.k_per_split);
  const int n_tiles = max(0, (k_end - k_begin + TK - 1) / TK);
  const uint32_t ring_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // the slab's chunk plan (kernel.py slab_chunks): [j * ch, (j + 1) * ch) cut
  // at SLAB, ch = min(acc_chunk, SLAB)
  const int ch = min(p.acc_chunk, SLAB);
  const int nch = (SLAB + ch - 1) / ch;
  if (tid < nch * 4) {
    const int j = tid >> 2, q = tid & 3;
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * q + i;
      if (k >= j * ch && k < (j + 1) * ch) m |= 0xFFu << (8 * i);
    }
    cmask_s[j][q] = m;
  }

  // ring stage `tile` <- weight rows [k_begin + tile * TK, + TK) x columns
  // [c0, c0 + BN), zeros outside the matrix
  auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      const int kt = k_begin + tile * TK;
      const int slot = (tile % STAGES) * STAGE_BYTES;
      if (COPY == 16) {
#pragma unroll
        for (int j = 0; j < STAGE_BYTES / 16 / THREADS; ++j) {
          const int i = tid + j * THREADS, row = i >> 2, gran = i & 3;
          const int k = kt + row, col = c0 + gran * 16;
          const bool ok = k < k_end && col < p.Np;
          cp_async16(ring_base + slot + ring_offset(row, gran),
                     ok ? p.wp + static_cast<size_t>(k) * p.Np + col : p.wp, ok ? 16 : 0);
        }
      } else {
#pragma unroll
        for (int j = 0; j < STAGE_BYTES / 4 / THREADS; ++j) {
          const int i = tid + j * THREADS, row = i >> 4, word = i & 15;
          const int k = kt + row, col = c0 + word * 4;
          const int off = slot + ring_offset(row, word >> 2) + (word & 3) * 4;
          if (COPY == 4) {
            const bool ok = k < k_end && col < p.Np;
            cp_async4(ring_base + off, ok ? p.wp + static_cast<size_t>(k) * p.Np + col : p.wp, ok ? 4 : 0);
          } else {  // Np % 4 != 0: rows are not 4-byte aligned; byte loads, stored as words
            uint32_t v = 0;
            if (k < k_end) {
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                if (col + b < p.Np) {
                  v |= static_cast<uint32_t>(static_cast<uint8_t>(
                           __ldg(p.wp + static_cast<size_t>(k) * p.Np + col + b))) << (8 * b);
                }
              }
            }
            *reinterpret_cast<uint32_t*>(smem + off) = v;
          }
        }
      }
    }
    cp_commit();  // one group per stage, empty past the end, so the waits count stages
  };

  // activation levels of rows [m0, m0 + BM), K rows [kp, kp + KR) (rows past
  // M read as 0; K rows past k_end meet zero weights and are not staged)
  const bool act_vec = p.K % 16 == 0 && (reinterpret_cast<uintptr_t>(p.a) & 15) == 0;
  auto stage_act = [&](int kp) {
    const int n = min(KR, k_end - kp);
    if (act_vec) {  // n % 16 == 0: K and every split boundary are multiples of 16
      const int q = n / 16;
      for (int i0 = 0; i0 < BM * q; i0 += 4 * THREADS) {
        int4 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = i0 + j * THREADS + tid, r = i / q, x = i % q;
          v[j] = make_int4(0, 0, 0, 0);
          if (i < BM * q && m0 + r < p.M) {
            v[j] = __ldg(reinterpret_cast<const int4*>(p.a + static_cast<size_t>(m0 + r) * p.K + kp) + x);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = i0 + j * THREADS + tid, r = i / q, x = i % q;
          if (i < BM * q) *reinterpret_cast<int4*>(act + r * p.act_ld + 16 * x) = v[j];
        }
      }
    } else {
      for (int i = tid; i < BM * n; i += THREADS) {
        const int r = i / n, x = i % n;
        act[r * p.act_ld + x] =
            m0 + r < p.M ? static_cast<uint8_t>(p.a[static_cast<size_t>(m0 + r) * p.K + kp + x]) : 0;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);
  if (n_tiles > 0) stage_act(k_begin);
  __syncthreads();

  // sum: the packed dot over all of this warp's rows; seg0: the decoded low
  // segment, chunk by chunk.  D fragment e of m-tile i: packed column
  // 8g + 2i + (e >> 1), activation row 2t + (e & 1).
  int32_t sum[MT][4], seg0[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[i][e] = seg0[i][e] = 0;
  }
  const uint32_t pbits = 0x01010101u << p.stride;  // each packed byte's segment-1 LSB

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_wait<STAGES - 2>();  // this thread's copies of stage `tile` have landed
    __syncthreads();        // everyone's have, and stage tile - 1 is consumed
    fetch(tile + STAGES - 1);
    const int kt = k_begin + tile * TK;
    if (tile > 0 && (kt - k_begin) % KR == 0) {
      stage_act(kt);
      __syncthreads();
    }
    if (kt + warp * SLAB >= k_end) continue;  // warp-uniform: only zero rows left
    // A fragments: lane (g, t) reads bytes [8g, 8g + 8) of slab rows 4t .. 4t+3
    // and transposes them into 8 columns of 4 k's; m-tile i's A rows g and
    // g + 8 are packed columns 8g + 2i and 8g + 2i + 1
    const uint8_t* st = smem + (tile % STAGES) * STAGE_BYTES;
    uint32_t wlo[4], whi[4], col[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint2 w = *reinterpret_cast<const uint2*>(
          st + ring_offset(warp * SLAB + 4 * t + r, g >> 1) + (g & 1) * 8);
      wlo[r] = w.x;
      whi[r] = w.y;
    }
    transpose4x4(wlo[0], wlo[1], wlo[2], wlo[3], col);
    transpose4x4(whi[0], whi[1], whi[2], whi[3], col + 4);
    // B fragment: activation row g, k's 4t .. 4t+3 of the slab
    const uint32_t b = *reinterpret_cast<const uint32_t*>(
        act + g * p.act_ld + (kt - k_begin) % KR + warp * SLAB + 4 * t);
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_s8(sum[i], col[2 * i], col[2 * i + 1], b);
    uint32_t apar[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) apar[j] = col[j] & pbits;
    const uint32_t b1 = b & 0x01010101u;
    // each chunk's own mma on B masked to the chunk's rows: at most acc_chunk
    // products in any accumulator that is decoded
    for (int j = 0; j < nch; ++j) {
      const uint32_t cm = cmask_s[j][t];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        int32_t part[4];
        mma_s8_new(part, col[2 * i], col[2 * i + 1], b & cm);
        if (OVERLAP) {
          // the chunk's parity dot on segment 1's LSB plane: bit `stride` of
          // par is the parity of segment 1's LSB products, below it zeros
          int32_t par[4];
          mma_s8_new(par, apar[2 * i], apar[2 * i + 1], b1 & cm);
#pragma unroll
          for (int e = 0; e < 4; ++e) seg0[i][e] += peel_low2<true>(part[e], par[e], p.stride);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) seg0[i][e] += peel_low2<false>(part[e], 0, p.stride);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it now holds the warps' outputs

  // segment 1 = (packed sum - segment 0) >> stride: the packed sum of every
  // chunk is seg0 + 2^stride seg1, so the chunks' top segments add up to it
  int4* red = reinterpret_cast<int4*>(smem);  // [WARPS][MT][2][32]: lane (g, t), row 2t + h
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int32_t s1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s1[e] = static_cast<int32_t>((static_cast<uint32_t>(sum[i][e]) - static_cast<uint32_t>(seg0[i][e])) >> p.stride);
    }
    red[((warp * MT + i) * 2 + 0) * 32 + lane] = make_int4(seg0[i][0], s1[0], seg0[i][2], s1[2]);
    red[((warp * MT + i) * 2 + 1) * 32 + lane] = make_int4(seg0[i][1], s1[1], seg0[i][3], s1[3]);
  }
  __syncthreads();
  int4 v = red[tid];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) add4(v, red[w * TILE4 + tid]);

  // thread tid holds m-tile i = tid / 64, row 2t + h (h = tid / 32 % 2, t =
  // tid % 4), packed columns j and j + 1 (j = 8 (tid % 32 / 4) + 2i): four
  // consecutive outputs in channel order
  auto store = [&](int4 o) {
    const int i = tid >> 6, h = (tid >> 5) & 1, l = tid & 31;
    const int m = m0 + 2 * (l & 3) + h, j = c0 + 8 * (l >> 2) + 2 * i;
    if (m >= p.M || j >= p.Np) return;
    int32_t* dst = p.out + static_cast<size_t>(m) * p.Np * 2 + 2 * j;
    if (j + 1 < p.Np && (p.Np & 1) == 0) {
      *reinterpret_cast<int4*>(dst) = o;
    } else {
      dst[0] = o.x;
      dst[1] = o.y;
      if (j + 1 < p.Np) {
        dst[2] = o.z;
        dst[3] = o.w;
      }
    }
  };
  if (p.splits == 1) {
    store(v);
    return;
  }
  reinterpret_cast<int4*>(p.ws)[static_cast<size_t>(blockIdx.x) * TILE4 + tid] = v;
  int32_t* counter = p.counters + ct * p.mtiles + mt;
  if (!last_to_arrive(counter, p.splits, &last_s)) return;
  // this tile's slabs: split s at first + s * step
  const int4* first = reinterpret_cast<const int4*>(p.ws) + (static_cast<size_t>(ct) * p.mtiles + mt) * TILE4 + tid;
  const size_t step = static_cast<size_t>(p.ctiles) * p.mtiles * TILE4;
  int4 total = make_int4(0, 0, 0, 0);
#pragma unroll 8
  for (int s = 0; s < p.splits; ++s) add4(total, __ldcg(first + s * step));
  store(total);
  if (tid == 0) *counter = 0;  // ready for the next launch, or the next replay of a graph
}

template <bool OVERLAP, int COPY>
cudaError_t launch(const Args& p, cudaStream_t s) {
  auto kern = quant_packed_mma_kernel<OVERLAP, COPY>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(MAX_SMEM));
  if (attr != cudaSuccess) return attr;
  const size_t smem = RING_BYTES + static_cast<size_t>(BM) * p.act_ld;
  kern<<<p.mtiles * p.ctiles * p.splits, THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace k5

}  // namespace

// K4: a i8 [M, K], w i8 [K, N], scale f32 [N] -> out f32 [M, N].  bm: the
// row tile (8, 32, 64 or 128; kernel.py k4_bm).  copy: 16 (N % 16 == 0, w
// 16-byte aligned), 4 (N % 4 == 0, w 4-byte aligned) or 1, the weight copy
// path.  splits, k_per_split: the K split (grid_plan with kernel.py K4_PLAN, a
// multiple of 32 when split); with splits > 1, ws holds bm * 128 ints per
// block and counters mtiles * ctiles zeros, which the kernel leaves at zero.
extern "C" int quant_matmul(const void* a, const void* w, const void* scale, void* out, void* ws,
                            void* counters, int M, int K, int N, int bm, int copy, int splits,
                            int k_per_split, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || K >= k4::MAX_K || splits < 1 || k_per_split < 1 ||
      static_cast<long long>(splits) * k_per_split < K ||
      (splits > 1 && (static_cast<long long>(splits - 1) * k_per_split >= K || k_per_split % k4::SLAB ||
                      ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t w_addr = reinterpret_cast<uintptr_t>(w);
  if ((copy == 16 && (N % 16 || w_addr % 16)) || (copy == 4 && (N % 4 || w_addr % 4)) ||
      (copy != 16 && copy != 4 && copy != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  k4::Args p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(w), static_cast<const float*>(scale),
             static_cast<float*>(out), static_cast<int32_t*>(ws), static_cast<int32_t*>(counters),
             M, K, N, splits, k_per_split, (M + bm - 1) / bm, (N + k4::BN - 1) / k4::BN,
             K % 16 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0};
  switch (bm) {
    case 8: return static_cast<int>(k4::launch_copy<8>(p, copy, s));
    case 32: return static_cast<int>(k4::launch_copy<32>(p, copy, s));
    case 64: return static_cast<int>(k4::launch_copy<64>(p, copy, s));
    case 128: return static_cast<int>(k4::launch_copy<128>(p, copy, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5: a i8 [M, K], wp i8 [K, Np] -> acc i32 [M, Np * n_seg] (channel order).
// copy: 16 (Np % 16 == 0, wp 16-byte aligned), 4 (Np % 4 == 0) or 1, the
// weight copy path (kernel.py copy_width).  splits, k_per_split: the K split
// (grid_plan with kernel.py K5_PLAN, a multiple of 16 when split); with
// splits > 1, ws holds one slab of 8 x 64 x 2 ints per block and counters
// mtiles * ctiles zeros, which the kernel leaves at zero.
extern "C" int quant_packed_matmul(const void* a, const void* wp, void* acc, void* ws, void* counters,
                                   int M, int K, int Np, int n_seg, int stride, int acc_chunk,
                                   int overlap, int copy, int splits, int k_per_split, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || Np <= 0) return 0;
  // two segments in an int8 word, the stolen bit's parity exact only while
  // no chunk's LSB count reaches 2^stride
  if (n_seg != 2 || stride < 1 || stride > 7 || acc_chunk < 1 ||
      (overlap && acc_chunk >= (1 << stride))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (K < 0 || splits < 1 || k_per_split < 1 || static_cast<long long>(splits) * k_per_split < K ||
      (splits > 1 && (static_cast<long long>(splits - 1) * k_per_split >= K || k_per_split % k5::SLAB ||
                      ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t w_addr = reinterpret_cast<uintptr_t>(wp);
  if ((copy == 16 && (Np % 16 || w_addr % 16)) || (copy == 4 && (Np % 4 || w_addr % 4)) ||
      (copy != 16 && copy != 4 && copy != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = min(k5::KR, k_per_split);
  k5::Args p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(wp), static_cast<int32_t*>(acc),
         static_cast<int32_t*>(ws), static_cast<int32_t*>(counters), M, K, Np, stride, acc_chunk, splits,
         k_per_split, (M + k5::BM - 1) / k5::BM, (Np + k5::BN - 1) / k5::BN,
         // a pitch of 16 mod 128 bytes: lane (g, t)'s B read hits bank 4g + t
         (rows + 127) / 128 * 128 + 16};
  switch ((overlap ? 3 : 0) + (copy == 16 ? 2 : copy == 4 ? 1 : 0)) {
    case 0: return static_cast<int>(k5::launch<false, 1>(p, s));
    case 1: return static_cast<int>(k5::launch<false, 4>(p, s));
    case 2: return static_cast<int>(k5::launch<false, 16>(p, s));
    case 3: return static_cast<int>(k5::launch<true, 1>(p, s));
    case 4: return static_cast<int>(k5::launch<true, 4>(p, s));
    default: return static_cast<int>(k5::launch<true, 16>(p, s));
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
