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
// K4.  At decode (M = 8) it reads every weight byte once and does 2*M int8
// ops per byte: bound by HBM bytes (3.35 TB/s) against the int8 tensor-core
// peak (1979 Tops/s).  It runs on the CUDA cores with __dp4a (four int8
// products per instruction).  Each thread owns four consecutive output
// columns, read as one 32-bit word per weight row (coalesced across the
// warp), and BM = 8 activation rows, so each weight word is loaded once and
// reused 8 times from registers; activation rows are staged in shared memory
// a K tile at a time and read as broadcasts; four weight rows are transposed
// into per-column words of four k's with __byte_perm before the __dp4a.  When
// the (N, M) grid alone would not fill the card, K is split across blocks:
// the int32 sums go to a scratch and a second small kernel applies the scale,
// since the float product of a partial sum would not be the product of the
// whole.  Ragged M, N and K are masked; N % 4 != 0 (or a misaligned base)
// takes byte loads.
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

constexpr int BM = 8;        // activation rows per block, one register set each
constexpr int THREADS = 64;  // threads per block
constexpr int CPT = 4;       // columns per thread: one 32-bit word of a weight row
constexpr int BN = THREADS * CPT;
constexpr int TK = 128;      // K rows of activations staged per tile
static_assert(BM == 8, "a staged row group is read as two int4");

// the card's SM count, read once (132 on an H100 SXM if the query fails)
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0) {
      n = 132;
    }
  }
  return n;
}

// K rows per block when K is split across gridDim.z so that about two
// blocks per SM are in flight; a multiple of TK.  `blocks` is the (N, M)
// grid's size.
int k_per_split(int K, int blocks) {
  const int tiles = (K + TK - 1) / TK;
  const int splits = max(1, min(tiles, (2 * sm_count() + blocks - 1) / blocks));
  return ((tiles + splits - 1) / splits) * TK;
}

// four consecutive int8 of one weight row, column n0 in byte 0; columns at
// or past N read as 0
template <bool VEC>
__device__ __forceinline__ uint32_t load_word(const int8_t* row, int n0, int N) {
  if (VEC) return __ldg(reinterpret_cast<const unsigned int*>(row + n0));
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    if (n0 + c < N) v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(row + n0 + c))) << (8 * c);
  }
  return v;
}

// ---- K4 -----------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int32_t* __restrict__ ws, int M, int K, int N, int k_split) {
  // a_s[q][r]: activations k = 4q .. 4q+3 of row r, k in byte k - 4q
  __shared__ __align__(16) uint32_t a_s[TK / 4][BM];
  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x * THREADS + tid) * CPT;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);

  int32_t acc[BM][CPT];
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0;
  }

  for (int kt = k_begin; kt < k_end; kt += TK) {
    const int tk = min(TK, k_end - kt);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BM * (TK / 4); i += THREADS) {
      const int r = i / (TK / 4), q = i % (TK / 4), m = m0 + r;
      uint32_t word = 0;
      if (m < M) {
        const int8_t* arow = a + static_cast<size_t>(m) * K + kt;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (4 * q + b < tk) word |= static_cast<uint32_t>(static_cast<uint8_t>(arow[4 * q + b])) << (8 * b);
        }
      }
      a_s[q][r] = word;
    }
    __syncthreads();
    if (n0 < N) {
      const int nq = (tk + 3) / 4;
#pragma unroll 2
      for (int q = 0; q < nq; ++q) {
        const int k = kt + 4 * q;
        uint32_t row[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          row[i] = (k + i < k_end) ? load_word<VEC>(w + static_cast<size_t>(k + i) * N, n0, N) : 0u;
        }
        // transpose: col[c] holds column c's weights for k .. k+3, k in byte 0
        const uint32_t t0 = __byte_perm(row[0], row[1], 0x5140);
        const uint32_t t1 = __byte_perm(row[0], row[1], 0x7362);
        const uint32_t t2 = __byte_perm(row[2], row[3], 0x5140);
        const uint32_t t3 = __byte_perm(row[2], row[3], 0x7362);
        const int col[CPT] = {
            static_cast<int>(__byte_perm(t0, t2, 0x5410)), static_cast<int>(__byte_perm(t0, t2, 0x7632)),
            static_cast<int>(__byte_perm(t1, t3, 0x5410)), static_cast<int>(__byte_perm(t1, t3, 0x7632))};
        const uint4 lo = *reinterpret_cast<const uint4*>(&a_s[q][0]);
        const uint4 hi = *reinterpret_cast<const uint4*>(&a_s[q][4]);
        const int av[BM] = {static_cast<int>(lo.x), static_cast<int>(lo.y), static_cast<int>(lo.z),
                            static_cast<int>(lo.w), static_cast<int>(hi.x), static_cast<int>(hi.y),
                            static_cast<int>(hi.z), static_cast<int>(hi.w)};
#pragma unroll
        for (int r = 0; r < BM; ++r) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = __dp4a(av[r], col[c], acc[r][c]);
        }
      }
    }
  }

  if (n0 >= N) return;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int n = n0 + c;
      if (n >= N) break;
      const size_t idx = static_cast<size_t>(m) * N + n;
      if (split) {
        atomicAdd(ws + idx, acc[r][c]);
      } else {
        // one rounding: float(acc) times the combined scale, as the reference
        out[idx] = __fmul_rn(__int2float_rn(acc[r][c]), scale[n]);
      }
    }
  }
}

__global__ void scale_kernel(const int32_t* __restrict__ ws, const float* __restrict__ scale,
                             float* __restrict__ out, int M, int N) {
  const size_t total = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    out[i] = __fmul_rn(__int2float_rn(ws[i]), scale[i % N]);
  }
}

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

__device__ __forceinline__ void add4(int4& v, int4 t) {
  v.x += t.x;
  v.y += t.y;
  v.z += t.z;
  v.w += t.w;
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

bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3u) == 0; }

}  // namespace

// K4: a i8 [M, K], w i8 [K, N], scale f32 [N] -> out f32 [M, N];
// ws i32 [M, N] is the scratch of a K split
extern "C" int quant_matmul(const void* a, const void* w, const void* scale, void* out, void* ws,
                            int M, int K, int N, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0) return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(float) * static_cast<size_t>(M) * N, s));
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* w8 = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  auto* acc = static_cast<int32_t*>(ws);
  const int gx = (N + BN - 1) / BN, gy = (M + BM - 1) / BM;
  const int ks = k_per_split(K, gx * gy);
  const int splits = (K + ks - 1) / ks;
  if (splits > 1) {
    const cudaError_t e = cudaMemsetAsync(acc, 0, sizeof(int32_t) * static_cast<size_t>(M) * N, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(gx, gy, splits);
  if (N % 4 == 0 && aligned4(w)) {
    quant_matmul_kernel<true><<<grid, THREADS, 0, s>>>(a8, w8, sc, o, acc, M, K, N, ks);
  } else {
    quant_matmul_kernel<false><<<grid, THREADS, 0, s>>>(a8, w8, sc, o, acc, M, K, N, ks);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t total = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  scale_kernel<<<blocks, 256, 0, s>>>(acc, sc, o, M, N);
  return static_cast<int>(cudaGetLastError());
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
