// Kernel-Packing matmul for Hopper (sm_90a), kernels K1 and K2.
//
// Replaces the Pallas TPU kernels
//   K1 packed_dense_fused: repro/kernels/packed_matmul/kernel.py:111
//      packed_dense_fused_raw (body _kernel_fused, :100): quantize float
//      activations, whole-K packed dot with the chunked peel, interleave to
//      channel order, per-row level sums;
//   K2 packed_matmul: repro/kernels/packed_matmul/kernel.py:168
//      packed_matmul_raw (bodies _kernel_single_k :74, _kernel_blocked :83):
//      the same packed dot on activation levels, chunks restarting at every
//      multiple of block_k.
// The shared peel (repro/kernels/peel.py:69 peel_chunks, :122 interleave) is
// peel.cuh; the cp.async ring helpers and the split-K arrival are ring.cuh.
// Plain versions and the grid plan: repro_torch/kernels/packed_matmul/kernel.py.
//
// Batched over experts.  The reference vmaps both kernels over a leading
// expert axis for MoE (repro/models/moe.py:84 _expert_matmul), which Pallas
// turns into one kernel with an extra grid axis.  Here the same: E matrices
// [M, K] x [K, Np] in one launch, expert e at blockIdx.y = e, its operands,
// outputs, split-K slabs and arrival counters offset by e.  The offsets
// are a template flag (BATCHED), so the 2-D call (E = 1) runs an
// instantiation whose offsets fold to zero: the code it ran before the
// expert axis existed (an unconditional offset cost it 8-17 % a launch).
//
// What bounds it on this card.  A decode step multiplies M = 8 rows by
// int32 words that each pack n_seg weights: every word is read once and
// used for 8 rows.  The step's five shapes (llama3.2-3b, w4a4, n_seg 2)
// move 1.93 ms of bytes at 3.35 TB/s (head 0.237 ms, w_up|w_gate and
// w_down 0.015 ms each, wq|wo 0.0057, wk|wv 0.0019).  Per packed word the
// integer work is 8 IMADs (packed dot), 8 parity operations and about 3
// operations of peel: 6.7 Tops/s of IMAD at the bytes rate against the
// card's 16.7 Tops/s IMAD peak, about 16 Tops/s of integer work in all.
// Both bounds are close, so the design has to keep HBM busy and keep the
// instruction count per byte low.  Hopper's integer tensor cores take s8/u8
// only, so the int32 packed products run on the CUDA cores.
//
// What the design does about it.
// - Weight-tile ring.  Each block streams [TK = 64] x [BN = 64] tiles of
//   packed words (16 KB) through a ring of STAGES = 3 shared-memory stages
//   filled by cp.async: two stages (32 KB) stay in flight per block while the
//   third is consumed, 64 KB per SM at two blocks an SM (Little's law asks
//   for about 18 KB an SM at HBM latency).  16-byte cp.async and not TMA:
//   the tile is 64 rows of 256 contiguous bytes, which needs no tensor map
//   (and no libcuda link), and every thread both copies and computes.
// - Two copy paths.  A 16-byte copy needs a 16-byte-aligned source, so a
//   row stride of Np x 4 bytes that is a multiple of 16 (Np % 4 == 0, as at
//   every full-width shape) takes 16-byte copies; a ragged stride (Np = 33,
//   7, ...) takes 4-byte copies into the same ring layout.  TMA would trap
//   the same way (16-byte base and row stride).  The wrapper picks the path
//   from Np alone (VEC below); both are exact and tested.
// - Threads.  256 threads: warp w takes rows [8w, 8w + 8) of every stage,
//   each lane two adjacent packed columns (one 8-byte shared load) for all
//   8 activation rows, which sit in shared memory k-major (two broadcast
//   16-byte loads a row).  The 8 warps' partial sums are added through
//   shared memory (the ring, reused) at the end.
// - Grid.  One block per (row tile of 8, column tile of 64, K split), the
//   column tiles of one split adjacent so that running blocks read whole
//   weight rows.  The plan (kernel.py grid_plan) splits K until the blocks
//   fill two per SM, every block moving the same bytes: on 132 SMs wq|wo
//   24 tiles x 11 splits = 264 blocks, wk|wv 8 x 32 = 256, w_up|w_gate
//   64 x 4 = 256, w_down 24 x 11 = 264; the head's 1002 tiles run unsplit.
// - K splits reduced in the kernel, no memset.  With splits > 1 each block
//   writes its int32 partials to a workspace the wrapper allocates, and adds
//   one to its tile's arrival counter; the last block to arrive sums the
//   partials in split order, writes acc (and a_sum), and puts the counter
//   back to 0.  The counters are zeroed once per device, so a CUDA graph
//   may replay the launch.  Integer sums are exact in any order.  (A
//   cluster reduction through distributed shared memory caps splits at 8,
//   too few for wk|wv.)
// - Parity by XOR.  Overpacked, the peel reads only bit (d+1)*stride of the
//   parity word; every stride-aligned counter of the additive parity dot
//   holds at most acc_chunk < 2^stride ones per chunk (checked on the host,
//   18 < 2^11 for w4a4), so no carry reaches the bit the next counter's peel
//   reads, and an XOR has the same bits there.  At n_seg 2 (stride >= 8,
//   checked) one word per column holds all 8 rows: row r's bit of segment d
//   at d*stride + r.  Staging precomputes per k the word of the rows' level
//   LSBs; per row and packed word the parity is then (w & lsb) * 0xFF (each
//   segment LSB widened over 8 rows) AND that word, XORed in: 3 operations
//   for all 8 rows instead of 8.  At n_seg 3 (stride 6 exists) each row
//   keeps its own word, par ^= w & (lsb & -(a & 1)) with the mask staged.
// - Peel cadence.  A chunk holds at most acc_chunk products and, for K2,
//   never crosses a multiple of block_k; any such chunking gives the same
//   integers, so chunks need not follow tile or warp boundaries.
// - K1 quantizes its activations (round(clip(x, 0, 1) * (2^a - 1)), half to
//   even) into shared memory once per block, 768 K rows at a time, and sums
//   each row's levels there.
//
// Measured (perf/ab_packed_matmul.py and chip_smoke.py, H100 SXM at 700 W,
// cold weights, PERF.md section 6): K1 4.6 ms per decode step, K2 4.0, from
// 11.8 and 10.8; the head at 2.1 TB/s, the layer shapes at 0.5-1.6 TB/s,
// where the launch, the first stage's latency and the split reduction
// (several microseconds a launch) weigh most.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "peel.cuh"
#include "ring.cuh"

namespace {

constexpr int BM = 8;        // activation rows per block
constexpr int BN = 64;       // packed columns per block: 2 per lane of a warp
constexpr int TK = 64;       // K rows per ring stage
constexpr int STAGES = 3;    // ring depth
constexpr int KW = 8;        // warps, each taking ROWS rows of every stage
constexpr int THREADS = KW * 32;
constexpr int ROWS = TK / KW;
constexpr int KR = 768;      // K rows of activations staged at a time
constexpr int ACT = 2 * BM;  // ints per staged k: 8 levels, then the parity operand(s)
constexpr int RING_INTS = STAGES * TK * BN;
constexpr size_t MAX_SMEM = sizeof(int32_t) * (RING_INTS + KR * ACT);
static_assert(KR % TK == 0, "activation pieces start on a ring tile");
static_assert(KW * BM * BN * 3 <= RING_INTS, "the warps' partial sums reuse the ring");
static_assert(BM == 8, "a staged k's levels and masks are read as four int4");
static_assert(KR % THREADS == 0, "each thread stages KR / THREADS K rows");

struct Args {
  const float* x;       // K1: [M, K] float activations
  const int32_t* a;     // K2: [M, K] activation levels
  const int32_t* wp;    // [K, Np] packed words
  int32_t* out;         // [M, Np * n_seg]
  int32_t* a_sum;       // K1: [M]
  int32_t* ws;          // splits > 1: one slab of partials per block
  int32_t* counters;    // splits > 1: one arrival counter per (row, column) tile, all 0
  int M, K, Np, a_bits, stride, acc_chunk, restart, splits, k_per_split, mtiles, ctiles;
  int E;                // batched matrices (experts), one per blockIdx.y
};

template <int NSEG, bool OVERLAP, bool FUSED, bool VEC, bool BATCHED>
__global__ void __launch_bounds__(THREADS, NSEG == 2 ? 2 : 1) packed_ring_kernel(const Args p) {
  // overpacked parity: one word per column for all rows (n_seg 2, stride >= BM,
  // checked on the host) or one word per row and column
  constexpr bool PACKED_PAR = NSEG == 2;
  extern __shared__ __align__(16) int32_t smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);  // [STAGES][TK][BN]
  int32_t* act = smem + RING_INTS;                     // [KR][ACT]
  __shared__ int32_t rowsum_s[BM];
  __shared__ int last_s;
  constexpr int TILE = BM * BN * NSEG;  // one block's outputs, row-major in channel order
  constexpr int SLAB = TILE + BM;       // ints of workspace per block: partials, then row sums
  static_assert(SLAB % 4 == 0, "slabs are read as int4");

  // expert blockIdx.y: its operands, outputs, slabs and counters (all
  // unused pointers stay unused: x or a, a_sum, ws and counters may be null)
  const size_t e = BATCHED ? blockIdx.y : 0;
  const float* xe = p.x + e * p.M * p.K;
  const int32_t* ae = p.a + e * p.M * p.K;
  const int32_t* wpe = p.wp + e * p.K * p.Np;
  int32_t* oute = p.out + e * p.M * p.Np * NSEG;
  int32_t* a_sume = p.a_sum + e * p.M;
  int32_t* wse = p.ws + e * gridDim.x * SLAB;
  int32_t* counterse = p.counters + e * p.mtiles * p.ctiles;

  const int tid = threadIdx.x, lane = tid & 31, kw = tid >> 5;
  // blockIdx.x = (split * ctiles + ct) * mtiles + mt: blocks that run together
  // read the same weight rows (whole rows of a layer) and, for M > BM, the
  // same tile (from L2)
  int u = blockIdx.x;
  const int mt = u % p.mtiles;
  u /= p.mtiles;
  const int ct = u % p.ctiles;
  const int split = u / p.ctiles;
  const int m0 = mt * BM, c0 = ct * BN;
  const int k_begin = split * p.k_per_split;
  const int k_end = min(p.K, k_begin + p.k_per_split);
  const int n_tiles = (k_end - k_begin + TK - 1) / TK;
  const uint32_t lsb = lsb_mask<NSEG>(p.stride);
  const uint32_t ring_base = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  // ring stage t <- weight rows [k_begin + t*TK, +TK) x columns [c0, c0+BN);
  // rows and columns outside the matrix are filled with zeros.  A thread
  // copies one column chunk (16 or 4 bytes) of every CH-th row.
  constexpr int CW = VEC ? 4 : 1;        // words per copy
  constexpr int CH = THREADS * CW / BN;  // rows apart
  const int col = c0 + (tid % (BN / CW)) * CW;
  const int32_t* src_col = wpe + min(col, p.Np - 1);
  const uint32_t dst_thread = ring_base + sizeof(uint32_t) * ((tid / (BN / CW)) * BN + col - c0);
  auto fetch = [&](int t) {
    if (t < n_tiles) {
      const int k0 = k_begin + t * TK + tid / (BN / CW);
      const uint32_t dst = dst_thread + sizeof(uint32_t) * (t % STAGES) * TK * BN;
      auto copy = [&](int j) {
        const int k = k0 + j * CH;
        const bool ok = k < k_end && col < p.Np;
        const int32_t* src = ok ? src_col + static_cast<size_t>(k) * p.Np : wpe;
        const uint32_t d = dst + sizeof(uint32_t) * j * CH * BN;
        if (VEC) {
          cp_async16(d, src, ok ? 16 : 0);
        } else {
          cp_async4(d, src, ok ? 4 : 0);
        }
      };
      if (VEC) {
#pragma unroll
        for (int j = 0; j < TK / CH; ++j) copy(j);
      } else {
#pragma unroll 1
        for (int j = 0; j < TK / CH; ++j) copy(j);
      }
    }
    cp_commit();  // one group per stage, empty past the end, so the waits count stages
  };

  // activation levels of rows [m0, m0+BM) and K rows [kp, kp + KR), k-major:
  // thread i stages k = kp + i, j * THREADS apart, loading all its levels
  // before it stores any.  Beside the levels, the parity operand: with
  // PACKED_PAR one word holding every row's LSB at bit d*stride + r of each
  // segment d, else each row's mask lsb & -(a & 1).  K1 quantizes here and
  // sums each row's levels.
  auto stage_act = [&](int kp) {
    const int n = min(KR, k_end - kp);
    const float n_lvl = static_cast<float>((1 << p.a_bits) - 1);
    int32_t rs[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) rs[r] = 0;
#pragma unroll
    for (int j = 0; j < KR / THREADS; ++j) {
      const int i = tid + j * THREADS;
      int32_t lvl[BM];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        lvl[r] = 0;
        if (i < n && m0 + r < p.M) {
          const size_t idx = static_cast<size_t>(m0 + r) * p.K + kp + i;
          if (FUSED) {
            // round(clip(x, 0, 1) * (2^a - 1)), round half to even
            const float v = fminf(fmaxf(xe[idx], 0.f), 1.f);
            lvl[r] = __float2int_rn(__fmul_rn(v, n_lvl));
          } else {
            lvl[r] = ae[idx];
          }
        }
        rs[r] += lvl[r];
      }
      if (i < n) {
        int4* dst = reinterpret_cast<int4*>(act + i * ACT);
        dst[0] = make_int4(lvl[0], lvl[1], lvl[2], lvl[3]);
        dst[1] = make_int4(lvl[4], lvl[5], lvl[6], lvl[7]);
        if (PACKED_PAR) {
          uint32_t bits = 0;
#pragma unroll
          for (int r = 0; r < BM; ++r) bits |= (static_cast<uint32_t>(lvl[r]) & 1u) << r;
          uint32_t word = 0;
#pragma unroll
          for (int d = 0; d < NSEG; ++d) word |= bits << (d * p.stride);
          act[i * ACT + BM] = static_cast<int32_t>(word);
        } else {
          int32_t m[BM];
#pragma unroll
          for (int r = 0; r < BM; ++r) m[r] = static_cast<int32_t>(lsb & (0u - (static_cast<uint32_t>(lvl[r]) & 1u)));
          dst[2] = make_int4(m[0], m[1], m[2], m[3]);
          dst[3] = make_int4(m[4], m[5], m[6], m[7]);
        }
      }
    }
    if (FUSED) {
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        int32_t s = rs[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) atomicAdd(&rowsum_s[r], s);
      }
    }
  };

  for (int t = 0; t < STAGES - 1; ++t) fetch(t);
  if (FUSED && tid < BM) rowsum_s[tid] = 0;
  __syncthreads();
  stage_act(k_begin);

  // packed partial sums and parity of the open chunk; with PACKED_PAR one
  // parity word per column serves all BM rows
  constexpr int PR = PACKED_PAR ? 1 : BM;
  uint32_t part[BM][2], par[PR][2];
  int32_t acc[BM][2][NSEG];
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      part[r][c] = 0u;
      if (r < PR) par[r][c] = 0u;
#pragma unroll
      for (int d = 0; d < NSEG; ++d) acc[r][c][d] = 0;
    }
  }
  auto peel_all = [&]() {
#pragma unroll
    for (int r = 0; r < BM; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // row r's parity bits sit r above the bits the peel reads
        const uint32_t parity = PACKED_PAR ? par[0][c] >> r : par[r < PR ? r : 0][c];
        peel_chunk<NSEG, OVERLAP>(part[r][c], parity, p.stride, acc[r][c]);
        part[r][c] = 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < PR; ++r) par[r][0] = par[r][1] = 0u;
  };
  const int restart = FUSED ? 0 : p.restart;  // K1 never restarts its chunks
  int cnt = 0;                                // products in the open chunk
  int blk_end = restart > 0 ? INT_MIN : INT_MAX;  // K2: the next multiple of block_k

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<STAGES - 2>();  // this thread's copies of stage t have landed
    __syncthreads();        // everyone's have, and stage t - 1 is consumed
    fetch(t + STAGES - 1);  // into the slot stage t - 1 held
    const int kt = k_begin + t * TK;
    if (t > 0 && (kt - k_begin) % KR == 0) {
      stage_act(kt);
      __syncthreads();
    }
    const uint32_t* tile = ring + (t % STAGES) * TK * BN + lane * 2;
    const int32_t* av = act + ((kt - k_begin) % KR) * ACT;
    const int r_end = min(ROWS, k_end - kt - kw * ROWS);
#pragma unroll 2
    for (int i = 0; i < r_end; ++i) {
      const int row = kw * ROWS + i;
      const int k = kt + row;
      if (cnt == p.acc_chunk || k >= blk_end) {  // warp-uniform
        peel_all();
        cnt = 0;
        if (k >= blk_end) blk_end = (k / p.restart + 1) * p.restart;  // K2 only
      }
      const uint2 w = *reinterpret_cast<const uint2*>(tile + row * BN);
      const int4* a4 = reinterpret_cast<const int4*>(av + row * ACT);
      const int4 lo = a4[0], hi = a4[1];
      const uint32_t a[BM] = {
          static_cast<uint32_t>(lo.x), static_cast<uint32_t>(lo.y), static_cast<uint32_t>(lo.z),
          static_cast<uint32_t>(lo.w), static_cast<uint32_t>(hi.x), static_cast<uint32_t>(hi.y),
          static_cast<uint32_t>(hi.z), static_cast<uint32_t>(hi.w)};
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        part[r][0] += a[r] * w.x;
        part[r][1] += a[r] * w.y;
      }
      if (OVERLAP && PACKED_PAR) {
        // (w & lsb) * 0xFF widens each segment's LSB into BM bits (stride >= BM,
        // no carries); the staged word keeps the rows whose level is odd
        const uint32_t s = static_cast<uint32_t>(av[row * ACT + BM]);
        par[0][0] ^= ((w.x & lsb) * 0xFFu) & s;
        par[0][1] ^= ((w.y & lsb) * 0xFFu) & s;
      } else if (OVERLAP) {
        const int4 mlo = a4[2], mhi = a4[3];
        const uint32_t am[BM] = {
            static_cast<uint32_t>(mlo.x), static_cast<uint32_t>(mlo.y), static_cast<uint32_t>(mlo.z),
            static_cast<uint32_t>(mlo.w), static_cast<uint32_t>(mhi.x), static_cast<uint32_t>(mhi.y),
            static_cast<uint32_t>(mhi.z), static_cast<uint32_t>(mhi.w)};
#pragma unroll
        for (int r = 0; r < PR; ++r) {
          par[r][0] ^= w.x & am[r];
          par[r][1] ^= w.y & am[r];
        }
      }
      ++cnt;
    }
  }
  peel_all();
  cp_wait<0>();
  __syncthreads();  // the ring is free: it now holds the warps' partial sums

  constexpr int Q = TILE / 4;  // one block's outputs as int4
  int32_t* red = smem;                  // [KW][BM][BN * NSEG]
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int d = 0; d < NSEG; ++d) red[kw * TILE + r * BN * NSEG + (lane * 2 + c) * NSEG + d] = acc[r][c][d];
    }
  }
  __syncthreads();

  const int ncols = min(BN, p.Np - c0) * NSEG;  // valid outputs per row of this tile
  const size_t ld = static_cast<size_t>(p.Np) * NSEG;
  const bool sums = FUSED && ct == 0;
  // 4 outputs o = 4q .. 4q + 3, all in row o / (BN * NSEG)
  auto store4 = [&](int q, int4 v) {
    const int o = 4 * q, r = o / (BN * NSEG), j = o % (BN * NSEG);
    if (m0 + r >= p.M) return;
    int32_t* dst = oute + (m0 + r) * ld + c0 * NSEG + j;
    const int32_t e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (j + x < ncols) dst[x] = e[x];
    }
  };
  auto add4 = [](int4& v, int4 t) {
    v.x += t.x;
    v.y += t.y;
    v.z += t.z;
    v.w += t.w;
  };
  const int4* red4 = reinterpret_cast<const int4*>(red);
  if (p.splits == 1) {
    for (int q = tid; q < Q; q += THREADS) {
      int4 v = red4[q];
#pragma unroll
      for (int w = 1; w < KW; ++w) add4(v, red4[w * Q + q]);
      store4(q, v);
    }
    if (sums && tid < BM && m0 + tid < p.M) a_sume[m0 + tid] = rowsum_s[tid];
    return;
  }

  int4* mine = reinterpret_cast<int4*>(wse + static_cast<size_t>(blockIdx.x) * SLAB);
  for (int q = tid; q < Q; q += THREADS) {
    int4 v = red4[q];
#pragma unroll
    for (int w = 1; w < KW; ++w) add4(v, red4[w * Q + q]);
    mine[q] = v;
  }
  if (sums && tid < BM) wse[static_cast<size_t>(blockIdx.x) * SLAB + TILE + tid] = rowsum_s[tid];
  int32_t* counter = counterse + ct * p.mtiles + mt;
  if (!last_to_arrive(counter, p.splits, &last_s)) return;
  // this tile's slabs: split s at first + s * step
  const int32_t* first = wse + (static_cast<size_t>(ct) * p.mtiles + mt) * SLAB;
  const size_t step = static_cast<size_t>(p.ctiles) * p.mtiles * SLAB;
  for (int q = tid; q < Q; q += THREADS) {
    int4 v = make_int4(0, 0, 0, 0);
#pragma unroll 8
    for (int s = 0; s < p.splits; ++s) add4(v, __ldcg(reinterpret_cast<const int4*>(first + s * step) + q));
    store4(q, v);
  }
  if (sums && tid < BM && m0 + tid < p.M) {
    int32_t v = 0;
    for (int s = 0; s < p.splits; ++s) v += __ldcg(first + s * step + TILE + tid);
    a_sume[m0 + tid] = v;
  }
  if (tid == 0) *counter = 0;  // ready for the next launch, or the next replay of a graph
}

template <int NSEG, bool OVERLAP, bool FUSED, bool VEC, bool BATCHED>
cudaError_t launch(const Args& p, cudaStream_t s) {
  auto kern = packed_ring_kernel<NSEG, OVERLAP, FUSED, VEC, BATCHED>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(MAX_SMEM));
  if (attr != cudaSuccess) return attr;
  const size_t smem = sizeof(int32_t) * (RING_INTS + min(KR, p.k_per_split) * ACT);
  kern<<<dim3(p.mtiles * p.ctiles * p.splits, p.E), THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <bool FUSED, bool BATCHED>
cudaError_t dispatch_placement(const Args& p, int n_seg, int overlap, int vec, cudaStream_t s) {
  switch ((n_seg * 2 + (overlap ? 1 : 0)) * 2 + (vec ? 1 : 0)) {
    case 8: return launch<2, false, FUSED, false, BATCHED>(p, s);
    case 9: return launch<2, false, FUSED, true, BATCHED>(p, s);
    case 10: return launch<2, true, FUSED, false, BATCHED>(p, s);
    case 11: return launch<2, true, FUSED, true, BATCHED>(p, s);
    case 12: return launch<3, false, FUSED, false, BATCHED>(p, s);
    case 13: return launch<3, false, FUSED, true, BATCHED>(p, s);
    case 14: return launch<3, true, FUSED, false, BATCHED>(p, s);
    case 15: return launch<3, true, FUSED, true, BATCHED>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FUSED>
cudaError_t dispatch(Args p, int n_seg, int overlap, int vec, cudaStream_t s) {
  if (p.M <= 0 || p.Np <= 0 || p.E == 0) return cudaSuccess;
  if (p.E < 0 || p.E > 65535) return cudaErrorInvalidValue;  // gridDim.y
  if (p.acc_chunk < 1 || p.stride < 1 || p.stride * n_seg > 32) return cudaErrorInvalidValue;
  // the XOR parity word is exact only while no stride-aligned counter can carry
  if (overlap && p.acc_chunk >= (1 << p.stride)) return cudaErrorInvalidValue;
  // n_seg 2 keeps all rows' parity in one word: each segment's BM row bits
  if (overlap && n_seg == 2 && p.stride < BM) return cudaErrorInvalidValue;
  // the K split covers [0, K) and leaves no block an empty range
  if (p.K < 0 || p.splits < 1 || p.k_per_split < 1 ||
      static_cast<long long>(p.splits) * p.k_per_split < p.K ||
      (p.splits > 1 && static_cast<long long>(p.splits - 1) * p.k_per_split >= p.K)) {
    return cudaErrorInvalidValue;
  }
  if (p.splits > 1 && (p.ws == nullptr || p.counters == nullptr)) return cudaErrorInvalidValue;
  if (vec && (p.Np % 4 != 0 || reinterpret_cast<uintptr_t>(p.wp) % 16 != 0)) return cudaErrorInvalidValue;
  p.mtiles = (p.M + BM - 1) / BM;
  p.ctiles = (p.Np + BN - 1) / BN;
  if (p.E > 1) return dispatch_placement<FUSED, true>(p, n_seg, overlap, vec, s);
  return dispatch_placement<FUSED, false>(p, n_seg, overlap, vec, s);
}

}  // namespace

// K1: x f32 [E, M, K], wp i32 [E, K, Np] -> acc i32 [E, M, Np * n_seg],
// a_sum i32 [E, M]; E = 1 is the 2-D call.
// vec: 16-byte weight copies (Np % 4 == 0, wp 16-byte aligned), else 4-byte.
// splits, k_per_split: the K split (kernel.py grid_plan); with splits > 1,
// ws holds E * mtiles * ctiles * splits slabs of BM * (BN * n_seg + 1) ints
// and counters E * mtiles * ctiles zeros, which the kernel leaves at zero.
extern "C" int packed_dense_fused(const void* x, const void* wp, void* acc, void* a_sum, void* ws,
                                  void* counters, int E, int M, int K, int Np, int a_bits, int n_seg,
                                  int stride, int acc_chunk, int overlap, int vec, int splits,
                                  int k_per_split, void* stream) {
  Args p{static_cast<const float*>(x), nullptr, static_cast<const int32_t*>(wp),
         static_cast<int32_t*>(acc), static_cast<int32_t*>(a_sum), static_cast<int32_t*>(ws),
         static_cast<int32_t*>(counters), M, K, Np, a_bits, stride, acc_chunk, 0, splits,
         k_per_split, 0, 0, E};
  return static_cast<int>(dispatch<true>(p, n_seg, overlap, vec, static_cast<cudaStream_t>(stream)));
}

// K2: a i32 [E, M, K], wp i32 [E, K, Np] -> acc i32 [E, M, Np * n_seg];
// block_k <= 0 or >= K means no chunk restarts; the other arguments as K1's
extern "C" int packed_matmul(const void* a, const void* wp, void* acc, void* ws, void* counters,
                             int E, int M, int K, int Np, int n_seg, int stride, int acc_chunk,
                             int overlap, int block_k, int vec, int splits, int k_per_split,
                             void* stream) {
  const int restart = (block_k > 0 && block_k < K) ? block_k : 0;
  Args p{nullptr, static_cast<const int32_t*>(a), static_cast<const int32_t*>(wp),
         static_cast<int32_t*>(acc), nullptr, static_cast<int32_t*>(ws),
         static_cast<int32_t*>(counters), M, K, Np, 0, stride, acc_chunk, restart, splits,
         k_per_split, 0, 0, E};
  return static_cast<int>(dispatch<false>(p, n_seg, overlap, vec, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
