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
// peel.cuh.  Plain version: repro_torch/kernels/packed_matmul/kernel.py.
//
// What bounds it on this card.  A decode step multiplies M = 8 rows by
// packed int32 words: every word is read once and used for M rows, so the
// kernel moves 4 bytes per n_seg weights and does 2*M int32 multiply-adds
// per word (the packed dot plus, overpacked, the parity dot).  At M = 8 that
// is 16 integer ops per 4 bytes: near the balance point of the card's HBM
// (3.35 TB/s) against its int32 CUDA-core rate (132 SMs x 64 lanes x clock),
// so both bounds are within a factor of two of each other; the packed words
// are int32 and Hopper's integer tensor cores take only s8/u8, so the
// products run on the CUDA cores (IMAD).
//
// What the design does about it.  Each thread owns one packed column and
// BM = 8 activation rows, so each weight word is loaded once (coalesced
// across the warp) and reused for 8 rows from registers.  Activation levels
// for the block's rows are staged in shared memory one K tile at a time
// (quantized there, for K1), k-major so one k's 8 rows are two 16-byte
// loads that every thread of the block shares.  Partial sums stay in
// registers; after at most acc_chunk products they are peeled into
// per-segment int32 accumulators.  When the (N, M) grid alone would not
// fill the card, K is split across blocks (grid.z) and the integer results
// are combined with atomicAdd, which is exact and order-independent.  Any
// chunking with at most acc_chunk products per peel gives the same
// integers, so tile and split boundaries need not follow the TPU's cadence.
#include <cuda_runtime.h>

#include <cstdint>

#include "peel.cuh"

namespace {

constexpr int BM = 8;    // activation rows per block, one register set each
constexpr int BN = 128;  // packed columns per block, one per thread
constexpr int TK = 128;  // K rows of activation levels staged per tile
static_assert(TK == BN, "staging assigns one K column of the tile per thread");
static_assert(BM == 8, "a staged k row is read as two int4");

template <int NSEG, bool OVERLAP, bool FUSED>
__global__ void __launch_bounds__(BN)
packed_kernel(const float* __restrict__ x, const int32_t* __restrict__ a_lvl,
              const int32_t* __restrict__ wp, int32_t* __restrict__ out,
              int32_t* __restrict__ a_sum, int M, int K, int Np, int a_bits, int stride,
              int acc_chunk, int restart, int k_per_split) {
  __shared__ __align__(16) int32_t a_s[TK][BM];
  __shared__ int32_t rowsum_s[BM];
  const int tid = threadIdx.x;
  const int j = blockIdx.x * BN + tid;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool split = gridDim.z > 1;
  const bool do_sum = FUSED && blockIdx.x == 0;
  const float n_lvl = static_cast<float>((1 << a_bits) - 1);
  const uint32_t wmask = lsb_mask<NSEG>(stride);

  int32_t acc[BM][NSEG];
  int32_t rs[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    rs[r] = 0;
#pragma unroll
    for (int d = 0; d < NSEG; ++d) acc[r][d] = 0;
  }
  if (do_sum && tid < BM) rowsum_s[tid] = 0;

  for (int kt = k_begin; kt < k_end; kt += TK) {
    const int tk = min(TK, k_end - kt);
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const int m = m0 + r;
      int32_t lvl = 0;
      if (m < M && tid < tk) {
        const size_t idx = static_cast<size_t>(m) * K + kt + tid;
        if (FUSED) {
          // round(clip(x, 0, 1) * (2^a - 1)), round half to even
          const float v = fminf(fmaxf(x[idx], 0.f), 1.f);
          lvl = __float2int_rn(__fmul_rn(v, n_lvl));
        } else {
          lvl = a_lvl[idx];
        }
      }
      a_s[tid][r] = lvl;
      rs[r] += lvl;
    }
    __syncthreads();
    if (j < Np) {
      const int32_t* wcol = wp + j;
      for (int c0 = 0; c0 < tk;) {
        int n = min(tk - c0, acc_chunk);
        if (restart > 0) n = min(n, restart - (kt + c0) % restart);
        uint32_t part[BM], par[BM];
#pragma unroll
        for (int r = 0; r < BM; ++r) part[r] = par[r] = 0u;
#pragma unroll 4
        for (int c = c0; c < c0 + n; ++c) {
          const uint32_t w = static_cast<uint32_t>(__ldg(wcol + static_cast<size_t>(kt + c) * Np));
          const int4 lo = *reinterpret_cast<const int4*>(&a_s[c][0]);
          const int4 hi = *reinterpret_cast<const int4*>(&a_s[c][4]);
          const uint32_t a[BM] = {
              static_cast<uint32_t>(lo.x), static_cast<uint32_t>(lo.y),
              static_cast<uint32_t>(lo.z), static_cast<uint32_t>(lo.w),
              static_cast<uint32_t>(hi.x), static_cast<uint32_t>(hi.y),
              static_cast<uint32_t>(hi.z), static_cast<uint32_t>(hi.w)};
          const uint32_t wl = w & wmask;
#pragma unroll
          for (int r = 0; r < BM; ++r) {
            part[r] += a[r] * w;
            if (OVERLAP) par[r] += (a[r] & 1u) * wl;
          }
        }
#pragma unroll
        for (int r = 0; r < BM; ++r) peel_chunk<NSEG, OVERLAP>(part[r], par[r], stride, acc[r]);
        c0 += n;
      }
    }
  }

  if (j < Np) {
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const int m = m0 + r;
      if (m >= M) break;
      int32_t* o = out + static_cast<size_t>(m) * Np * NSEG + static_cast<size_t>(j) * NSEG;
#pragma unroll
      for (int d = 0; d < NSEG; ++d) {
        if (split) {
          atomicAdd(o + d, acc[r][d]);
        } else {
          o[d] = acc[r][d];
        }
      }
    }
  }
  if (do_sum) {
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      int32_t v = rs[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if ((tid & 31) == 0) atomicAdd(&rowsum_s[r], v);
    }
    __syncthreads();
    if (tid < BM && m0 + tid < M) {
      if (split) {
        atomicAdd(a_sum + m0 + tid, rowsum_s[tid]);
      } else {
        a_sum[m0 + tid] = rowsum_s[tid];
      }
    }
  }
}

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

template <int NSEG, bool OVERLAP, bool FUSED>
cudaError_t launch(const float* x, const int32_t* a, const int32_t* wp, int32_t* out,
                   int32_t* a_sum, int M, int K, int Np, int a_bits, int stride, int acc_chunk,
                   int restart, cudaStream_t s) {
  const int gx = (Np + BN - 1) / BN;
  const int gy = (M + BM - 1) / BM;
  const int tiles = (K + TK - 1) / TK;
  // split K across blocks until about two blocks per SM are in flight
  int splits = (2 * sm_count() + gx * gy - 1) / (gx * gy);
  splits = max(1, min(splits, tiles));
  const int k_per_split = ((tiles + splits - 1) / splits) * TK;
  splits = (K + k_per_split - 1) / k_per_split;
  if (splits > 1) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(M) * Np * NSEG, s);
    if (e != cudaSuccess) return e;
    if (FUSED) {
      e = cudaMemsetAsync(a_sum, 0, sizeof(int32_t) * static_cast<size_t>(M), s);
      if (e != cudaSuccess) return e;
    }
  }
  dim3 grid(gx, gy, splits);
  packed_kernel<NSEG, OVERLAP, FUSED><<<grid, BN, 0, s>>>(
      x, a, wp, out, a_sum, M, K, Np, a_bits, stride, acc_chunk, restart, k_per_split);
  return cudaGetLastError();
}

template <bool FUSED>
cudaError_t dispatch(const float* x, const int32_t* a, const int32_t* wp, int32_t* out,
                     int32_t* a_sum, int M, int K, int Np, int a_bits, int n_seg, int stride,
                     int acc_chunk, int overlap, int restart, cudaStream_t s) {
  if (M <= 0 || Np <= 0) return cudaSuccess;
  if (K <= 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(M) * Np * n_seg, s);
    if (e == cudaSuccess && FUSED) e = cudaMemsetAsync(a_sum, 0, sizeof(int32_t) * M, s);
    return e;
  }
  if (acc_chunk < 1 || stride < 1 || stride * n_seg > 32) return cudaErrorInvalidValue;
  switch (n_seg * 2 + (overlap ? 1 : 0)) {
    case 4: return launch<2, false, FUSED>(x, a, wp, out, a_sum, M, K, Np, a_bits, stride, acc_chunk, restart, s);
    case 5: return launch<2, true, FUSED>(x, a, wp, out, a_sum, M, K, Np, a_bits, stride, acc_chunk, restart, s);
    case 6: return launch<3, false, FUSED>(x, a, wp, out, a_sum, M, K, Np, a_bits, stride, acc_chunk, restart, s);
    case 7: return launch<3, true, FUSED>(x, a, wp, out, a_sum, M, K, Np, a_bits, stride, acc_chunk, restart, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K1: x f32 [M, K], wp i32 [K, Np] -> acc i32 [M, Np * n_seg], a_sum i32 [M]
extern "C" int packed_dense_fused(const void* x, const void* wp, void* acc, void* a_sum, int M,
                                  int K, int Np, int a_bits, int n_seg, int stride, int acc_chunk,
                                  int overlap, void* stream) {
  return static_cast<int>(dispatch<true>(
      static_cast<const float*>(x), nullptr, static_cast<const int32_t*>(wp),
      static_cast<int32_t*>(acc), static_cast<int32_t*>(a_sum), M, K, Np, a_bits, n_seg, stride,
      acc_chunk, overlap, 0, static_cast<cudaStream_t>(stream)));
}

// K2: a i32 [M, K], wp i32 [K, Np] -> acc i32 [M, Np * n_seg]; block_k <= 0
// or >= K means no chunk restarts
extern "C" int packed_matmul(const void* a, const void* wp, void* acc, int M, int K, int Np,
                             int n_seg, int stride, int acc_chunk, int overlap, int block_k,
                             void* stream) {
  const int restart = (block_k > 0 && block_k < K) ? block_k : 0;
  return static_cast<int>(dispatch<false>(
      nullptr, static_cast<const int32_t*>(a), static_cast<const int32_t*>(wp),
      static_cast<int32_t*>(acc), nullptr, M, K, Np, 0, n_seg, stride, acc_chunk, overlap,
      restart, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
