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
// What bounds them on this card.  At decode (M = 8) both read every weight
// byte once and use it for M rows: K4 does 2*M int8 ops per weight byte, K5
// 2*M (packed dot) plus 2*M (parity dot) per packed byte.  Against the int8
// tensor-core peak (1979 Tops/s) both are bound by HBM bytes (3.35 TB/s).
// These first kernels run on the CUDA cores instead: K4 with __dp4a (four
// int8 products per instruction), K5 with one IMAD per product, because the
// overpacked peel needs each chunk of at most acc_chunk products (7 or 3,
// not a multiple of 4) as its own partial sum.
//
// What the design does about it.  Each thread owns four consecutive output
// (K4) or packed (K5) columns, read as one 32-bit word per weight row
// (coalesced across the warp), and BM = 8 activation rows, so each weight
// word is loaded once and reused 8 times from registers.  Activation rows
// are staged in shared memory a K tile at a time and read as broadcasts.
// K4 transposes four weight rows into per-column words of four k's with
// __byte_perm before the __dp4a.  K5 sums at most acc_chunk products per
// partial sum (the peel's bound) and peels into per-segment accumulators;
// any chunking within that bound gives the same integers, so chunks need
// not follow the TPU's cadence.  When the (N, M) grid alone would not fill
// the card, K is split across blocks: K5 combines its int32 results with
// atomicAdd; K4 adds its int32 sums into a scratch and a second small
// kernel applies the scale, since the float product of a partial sum would
// not be the product of the whole.  Ragged M, N and K are masked in the
// kernels; N % 4 != 0 (or a misaligned base) takes byte loads.
#include <cuda_runtime.h>

#include <cstdint>

#include "peel.cuh"

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

template <int NSEG, bool OVERLAP, bool VEC>
__global__ void __launch_bounds__(THREADS)
quant_packed_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ wp,
                    int32_t* __restrict__ out, int M, int K, int Np, int stride, int acc_chunk,
                    int k_split) {
  __shared__ __align__(16) int32_t a_s[TK][BM];
  const int tid = threadIdx.x;
  const int j0 = (blockIdx.x * THREADS + tid) * CPT;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const uint32_t wmask = lsb_mask<NSEG>(stride);

  int32_t acc[BM][CPT][NSEG];
#pragma unroll
  for (int r = 0; r < BM; ++r) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
#pragma unroll
      for (int d = 0; d < NSEG; ++d) acc[r][c][d] = 0;
    }
  }

  for (int kt = k_begin; kt < k_end; kt += TK) {
    const int tk = min(TK, k_end - kt);
    __syncthreads();
    for (int i = tid; i < BM * TK; i += THREADS) {
      const int r = i / TK, k = i % TK, m = m0 + r;
      // int8 levels widen with their sign, as the reference's int8 -> int32 dot
      a_s[k][r] = (m < M && k < tk) ? static_cast<int32_t>(a[static_cast<size_t>(m) * K + kt + k]) : 0;
    }
    __syncthreads();
    if (j0 < Np) {
      for (int c0 = 0; c0 < tk;) {
        const int n = min(tk - c0, acc_chunk);
        uint32_t part[BM][CPT], par[BM][CPT];
#pragma unroll
        for (int r = 0; r < BM; ++r) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) part[r][c] = par[r][c] = 0u;
        }
        for (int k = c0; k < c0 + n; ++k) {
          const uint32_t w4 = load_word<VEC>(wp + static_cast<size_t>(kt + k) * Np, j0, Np);
          const int4 lo = *reinterpret_cast<const int4*>(&a_s[k][0]);
          const int4 hi = *reinterpret_cast<const int4*>(&a_s[k][4]);
          const uint32_t av[BM] = {
              static_cast<uint32_t>(lo.x), static_cast<uint32_t>(lo.y), static_cast<uint32_t>(lo.z),
              static_cast<uint32_t>(lo.w), static_cast<uint32_t>(hi.x), static_cast<uint32_t>(hi.y),
              static_cast<uint32_t>(hi.z), static_cast<uint32_t>(hi.w)};
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const uint32_t wc = static_cast<uint32_t>(static_cast<int32_t>(static_cast<int8_t>(w4 >> (8 * c))));
            const uint32_t wl = wc & wmask;
#pragma unroll
            for (int r = 0; r < BM; ++r) {
              part[r][c] += av[r] * wc;
              if (OVERLAP) par[r][c] += (av[r] & 1u) * wl;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < BM; ++r) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) peel_chunk<NSEG, OVERLAP>(part[r][c], par[r][c], stride, acc[r][c]);
        }
        c0 += n;
      }
    }
  }

  if (j0 >= Np) return;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = j0 + c;
      if (j >= Np) break;
      int32_t* o = out + (static_cast<size_t>(m) * Np + j) * NSEG;
#pragma unroll
      for (int d = 0; d < NSEG; ++d) {
        if (split) {
          atomicAdd(o + d, acc[r][c][d]);
        } else {
          o[d] = acc[r][c][d];
        }
      }
    }
  }
}

template <int NSEG, bool OVERLAP, bool VEC>
cudaError_t launch_packed(const int8_t* a, const int8_t* wp, int32_t* out, int M, int K, int Np,
                          int stride, int acc_chunk, cudaStream_t s) {
  const int gx = (Np + BN - 1) / BN, gy = (M + BM - 1) / BM;
  const int ks = k_per_split(K, gx * gy);
  const int splits = (K + ks - 1) / ks;
  if (splits > 1) {
    const cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(M) * Np * NSEG, s);
    if (e != cudaSuccess) return e;
  }
  quant_packed_kernel<NSEG, OVERLAP, VEC><<<dim3(gx, gy, splits), THREADS, 0, s>>>(
      a, wp, out, M, K, Np, stride, acc_chunk, ks);
  return cudaGetLastError();
}

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

// K5: a i8 [M, K], wp i8 [K, Np] -> acc i32 [M, Np * n_seg] (channel order)
extern "C" int quant_packed_matmul(const void* a, const void* wp, void* acc, int M, int K, int Np,
                                   int n_seg, int stride, int acc_chunk, int overlap, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || Np <= 0) return 0;
  if (K <= 0) {
    return static_cast<int>(cudaMemsetAsync(acc, 0, sizeof(int32_t) * static_cast<size_t>(M) * Np * n_seg, s));
  }
  if (acc_chunk < 1 || stride < 1 || stride * n_seg > 32) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* w8 = static_cast<const int8_t*>(wp);
  auto* o = static_cast<int32_t*>(acc);
  const bool vec = Np % 4 == 0 && aligned4(wp);
  if (n_seg != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (overlap) {
    return static_cast<int>(vec ? launch_packed<2, true, true>(a8, w8, o, M, K, Np, stride, acc_chunk, s)
                                : launch_packed<2, true, false>(a8, w8, o, M, K, Np, stride, acc_chunk, s));
  }
  return static_cast<int>(vec ? launch_packed<2, false, true>(a8, w8, o, M, K, Np, stride, acc_chunk, s)
                              : launch_packed<2, false, false>(a8, w8, o, M, K, Np, stride, acc_chunk, s));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
