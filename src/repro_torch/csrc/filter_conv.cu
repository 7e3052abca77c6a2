// Filter-Packing 1-D convolution for Hopper (sm_90a), kernel K6.
//
// Replaces the Pallas TPU kernel repro/kernels/filter_conv/kernel.py:155
// filter_conv_raw (body _kernel, :67): the full convolution of each
// sequence row s[b, c, :] with its channel's filter f[c, :], summed over the
// channels, int32 [B, N + K - 1], by the paper's Filter Packing (Eq. 2).  n_p
// sequence levels and k_p filter taps are packed at `stride`-bit segments,
// so one 32-bit multiply yields the k_p + n_p - 1 coefficients of their
// polynomial product.  Products of at most acc_chunk channels are summed
// before the decode (the placement's guard bits allow it); overpacked
// placements recover each segment's stolen bit with the Fig. 3 parity dot
// of the two words' LSB planes (peel.cuh).  Plain version:
// repro_torch/kernels/filter_conv/kernel.py.
//
// What bounds it on this card.  A packed multiply reads one word of n_p
// sequence levels (4 * n_p bytes, reused for all ceil(K / k_p) filter
// chunks) and does one IMAD, two when overpacked: a few integer ops per 4
// bytes, below the card's balance of about 5 int32 ops per HBM byte, so
// the bound is bytes.  At the UltraNet row shapes a launch moves under 1 MB
// (a fraction of a microsecond at 3.35 TB/s), so launch overhead dominates.
//
// What the design does about it.  One block takes one batch row b and 128
// consecutive sequence chunks v, one thread each.  A thread packs its n_p
// levels of each channel in registers, multiplies them by every filter
// chunk u of that channel (the filter words are block-wide broadcasts),
// peels after each channel chunk of at most acc_chunk, and adds the
// decoded coefficients at offset v * n_p + u * k_p of a row window in
// shared memory.  Neighbouring threads' (and blocks') windows overlap, so
// the adds are integer atomics, which are exact and order-free: shared
// atomics inside the block, then one global atomicAdd per window entry
// into the zeroed output row.
#include <cuda_runtime.h>

#include <cstdint>

#include "peel.cuh"

namespace {

constexpr int THREADS = 128;  // sequence chunks per block, one per thread

template <int NSEG, bool OVERLAP>
__global__ void __launch_bounds__(THREADS)
filter_conv_kernel(const int32_t* __restrict__ s, const int32_t* __restrict__ fp,
                   int32_t* __restrict__ out, int C, int n_pad, int n_fc, int k_p, int n_p,
                   int stride, int acc_chunk, int n_out, int win) {
  extern __shared__ int32_t row_s[];  // the block's output window, win entries
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * THREADS;
  const int v = v0 + tid;
  const int n_sc = n_pad / n_p;
  for (int i = tid; i < win; i += THREADS) row_s[i] = 0;
  __syncthreads();

  if (v < n_sc) {
    const uint32_t s_mask = lsb_mask_n(n_p, stride);
    const uint32_t f_mask = lsb_mask_n(k_p, stride);
    const int32_t* srow = s + static_cast<size_t>(b) * C * n_pad + static_cast<size_t>(v) * n_p;
    for (int u = 0; u < n_fc; ++u) {
      int32_t dec[NSEG];
#pragma unroll
      for (int m = 0; m < NSEG; ++m) dec[m] = 0;
      for (int c0 = 0; c0 < C; c0 += acc_chunk) {
        const int c1 = min(C, c0 + acc_chunk);
        uint32_t part = 0u, par = 0u;
        for (int c = c0; c < c1; ++c) {
          const int32_t* sc = srow + static_cast<size_t>(c) * n_pad;
          uint32_t sp = 0u;
          for (int j = 0; j < n_p; ++j) sp += static_cast<uint32_t>(__ldg(sc + j)) << (j * stride);
          const uint32_t f = static_cast<uint32_t>(__ldg(fp + static_cast<size_t>(c) * n_fc + u));
          part += sp * f;
          if (OVERLAP) par += (sp & s_mask) * (f & f_mask);
        }
        peel_chunk<NSEG, OVERLAP>(part, par, stride, dec);
      }
      const int base = tid * n_p + u * k_p;
#pragma unroll
      for (int m = 0; m < NSEG; ++m) atomicAdd(&row_s[base + m], dec[m]);
    }
  }
  __syncthreads();
  int32_t* orow = out + static_cast<size_t>(b) * n_out;
  for (int i = tid; i < win; i += THREADS) {
    const int t = v0 * n_p + i;
    if (t < n_out) atomicAdd(orow + t, row_s[i]);
  }
}

template <int NSEG, bool OVERLAP>
cudaError_t launch(const int32_t* s, const int32_t* fp, int32_t* out, int B, int C, int n_pad,
                   int n_fc, int k_p, int n_p, int stride, int acc_chunk, int n_out,
                   cudaStream_t st) {
  const int n_sc = n_pad / n_p;
  const int win = THREADS * n_p + (n_fc - 1) * k_p + NSEG;
  const dim3 grid((n_sc + THREADS - 1) / THREADS, B);
  filter_conv_kernel<NSEG, OVERLAP><<<grid, THREADS, sizeof(int32_t) * win, st>>>(
      s, fp, out, C, n_pad, n_fc, k_p, n_p, stride, acc_chunk, n_out, win);
  return cudaGetLastError();
}

}  // namespace

// K6: s i32 [B, C, n_pad] (n_pad a multiple of n_p), fp i32 [C, n_fc] packed
// filter chunks -> out i32 [B, n_out], the full convolution summed over C
extern "C" int filter_conv(const void* s, const void* fp, void* out, int B, int C, int n_pad,
                           int n_fc, int k_p, int n_p, int stride, int acc_chunk, int overlap,
                           int n_out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n_out <= 0) return 0;
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(B) * n_out, st);
  if (e != cudaSuccess || C <= 0 || n_pad <= 0) return static_cast<int>(e);
  const int nseg = k_p + n_p - 1;
  // the top segment is narrower than a stride: segment offsets, not
  // nseg * stride, must stay inside the 32-bit word
  if (k_p < 1 || n_p < 1 || n_pad % n_p || acc_chunk < 1 || stride < 1 ||
      (nseg - 1) * stride >= 32 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* sv = static_cast<const int32_t*>(s);
  const auto* fv = static_cast<const int32_t*>(fp);
  auto* o = static_cast<int32_t*>(out);
#define FC_LAUNCH(NS, OV) launch<NS, OV>(sv, fv, o, B, C, n_pad, n_fc, k_p, n_p, stride, acc_chunk, n_out, st)
  switch (nseg * 2 + (overlap ? 1 : 0)) {
    case 4: e = FC_LAUNCH(2, false); break;
    case 5: e = FC_LAUNCH(2, true); break;
    case 6: e = FC_LAUNCH(3, false); break;
    case 7: e = FC_LAUNCH(3, true); break;
    case 8: e = FC_LAUNCH(4, false); break;
    case 9: e = FC_LAUNCH(4, true); break;
    default: e = cudaErrorInvalidValue;
  }
#undef FC_LAUNCH
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
