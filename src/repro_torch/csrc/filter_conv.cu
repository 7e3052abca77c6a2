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
// of the two words' LSB planes (peel.cuh).  Plain version and the tile plan:
// repro_torch/kernels/filter_conv/kernel.py.
//
// What bounds it on this card.  A packed multiply reads one word of n_p
// sequence levels (4 * n_p bytes, reused for all ceil(K / k_p) filter
// chunks) and does one IMAD, two when overpacked: a few integer ops per 4
// bytes, below the card's balance of about 5 int32 ops per HBM byte, so
// the bound is bytes.  At the UltraNet row shapes a launch moves under 1 MB
// (a fraction of a microsecond at 3.35 TB/s): the time is latency, the
// launch and the longest chain of dependent work in any thread.
//
// What the design does about it.
// - Output tiles.  Block (x, b) owns output positions [t0, t0 + T) of row b,
//   t0 = x * T, and computes every packed product (v, u) whose window
//   v * n_p + u * k_p + [0, nseg) touches them: sequence chunks v_lo .. v_hi,
//   the tile widened by the halo (n_fc - 1) * k_p + nseg - 1 (neighbouring
//   tiles recompute the halo's products).  Its decoded coefficients are
//   added into a tile in shared memory (integer atomics on chip, exact in any
//   order) and each output entry is written once, with a plain store; a
//   position no product reaches is written as 0.  No memset, no global
//   atomics: a call is one kernel node.
// - Channels in parallel.  A block's work items are (channel slice, u, v),
//   v fastest across lanes.  A slice is cs channels, a multiple of acc_chunk
//   (or all C), so each item peels its own chunks exactly as the serial sum
//   would and slices' decoded coefficients add exactly.  The tile plan
//   (kernel.py tile_plan) picks T and cs from the shape: small tiles and
//   many slices when B and N are small and C large (B = 10, C = 64, N = 20:
//   110 blocks of 2 outputs and 36-128 items), one slice when C <= acc_chunk.
// - Staging.  The block packs the sequence words it needs, [channel piece of
//   cp channels][v_lo .. v_hi], into shared memory once, from coalesced loads
//   (one 8-byte load per word when n_p = 2), and the packed filter chunks
//   beside them; every item then reads both from shared memory.
//
// Measured (chip_smoke.py phase 7 and perf/ab_int8_filter.py, H100 SXM at
// 700 W, PERF.md section 6): 2.9-4.9 us a launch by graph at UltraNet's 16
// row convolutions, whatever C, 0.057 ms summed (float32 conv1d 0.093 ms);
// the launch itself is most of it.
#include <cuda_runtime.h>

#include <cstdint>

#include "peel.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_SMEM = 48 * 1024;  // dynamic shared memory without an opt-in

template <int NSEG, bool OVERLAP, bool V2>
__global__ void __launch_bounds__(THREADS)
filter_tile_kernel(const int32_t* __restrict__ s, const int32_t* __restrict__ fp,
                   int32_t* __restrict__ out, int C, int n_pad, int n_fc, int k_p, int n_p,
                   int stride, int acc_chunk, int n_out, int T, int cs, int cp, int nv_max) {
  extern __shared__ int32_t smem[];
  int32_t* tile = smem;                                                 // [T]
  uint32_t* sp_s = reinterpret_cast<uint32_t*>(smem + T);              // [cp][nv] packed sequence words
  uint32_t* f_s = sp_s + static_cast<size_t>(cp) * nv_max;             // [cp][n_fc] packed filter chunks
  const int tid = threadIdx.x;
  const int b = blockIdx.y, t0 = blockIdx.x * T;
  const int n_sc = n_pad / n_p;
  // sequence chunks whose window [v n_p, v n_p + halo] meets [t0, t0 + T)
  const int halo = (n_fc - 1) * k_p + NSEG - 1;
  const int v_lo = t0 - halo <= 0 ? 0 : (t0 - halo + n_p - 1) / n_p;
  const int v_hi = min(n_sc - 1, (t0 + T - 1) / n_p);
  const int nv = v_hi - v_lo + 1;
  const uint32_t s_mask = lsb_mask_n(n_p, stride);
  const uint32_t f_mask = lsb_mask_n(k_p, stride);
  for (int i = tid; i < T; i += THREADS) tile[i] = 0;

  for (int c_base = 0; nv > 0 && c_base < C; c_base += cp) {
    const int cn = min(cp, C - c_base);
    __syncthreads();  // the previous piece is consumed (and the tile zeroed)
    const int32_t* srow = s + (static_cast<size_t>(b) * C + c_base) * n_pad + static_cast<size_t>(v_lo) * n_p;
    // four words a thread at a time: their loads are issued together
    for (int i0 = 0; i0 < cn * nv; i0 += 4 * THREADS) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * THREADS + tid, c = i / nv, v = i - c * nv;
        const int32_t* src = srow + static_cast<size_t>(c) * n_pad + static_cast<size_t>(v) * n_p;
        uint32_t x = 0u;
        if (i < cn * nv) {
          if (V2) {
            const int2 y = __ldg(reinterpret_cast<const int2*>(src));
            x = static_cast<uint32_t>(y.x) + (static_cast<uint32_t>(y.y) << stride);
          } else {
            for (int q = 0; q < n_p; ++q) x += static_cast<uint32_t>(__ldg(src + q)) << (q * stride);
          }
        }
        w[j] = x;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j * THREADS + tid;
        if (i < cn * nv) sp_s[i] = w[j];
      }
    }
    for (int i = tid; i < cn * n_fc; i += THREADS) {
      f_s[i] = static_cast<uint32_t>(__ldg(fp + static_cast<size_t>(c_base) * n_fc + i));
    }
    __syncthreads();

    const int n_sl = (cn + cs - 1) / cs;
    for (int item = tid; item < n_sl * n_fc * nv; item += THREADS) {
      const int v = item % nv, r = item / nv;
      const int u = r % n_fc, c_lo = (r / n_fc) * cs;
      const int c_hi = min(cn, c_lo + cs);
      int32_t dec[NSEG];
#pragma unroll
      for (int m = 0; m < NSEG; ++m) dec[m] = 0;
      for (int cc = c_lo; cc < c_hi; cc += acc_chunk) {
        const int ce = min(c_hi, cc + acc_chunk);
        uint32_t part = 0u, par = 0u;
        for (int c = cc; c < ce; ++c) {
          const uint32_t sp = sp_s[c * nv + v], f = f_s[c * n_fc + u];
          part += sp * f;
          if (OVERLAP) par += (sp & s_mask) * (f & f_mask);
        }
        peel_chunk<NSEG, OVERLAP>(part, par, stride, dec);
      }
      const int base = (v_lo + v) * n_p + u * k_p - t0;
#pragma unroll
      for (int m = 0; m < NSEG; ++m) {
        if (base + m >= 0 && base + m < T) atomicAdd(&tile[base + m], dec[m]);
      }
    }
  }
  __syncthreads();
  int32_t* orow = out + static_cast<size_t>(b) * n_out + t0;
  for (int i = tid; i < T && t0 + i < n_out; i += THREADS) orow[i] = tile[i];
}

template <int NSEG, bool OVERLAP>
cudaError_t launch(const int32_t* s, const int32_t* fp, int32_t* out, int B, int C, int n_pad,
                   int n_fc, int k_p, int n_p, int stride, int acc_chunk, int n_out, int T, int cs,
                   int cp, int nv_max, cudaStream_t st) {
  const size_t smem = sizeof(int32_t) * (T + static_cast<size_t>(cp) * (nv_max + n_fc));
  const dim3 grid((n_out + T - 1) / T, B);
  if (n_p == 2 && reinterpret_cast<uintptr_t>(s) % 8 == 0) {
    filter_tile_kernel<NSEG, OVERLAP, true><<<grid, THREADS, smem, st>>>(
        s, fp, out, C, n_pad, n_fc, k_p, n_p, stride, acc_chunk, n_out, T, cs, cp, nv_max);
  } else {
    filter_tile_kernel<NSEG, OVERLAP, false><<<grid, THREADS, smem, st>>>(
        s, fp, out, C, n_pad, n_fc, k_p, n_p, stride, acc_chunk, n_out, T, cs, cp, nv_max);
  }
  return cudaGetLastError();
}

}  // namespace

// K6: s i32 [B, C, n_pad] (n_pad a multiple of n_p), fp i32 [C, n_fc] packed
// filter chunks -> out i32 [B, n_out], the full convolution summed over C.
// T, cs, cp, nv_max: the tile plan (kernel.py tile_plan): output positions
// per block, channels per slice, channels staged at a time, and the most
// sequence chunks one tile's window can hold.
extern "C" int filter_conv(const void* s, const void* fp, void* out, int B, int C, int n_pad,
                           int n_fc, int k_p, int n_p, int stride, int acc_chunk, int overlap,
                           int n_out, int T, int cs, int cp, int nv_max, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n_out <= 0) return 0;
  const int nseg = k_p + n_p - 1;
  // the top segment is narrower than a stride: segment offsets, not
  // nseg * stride, must stay inside the 32-bit word
  if (C < 0 || n_pad < 0 || k_p < 1 || n_p < 1 || n_fc < 1 || n_pad % n_p || acc_chunk < 1 ||
      stride < 1 || (nseg - 1) * stride >= 32 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the plan: tiles, slices and pieces that fit, and windows nv_max covers
  if (T < 1 || cs < 1 || cp < 1 || nv_max < (T - 1 + (n_fc - 1) * k_p + nseg - 1) / n_p + 1 ||
      sizeof(int32_t) * (T + static_cast<long long>(cp) * (nv_max + n_fc)) > MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* sv = static_cast<const int32_t*>(s);
  const auto* fv = static_cast<const int32_t*>(fp);
  auto* o = static_cast<int32_t*>(out);
#define FC_LAUNCH(NS, OV) \
  launch<NS, OV>(sv, fv, o, B, C, n_pad, n_fc, k_p, n_p, stride, acc_chunk, n_out, T, cs, cp, nv_max, st)
  cudaError_t e;
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
