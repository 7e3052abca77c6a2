// Paged-KV gather for Hopper (sm_90a), kernel K3.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_gather/kernel.py:121
// paged_gather_raw (body _gather_body :56, call built by _gather_fn :90):
// gather each slot's pages through its block-table row into
// [S, n_blocks, page_size, D] K and V views, write zeros for the null page
// 0, dequantize int8 pages as level * scale per page row, and emit the
// causal / sliding-window lane mask [S, C, n_blocks, page_size].
// Plain version: repro_torch/kernels/paged_gather/kernel.py.
//
// What bounds it on this card: bytes.  It does no arithmetic beyond the
// dequantizing multiply; it reads each live page once and writes each view
// element once, so its least time is (live page bytes + view bytes + mask
// bytes) over HBM bandwidth.
//
// What the design does about it.  One block per (slot, block) pair reads
// its own block-table entry (the TPU's scalar prefetch becomes a load at the
// top of the block) and streams exactly that page with 16-byte vector loads
// and stores, neighbouring threads on neighbouring addresses.  Null pages
// are never read: the block writes zeros instead.  int8 pages widen 16
// levels per load and multiply by the row's scale in registers, with one
// rounding to the output type: bf16(level) * bf16(scale) rounded once to
// bf16 (the product of two bf16 values is exact in float32), which is the
// reference's op order at a bf16 output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void write_mask(bool* __restrict__ mask, int pos0, int window, int s,
                                           int b, int NB, int PS, int C) {
  for (int i = threadIdx.x; i < C * PS; i += blockDim.x) {
    const int c = i / PS;
    const int lane = i - c * PS;
    const int kpos = b * PS + lane;
    const int posc = pos0 + c;
    bool m = kpos <= posc;
    if (window > 0) m = m && (posc - kpos < window);
    mask[((static_cast<size_t>(s) * C + c) * NB + b) * PS + lane] = m;
  }
}

// float pools gathered to their own dtype: a byte copy of 16-byte vectors
__global__ void __launch_bounds__(THREADS)
gather_fp(const int32_t* __restrict__ table, const int32_t* __restrict__ pos, int window,
          const uint4* __restrict__ pool_k, const uint4* __restrict__ pool_v,
          uint4* __restrict__ k_out, uint4* __restrict__ v_out, bool* __restrict__ mask, int NB,
          int PS, int row_vecs, int C) {
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int page = table[static_cast<size_t>(s) * NB + b];
  const size_t page_vecs = static_cast<size_t>(PS) * row_vecs;
  uint4* dk = k_out + (static_cast<size_t>(s) * NB + b) * page_vecs;
  uint4* dv = v_out + (static_cast<size_t>(s) * NB + b) * page_vecs;
  if (page != 0) {
    const uint4* sk = pool_k + static_cast<size_t>(page) * page_vecs;
    const uint4* sv = pool_v + static_cast<size_t>(page) * page_vecs;
    for (size_t i = threadIdx.x; i < page_vecs; i += blockDim.x) {
      dk[i] = __ldg(sk + i);
      dv[i] = __ldg(sv + i);
    }
  } else {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (size_t i = threadIdx.x; i < page_vecs; i += blockDim.x) {
      dk[i] = zero;
      dv[i] = zero;
    }
  }
  write_mask(mask, pos[s], window, s, b, NB, PS, C);
}

// 16 int8 levels of one page row -> 16 outputs (zeros for the null page)
template <bool BF16>
__device__ __forceinline__ void dequant16(const int8_t* __restrict__ src, float scale, bool live,
                                          void* dst) {
  int8_t lv[16];
  if (live) {
    *reinterpret_cast<uint4*>(lv) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
    *reinterpret_cast<uint4*>(lv) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (BF16) {
    __align__(16) __nv_bfloat16 o[16];
    const float sf = __bfloat162float(__float2bfloat16_rn(scale));
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      // |level| <= 127 is exact in bf16; the bf16 x bf16 product is exact in
      // float32, so one rounding to bf16 follows
      const float l = __bfloat162float(__float2bfloat16_rn(static_cast<float>(lv[e])));
      o[e] = live ? __float2bfloat16_rn(__fmul_rn(l, sf)) : __float2bfloat16_rn(0.f);
    }
    uint4* d = static_cast<uint4*>(dst);
    d[0] = reinterpret_cast<const uint4*>(o)[0];
    d[1] = reinterpret_cast<const uint4*>(o)[1];
  } else {
    __align__(16) float o[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) o[e] = live ? __fmul_rn(static_cast<float>(lv[e]), scale) : 0.f;
    uint4* d = static_cast<uint4*>(dst);
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = reinterpret_cast<const uint4*>(o)[q];
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
gather_i8(const int32_t* __restrict__ table, const int32_t* __restrict__ pos, int window,
          const int8_t* __restrict__ pool_k, const int8_t* __restrict__ pool_v,
          const float* __restrict__ k_scale, const float* __restrict__ v_scale,
          void* __restrict__ k_out, void* __restrict__ v_out, bool* __restrict__ mask, int NB,
          int PS, int D, int C) {
  using Out = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int page = table[static_cast<size_t>(s) * NB + b];
  const bool live = page != 0;
  const size_t page_elems = static_cast<size_t>(PS) * D;
  const size_t src0 = static_cast<size_t>(page) * page_elems;
  const size_t dst0 = (static_cast<size_t>(s) * NB + b) * page_elems;
  const int vecs = static_cast<int>(page_elems / 16);
  for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
    const size_t e0 = static_cast<size_t>(i) * 16;
    const int row = static_cast<int>(e0 / D);
    const size_t srow = static_cast<size_t>(page) * PS + row;
    const float ks = live ? k_scale[srow] : 0.f;
    const float vs = live ? v_scale[srow] : 0.f;
    dequant16<BF16>(pool_k + src0 + e0, ks, live, static_cast<Out*>(k_out) + dst0 + e0);
    dequant16<BF16>(pool_v + src0 + e0, vs, live, static_cast<Out*>(v_out) + dst0 + e0);
  }
  write_mask(mask, pos[s], window, s, b, NB, PS, C);
}

}  // namespace

// float pools: pool [P, PS, D] of any 2- or 4-byte dtype, row_bytes = D * size
extern "C" int paged_gather_fp(const void* table, const void* pos, int window, const void* pool_k,
                               const void* pool_v, void* k_out, void* v_out, void* mask, int S,
                               int NB, int PS, int row_bytes, int C, void* stream) {
  if (S <= 0 || NB <= 0) return 0;
  if (row_bytes % 16 != 0 || PS <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(S, NB);
  gather_fp<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(pos), window,
      static_cast<const uint4*>(pool_k), static_cast<const uint4*>(pool_v),
      static_cast<uint4*>(k_out), static_cast<uint4*>(v_out), static_cast<bool*>(mask), NB, PS,
      row_bytes / 16, C);
  return static_cast<int>(cudaGetLastError());
}

// int8 pools: levels [P, PS, D] int8 (D % 16 == 0), scales [P, PS, 1] f32;
// out_bf16 selects bf16 views, else float32
extern "C" int paged_gather_i8(const void* table, const void* pos, int window, const void* pool_k,
                               const void* pool_v, const void* k_scale, const void* v_scale,
                               void* k_out, void* v_out, void* mask, int S, int NB, int PS, int D,
                               int C, int out_bf16, void* stream) {
  if (S <= 0 || NB <= 0) return 0;
  if (D % 16 != 0 || PS <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(S, NB);
  auto* t = static_cast<const int32_t*>(table);
  auto* p = static_cast<const int32_t*>(pos);
  auto* pk = static_cast<const int8_t*>(pool_k);
  auto* pv = static_cast<const int8_t*>(pool_v);
  auto* ks = static_cast<const float*>(k_scale);
  auto* vs = static_cast<const float*>(v_scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    gather_i8<true><<<grid, THREADS, 0, st>>>(t, p, window, pk, pv, ks, vs, k_out, v_out,
                                              static_cast<bool*>(mask), NB, PS, D, C);
  } else {
    gather_i8<false><<<grid, THREADS, 0, st>>>(t, p, window, pk, pv, ks, vs, k_out, v_out,
                                               static_cast<bool*>(mask), NB, PS, D, C);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
