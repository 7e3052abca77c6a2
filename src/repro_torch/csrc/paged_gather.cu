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
// What the design does about it.  The block table is read at the top of
// each block (the TPU's scalar prefetch becomes one load), exactly the
// table's pages are streamed with 16-byte vector loads and stores,
// neighbouring threads on neighbouring addresses, and null pages are never
// read: zeros are written instead.
//
// float pools (gather_fp): one block per (slot, block) pair copies its page.
//
// int8 pools (gather_i8): each level widens to float, is multiplied by its
// row's scale and rounded once to the output type: bf16(level) * bf16(scale)
// rounded once to bf16 (the product of two bf16 values is exact in
// float32), which is the reference's op order at a bf16 output.  The stores
// bound it: a thread that turns 16 levels into 32 bytes of bf16 writes them
// as two 16-byte stores, each warp store then covering every other 16 bytes
// of a 1 KB span, which took 1.3-2.1x the time of one 16-byte store a unit
// (perf/k3_variants.py, vec16 against base).  So a thread's unit is one
// 16-byte store (8 levels at bf16, 4 at float32) and a warp store writes
// 512 contiguous bytes.  A page is cut into row groups, one block each
// (gather_plan: 256 threads, 4 units a thread), so the live pages spread
// over every SM, and a thread issues all of its level and scale loads
// before its first conversion.  A bulk copy of the group's levels into shared memory
// (cp.async.bulk) was no faster, so the loads go straight to registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;      // gather_fp's block
constexpr int MAX_THREADS = 512;  // gather_i8's largest block (gather_plan)
constexpr int VPT = 4;            // gather_i8's units a thread (gather_plan's I8_VPT)

// the mask lanes [s, c, b, r0 .. r0 + R) for every lane c of the chunk
__device__ __forceinline__ void write_mask(bool* __restrict__ mask, int pos0, int window, int s,
                                           int b, int NB, int PS, int C, int r0, int R) {
  for (int i = threadIdx.x; i < C * R; i += blockDim.x) {
    const int c = i / R;
    const int lane = r0 + (i - c * R);
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
  write_mask(mask, pos[s], window, s, b, NB, PS, C, 0, PS);
}

// int8 pools.  The launch plan (kernels/paged_gather/kernel.py gather_plan)
// splits each page into row groups: block (x, y) owns page slot
// x = s * NB + b and its rows [y * R, y * R + R), both pools, and writes the
// mask lanes of those rows.  The unit of work is one 16-byte store of a
// view: L = 8 levels at bf16, 4 at float32, read with one 8- or 4-byte load.
// A group's R * D / L units are dealt round-robin to its threads, VPT each
// (thread t takes units t, t + T, ..., t + (VPT - 1) T), so each warp store
// writes 512 contiguous bytes.  A live group issues every level and scale
// load of a thread before its first conversion; a null group writes zeros
// and loads nothing.
__host__ __device__ constexpr int unit_levels(bool bf16) { return bf16 ? 8 : 4; }

template <int L> struct Unit;  // L int8 levels, loaded at once
template <> struct Unit<4> { using T = uint32_t; };
template <> struct Unit<8> { using T = uint2; };

__device__ __forceinline__ uint32_t word(uint32_t q, int) { return q; }
__device__ __forceinline__ uint32_t word(const uint2& q, int i) { return i == 0 ? q.x : q.y; }

// level e of a unit, widened to float
template <class T>
__device__ __forceinline__ float level(const T& q, int e) {
  return static_cast<float>(static_cast<int8_t>((word(q, e >> 2) >> (8 * (e & 3))) & 0xffu));
}

// L levels times their row's scale, stored as L outputs (16-byte vectors)
template <bool BF16, int L, class T>
__device__ __forceinline__ void dequant_store(const T& q, float scale, uint4* dst) {
  if (BF16) {
    // |level| <= 127 is exact in bf16, and the product of two bf16 values is
    // exact in float32, so one rounding to bf16 gives the reference's
    // bf16(level) * bf16(scale)
    const float sf = __bfloat162float(__float2bfloat16_rn(scale));
    __align__(16) __nv_bfloat162 o[L / 2];
#pragma unroll
    for (int e = 0; e < L / 2; ++e) {
      o[e] = __floats2bfloat162_rn(__fmul_rn(level(q, 2 * e), sf), __fmul_rn(level(q, 2 * e + 1), sf));
    }
#pragma unroll
    for (int v = 0; v < L / 8; ++v) dst[v] = reinterpret_cast<const uint4*>(o)[v];
  } else {
    __align__(16) float o[L];
#pragma unroll
    for (int e = 0; e < L; ++e) o[e] = __fmul_rn(level(q, e), scale);
#pragma unroll
    for (int v = 0; v < L / 4; ++v) dst[v] = reinterpret_cast<const uint4*>(o)[v];
  }
}

template <bool BF16>
__global__ void __launch_bounds__(MAX_THREADS)
gather_i8(const int32_t* __restrict__ table, const int32_t* __restrict__ pos, int window,
          const int8_t* __restrict__ pool_k, const int8_t* __restrict__ pool_v,
          const float* __restrict__ k_scale, const float* __restrict__ v_scale,
          void* __restrict__ k_out, void* __restrict__ v_out, bool* __restrict__ mask, int NB,
          int PS, int D, int C, int R) {
  constexpr int L = unit_levels(BF16);
  constexpr int STORES = L * (BF16 ? 2 : 4) / 16;  // 16-byte stores a unit
  using T = typename Unit<L>::T;
  const int x = blockIdx.x;
  const int s = x / NB;
  const int b = x - s * NB;
  const int r0 = blockIdx.y * R;
  const int upr = D / L;  // units a row
  const int n = R * upr;  // units of this group, each pool
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int page = __ldg(table + x);
  // 64-bit bases: page * PS * D and S * NB * PS * D can pass 2^31
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
    const T* sk = reinterpret_cast<const T*>(pool_k) + src_row * upr;
    const T* sv = reinterpret_cast<const T*>(pool_v) + src_row * upr;
    T lk[VPT], lv[VPT];
    float ks[VPT], vs[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = t + k * nt;
      if (j < n) {
        const int row = j / upr;
        lk[k] = __ldg(sk + j);
        lv[k] = __ldg(sv + j);
        ks[k] = __ldg(k_scale + src_row + row);
        vs[k] = __ldg(v_scale + src_row + row);
      }
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = t + k * nt;
      if (j < n) {
        dequant_store<BF16, L>(lk[k], ks[k], dk + j * STORES);
        dequant_store<BF16, L>(lv[k], vs[k], dv + j * STORES);
      }
    }
  }
  write_mask(mask, pos[s], window, s, b, NB, PS, C, r0, R);
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
// out_bf16 selects bf16 views, else float32; rows and threads are
// gather_plan's (R rows a block, T threads a block, VPT units a thread)
extern "C" int paged_gather_i8(const void* table, const void* pos, int window, const void* pool_k,
                               const void* pool_v, const void* k_scale, const void* v_scale,
                               void* k_out, void* v_out, void* mask, int S, int NB, int PS, int D,
                               int C, int out_bf16, int rows, int threads, void* stream) {
  if (S <= 0 || NB <= 0) return 0;
  if (D % 16 != 0 || PS <= 0 || C <= 0 || rows <= 0 || PS % rows != 0 || threads <= 0 ||
      threads % 32 != 0 || threads > MAX_THREADS ||
      static_cast<long long>(threads) * VPT * unit_levels(out_bf16) < static_cast<long long>(rows) * D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(S * NB, PS / rows);
  auto* t = static_cast<const int32_t*>(table);
  auto* p = static_cast<const int32_t*>(pos);
  auto* pk = static_cast<const int8_t*>(pool_k);
  auto* pv = static_cast<const int8_t*>(pool_v);
  auto* ks = static_cast<const float*>(k_scale);
  auto* vs = static_cast<const float*>(v_scale);
  auto* m = static_cast<bool*>(mask);
  auto st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    gather_i8<true><<<grid, threads, 0, st>>>(t, p, window, pk, pv, ks, vs, k_out, v_out, m, NB, PS, D,
                                              C, rows);
  } else {
    gather_i8<false><<<grid, threads, 0, st>>>(t, p, window, pk, pv, ks, vs, k_out, v_out, m, NB, PS, D,
                                               C, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
