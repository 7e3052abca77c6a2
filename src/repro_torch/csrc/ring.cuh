// Weight-tile ring and split-K arrival shared by the streaming matmuls (K1 and
// K2 in packed_matmul.cu, K4 and K5 in quant_matmul.cu).
//
// Ring: a block fills shared-memory stages with cp.async (16-byte copies
// where the source rows allow it, else 4-byte copies), one commit group per
// stage, so that `cp_wait<STAGES - 2>` means "the oldest stage has landed".
//
// Split K: a block whose (row, column) tile is split over K writes its
// partial sums to a workspace slab and calls `last_to_arrive` on its tile's
// arrival counter; the last block to arrive sums every split's slab, writes
// the outputs and puts the counter back to 0 (kernel.py `_split_scratch`
// zeroes the counters once per device and gives each stream its own slot of
// them), so a CUDA graph may replay the launch.  Integer sums are exact in
// any order.
#pragma once

#include <cstdint>

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Called by every thread of a block once its partial slab is written: true in
// the last of `splits` blocks to arrive at `counter`, whose reads of the other
// slabs (with __ldcg) then see them.  `flag` is a shared int.
__device__ __forceinline__ bool last_to_arrive(int32_t* counter, int splits, int* flag) {
  __threadfence();  // the partials are visible device-wide before the arrival
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}
