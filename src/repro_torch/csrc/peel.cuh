// Segment peel shared by the packed matmul kernels (K1 and K2 in
// packed_matmul.cu).  Device twin of repro_torch/kernels/peel.py, which is
// the plain version both kernels are held against.
//
// `part` is one accumulation chunk's packed partial sum: NSEG segments of
// `stride` bits.  With OVERLAP (1-bit overpacking, DeepBurning-MixQ Fig. 3)
// each segment may need stride + 1 bits; the stolen MSB is recovered from
// `parity`, the chunk's dot of activation LSBs against the packed words'
// LSB planes, whose stride-aligned counters carry every segment's true LSB
// in bit 0.  Segments then peel bottom-up and the top segment keeps all
// remaining bits.  Without OVERLAP every segment is an independent masked
// slice.
//
// All shifts and subtractions run on uint32_t: the same bits as the
// reference's shift_right_logical, with defined wraparound.
#pragma once

#include <cstdint>

template <int NSEG>
__device__ __forceinline__ uint32_t lsb_mask(int stride) {
  uint32_t m = 0;
#pragma unroll
  for (int d = 0; d < NSEG; ++d) m |= 1u << (d * stride);
  return m;
}

template <int NSEG, bool OVERLAP>
__device__ __forceinline__ void peel_chunk(uint32_t part, uint32_t parity, int stride,
                                           int32_t (&acc)[NSEG]) {
  const uint32_t mask = (1u << stride) - 1u;
  if (OVERLAP) {
    uint32_t p = part;
#pragma unroll
    for (int d = 0; d < NSEG - 1; ++d) {
      const uint32_t low = p & mask;
      const uint32_t bit_p = (p >> stride) & 1u;
      const uint32_t lsb_next = (parity >> ((d + 1) * stride)) & 1u;
      const uint32_t val = low + ((bit_p ^ lsb_next) << stride);
      acc[d] += static_cast<int32_t>(val);
      p = (p - val) >> stride;
    }
    acc[NSEG - 1] += static_cast<int32_t>(p);
  } else {
#pragma unroll
    for (int d = 0; d < NSEG; ++d) {
      acc[d] += static_cast<int32_t>((part >> (d * stride)) & mask);
    }
  }
}
