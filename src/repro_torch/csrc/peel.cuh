// Segment peel shared by the packed kernels (K1 and K2 in packed_matmul.cu,
// K5 in quant_matmul.cu, K6 in filter_conv.cu).  Device twin of
// repro_torch/kernels/peel.py, which the kernels' plain versions use.
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
//
// K1 and K2 build `parity` by XOR (par ^= w & lsb_mask & -(a & 1)) instead of
// the additive dot: the peel reads only bit (d+1)*stride, and each counter
// below it holds at most acc_chunk < 2^stride ones a chunk, so no carry
// reaches that bit and both words agree wherever the peel reads.
#pragma once

#include <cstdint>

template <int NSEG>
__device__ __forceinline__ uint32_t lsb_mask(int stride) {
  uint32_t m = 0;
#pragma unroll
  for (int d = 0; d < NSEG; ++d) m |= 1u << (d * stride);
  return m;
}

// the same mask for a segment count known only at run time (Filter Packing
// masks its sequence word at n_p segments and its filter word at k_p)
__device__ __forceinline__ uint32_t lsb_mask_n(int n_seg, int stride) {
  uint32_t m = 0;
  for (int d = 0; d < n_seg; ++d) m |= 1u << (d * stride);
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

// Two segments decoded as a sum (K5).  Returns peel_chunk<2, OVERLAP>'s
// acc[0] for one chunk: segment 0 of the packed sum `part`.  Overpacked,
// `par_hi` is the chunk's parity dot on segment 1's LSB plane alone,
// dot(a & 1, wp & (1 << stride)): zero below bit `stride`, and its bit
// `stride` is the bit peel_chunk reads from `parity`, since the additive
// dot's segment-0 counter holds at most acc_chunk < 2^stride ones.  Then
// segment 0 is the low stride bits of `part` with bit `stride` XORed by that
// parity, one LOP3.  peel_chunk's acc[1] summed over chunks needs no
// per-chunk work: every chunk's part = seg0 + 2^stride seg1, so the sum of
// the top segments is (sum of parts - sum of segment 0) >> stride, taken once
// by the caller.
template <bool OVERLAP>
__device__ __forceinline__ int32_t peel_low2(int32_t part, int32_t par_hi, int stride) {
  const uint32_t p = static_cast<uint32_t>(part);
  if (OVERLAP) return static_cast<int32_t>((p ^ static_cast<uint32_t>(par_hi)) & ((2u << stride) - 1u));
  return static_cast<int32_t>(p & ((1u << stride) - 1u));
}
