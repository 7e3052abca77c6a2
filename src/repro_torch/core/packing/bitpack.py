"""Bit-exact packed-multiplication arithmetic (Python-int oracle; a copy
of ``repro.core.packing.bitpack``).

This module implements, with exact integer arithmetic, the three packing
mechanisms of DeepBurning-MixQ §IV:

  * Kernel Packing  (Eq. 1): N_d operands on port D, N_e on port E give
    N_d*N_e independent products in disjoint bit segments.
  * Filter Packing  (Eq. 2): 1-D convolution as polynomial multiplication;
    segment k of the product holds coefficient sum_{i+j=k} f[i]*s[j].
  * 1-bit Overpacking (§IV-B-1): segments may overlap by one bit; the
    stolen MSB of each segment is recovered by recomputing the next
    segment's LSB from operand LSBs (AND per product, XOR-reduced over a
    sum of products) and peeling segments from the bottom up.

Everything here uses unbounded Python ints so it is the *oracle* against
which the packed kernels (int32 lanes) and the vectorised decoders are
property-tested.  Operands are unsigned (the paper's Fig. 2
assumption; upstream quantizers are asymmetric/zero-point).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


def _check_fits(values: Sequence[int], bits: int, what: str) -> None:
    for v in values:
        if v < 0 or v >= (1 << bits):
            raise ValueError(f"{what} value {v} does not fit in {bits} unsigned bits")


def pack(values: Sequence[int], stride_bits: int) -> int:
    """Pack unsigned ints at ``stride_bits``-aligned segments (v[0] lowest)."""
    out = 0
    for i, v in enumerate(values):
        out |= int(v) << (i * stride_bits)
    return out


def lsb_of_segment_products(products_per_segment: Sequence[Sequence[tuple[int, int]]]) -> list[int]:
    """Recompute each segment's true LSB from operand LSBs.

    ``products_per_segment[k]`` is the list of (d, e) operand pairs whose
    products sum into segment k.  LSB(d*e) = LSB(d) AND LSB(e); the LSB of
    a sum of products is the XOR of the product LSBs (paper Fig. 3).
    """
    out = []
    for pairs in products_per_segment:
        bit = 0
        for d, e in pairs:
            bit ^= (d & 1) & (e & 1)
        out.append(bit)
    return out


def decode_segments(
    packed: int,
    stride_bits: int,
    num_segments: int,
    *,
    overlap: int = 0,
    true_lsbs: Sequence[int] | None = None,
) -> list[int]:
    """Extract ``num_segments`` unsigned segment values from ``packed``.

    With ``overlap == 0`` each segment value is < 2**stride_bits and this
    is a plain bit-slice.  With ``overlap == 1`` each segment value may
    need stride_bits+1 bits; its MSB collides with the next segment's LSB.
    ``true_lsbs[k]`` must then give the recomputed LSB of segment k
    (see :func:`lsb_of_segment_products`); segments are peeled bottom-up:

        bit_p          = (P >> stride) & 1              # msb_k XOR lsb_{k+1}
        msb_k          = bit_p XOR true_lsbs[k+1]
        c_k            = (P & (2**stride - 1)) + (msb_k << stride)
        P              = (P - c_k) >> stride
    """
    if overlap not in (0, 1):
        raise ValueError("only 1-bit overpacking is supported")
    mask = (1 << stride_bits) - 1
    out = []
    p = packed
    for k in range(num_segments):
        if k == num_segments - 1:
            val = p  # last segment keeps all remaining bits
        elif overlap == 0:
            val = p & mask
        else:
            if true_lsbs is None:
                raise ValueError("overpacked decode requires true_lsbs")
            low = p & mask
            bit_p = (p >> stride_bits) & 1
            msb = bit_p ^ (true_lsbs[k + 1] & 1)
            val = low + (msb << stride_bits)
        out.append(val)
        p = (p - val) >> stride_bits
    return out


# ---------------------------------------------------------------------------
# Kernel Packing (Eq. 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelPacked:
    """Placement constants for one Kernel-Packing invocation."""

    d_bits: int
    e_bits: int
    n_d: int
    n_e: int
    stride: int  # p_b
    overlap: int  # 0 or 1

    @property
    def num_segments(self) -> int:
        return self.n_d * self.n_e


def kernel_pack_multiply(cfg: KernelPacked, d_vals: Sequence[int], e_vals: Sequence[int]) -> int:
    """One packed multiply: returns the raw wide product."""
    _check_fits(d_vals, cfg.d_bits, "port-D")
    _check_fits(e_vals, cfg.e_bits, "port-E")
    if len(d_vals) != cfg.n_d or len(e_vals) != cfg.n_e:
        raise ValueError("operand count mismatch")
    d_packed = pack(d_vals, cfg.stride)
    e_packed = pack(e_vals, cfg.n_d * cfg.stride)
    return d_packed * e_packed


def kernel_pack_decode(cfg: KernelPacked, product: int, d_vals: Sequence[int], e_vals: Sequence[int]) -> np.ndarray:
    """Decode the N_d x N_e products from a packed multiply."""
    # segment k = i + j*N_d holds d[i]*e[j]  (a single product: AND for LSB)
    pairs = [[(d_vals[k % cfg.n_d], e_vals[k // cfg.n_d])] for k in range(cfg.num_segments)]
    lsbs = lsb_of_segment_products(pairs)
    segs = decode_segments(product, cfg.stride, cfg.num_segments, overlap=cfg.overlap, true_lsbs=lsbs)
    return np.array(segs, dtype=np.int64).reshape(cfg.n_e, cfg.n_d).T  # [n_d, n_e]


# ---------------------------------------------------------------------------
# Filter Packing (Eq. 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FilterPacked:
    """Placement constants for one Filter-Packing (polynomial) invocation."""

    w_bits: int
    a_bits: int
    k_p: int  # filter taps per invocation
    n_p: int  # sequence elements per invocation
    stride: int  # p_b
    overlap: int  # 0 or 1

    @property
    def num_segments(self) -> int:
        return self.k_p + self.n_p - 1

    @property
    def guard_bits(self) -> int:
        return self.stride - self.w_bits - self.a_bits

    @property
    def accum_headroom(self) -> int:
        """How many packed products can be summed before decode without the
        coefficient sums outgrowing stride+overlap bits.

        Each decoded segment must fit in stride (+1 if overpacked) bits.
        A single invocation's segment k already sums up to
        min(k_p, n_p) products of (w_bits + a_bits) bits.
        """
        need = self.w_bits + self.a_bits + _ceil_log2(min(self.k_p, self.n_p))
        have = self.stride + self.overlap
        return 1 << max(0, have - need)


def _ceil_log2(x: int) -> int:
    return int(np.ceil(np.log2(x))) if x > 1 else 0


def filter_pack_multiply(cfg: FilterPacked, f_vals: Sequence[int], s_vals: Sequence[int]) -> int:
    _check_fits(f_vals, cfg.w_bits, "filter")
    _check_fits(s_vals, cfg.a_bits, "sequence")
    if len(f_vals) != cfg.k_p or len(s_vals) != cfg.n_p:
        raise ValueError("operand count mismatch")
    return pack(f_vals, cfg.stride) * pack(s_vals, cfg.stride)


def filter_pack_decode(
    cfg: FilterPacked,
    product: int,
    f_chunks: Sequence[Sequence[int]],
    s_chunks: Sequence[Sequence[int]],
) -> list[int]:
    """Decode coefficients of (possibly accumulated) packed products.

    ``f_chunks[t]``/``s_chunks[t]`` are the operands of each accumulated
    invocation t (all invocations must share ``cfg``); ``product`` is the
    integer sum of their packed products.  Returns the k_p+n_p-1
    coefficient sums.
    """
    pairs: list[list[tuple[int, int]]] = [[] for _ in range(cfg.num_segments)]
    for f_vals, s_vals in zip(f_chunks, s_chunks):
        for i in range(cfg.k_p):
            for j in range(cfg.n_p):
                pairs[i + j].append((f_vals[i], s_vals[j]))
    lsbs = lsb_of_segment_products(pairs)
    return decode_segments(product, cfg.stride, cfg.num_segments, overlap=cfg.overlap, true_lsbs=lsbs)


def conv1d_via_filter_packing(
    cfg: FilterPacked,
    f: Sequence[int],
    s: Sequence[int],
    *,
    accumulate_channels: Sequence[tuple[Sequence[int], Sequence[int]]] | None = None,
) -> np.ndarray:
    """Full 1-D convolution via sub-task division (§IV-A-2).

    Splits ``f`` into ceil(K/k_p) chunks and ``s`` into ceil(N/n_p) chunks,
    runs one packed multiply per chunk pair, decodes, and accumulates the
    coefficients at offset u*k_p + v*n_p.  Returns the full convolution
    (length K+N-1), identical to ``np.convolve(f, s)``.

    ``accumulate_channels`` optionally provides additional (f, s) channel
    pairs accumulated *pre-decode* (the E_g guard-bit headroom use-case);
    all channels must fit ``cfg.accum_headroom``.
    """
    f = list(map(int, f))
    s = list(map(int, s))
    channels = [(f, s)] + [(list(map(int, cf)), list(map(int, cs))) for cf, cs in (accumulate_channels or [])]
    if len(channels) > cfg.accum_headroom:
        raise ValueError(f"{len(channels)} channels exceed accumulation headroom {cfg.accum_headroom}")
    K, N = len(f), len(s)
    out = np.zeros(K + N - 1, dtype=np.int64)
    n_fc = -(-K // cfg.k_p)
    n_sc = -(-N // cfg.n_p)
    for u in range(n_fc):
        for v in range(n_sc):
            total = 0
            f_chunks, s_chunks = [], []
            for cf, cs in channels:
                fc = cf[u * cfg.k_p : (u + 1) * cfg.k_p]
                sc = cs[v * cfg.n_p : (v + 1) * cfg.n_p]
                fc = fc + [0] * (cfg.k_p - len(fc))
                sc = sc + [0] * (cfg.n_p - len(sc))
                total += filter_pack_multiply(cfg, fc, sc)
                f_chunks.append(fc)
                s_chunks.append(sc)
            coeffs = filter_pack_decode(cfg, total, f_chunks, s_chunks)
            off = u * cfg.k_p + v * cfg.n_p
            for m, c in enumerate(coeffs):
                if off + m < out.shape[0]:
                    out[off + m] += c
    return out


# ---------------------------------------------------------------------------
# Operand Separation (Eq. 5)
# ---------------------------------------------------------------------------


def separate_operand(v: int, bits: int) -> tuple[int, int, int]:
    """Split a ``bits``-wide unsigned value into (hi, lo, lo_bits).

    v = hi * 2**lo_bits + lo with lo_bits = ceil(bits/2); hi needs
    bits - lo_bits bits, lo needs lo_bits bits.
    """
    lo_bits = -(-bits // 2)
    return v >> lo_bits, v & ((1 << lo_bits) - 1), lo_bits
