"""The layers of ``repro.models.layers`` in PyTorch: decode, train
(``attention_train``, ``mlp``, QAT ``dense``) and serve.

Params are plain dicts of tensors with the reference's keys and layouts
(``x @ W`` with W ``[d_in, d_out]``).  Every projection goes through
:func:`dense`; prepacked weights (:class:`PackedDenseParams`) run the
packed matmul kernels.  The paged KV pools and the flat KV caches are
updated in place (the reference returns new ones; its jitted steps donate
the old).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.core.quant import fake_quant_act, fake_quant_weight
from repro_torch.kernels.packed_matmul.ops import PackedDenseParams, packed_dense, prepack_dense
from repro_torch.kernels.paged_gather.ops import paged_gather_kv


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Per-projection (w_bits, a_bits) assignment for QAT fake-quant."""

    bits: Mapping[str, tuple[int, int]] = dataclasses.field(default_factory=dict)
    serve_int8: bool = False

    def for_proj(self, name: str) -> tuple[int, int] | None:
        return self.bits.get(name)


NO_QUANT = QuantConfig()


def dense(params: dict, x: torch.Tensor, *, name: str = "", quant: QuantConfig = NO_QUANT) -> torch.Tensor:
    """``x @ W``; prepacked weights run the packed serving path, int8
    serving weights (``{"levels", "scale"}``) are dequantized in ``x``'s
    dtype before the product, and a projection that ``quant`` names
    trains with QAT fake-quant (straight-through gradients), all in the
    reference's op order."""
    w = params["w"]
    if isinstance(w, PackedDenseParams):
        # the sigmoid proxy bounds activations to [0, 1], as the QAT path
        lead = x.shape[:-1]
        xq = torch.sigmoid(x).to(torch.float32).reshape(-1, x.shape[-1])
        y = packed_dense(xq, w)
        return y.reshape(*lead, w.n_out).to(x.dtype)
    if isinstance(w, dict):  # int8 serving layout {"levels", "scale"}
        w = w["levels"].to(x.dtype) * w["scale"].to(x.dtype)
    else:
        qa = quant.for_proj(name)
        if qa is not None:  # QAT: fake-quant weight and the bounded pre-activation proxy
            wb, ab = qa
            w = fake_quant_weight(w, wb)
            x = fake_quant_act(torch.sigmoid(x), ab)
    return x @ w.to(x.dtype)


def quantize_weight_int8(w: torch.Tensor, *, dim: int = -2, bits: int = 8) -> dict:
    """Symmetric levels of ``w`` over ``dim`` (one scale per output column
    of a ``[..., K, N]`` weight at ``dim=-2``; the scales keep ``dim``):
    the int8 serving layout ``{"levels": int8, "scale": float32}``."""
    n = (1 << (bits - 1)) - 1
    scale = torch.amax(torch.abs(w), dim=dim, keepdim=True) / n + 1e-12
    levels = torch.clamp(torch.round(w / scale), -n, n).to(torch.int8)
    return {"levels": levels, "scale": scale.to(torch.float32)}


def quantize_dense_for_serving(params: dict, bits: int = 8) -> dict:
    """Convert a dense kernel ``[K, N]`` to symmetric int8-level storage."""
    return {"w": quantize_weight_int8(params["w"], dim=0, bits=bits)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = torch.mean(torch.square(x), dim=-1, keepdim=True, dtype=torch.float32)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * params["g"].to(x.dtype)


@functools.lru_cache(maxsize=None)
def rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """The ``half`` float32 rotary frequencies ``theta ** (-i / half)``,
    computed once on the host (as the CPU computes them) and cached on
    ``device``: every device rotates by the same table, where a device's
    own ``pow`` one ulp off would move the angle at position p by p ulps.
    The first call for a device runs outside any graph capture (the
    engine's step runs eagerly once before it is captured)."""
    return (theta ** (-torch.arange(0, half, dtype=torch.float32) / half)).to(device)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of ``x [..., S, H, hd]`` by ``ang [..., S, hd/2]``
    (float32), cos and sin cast to ``x.dtype`` first, as the reference."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[..., None, :].to(x.dtype)  # broadcast over heads
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10_000.0) -> torch.Tensor:
    """Standard RoPE.  x: [..., S, H, hd]; positions broadcastable to [..., S]."""
    freqs = rope_freqs(x.shape[-1] // 2, theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def mrope(x: torch.Tensor, positions3: torch.Tensor, *, theta: float = 10_000.0,
          sections: tuple[int, int, int] = (2, 1, 1)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the half-dim frequency bands split by ``sections``
    (relative sizes, the last band taking the remainder) across the
    (temporal, height, width) position streams.  x: [..., S, H, hd];
    positions3: [..., S, 3].  With three equal streams it is :func:`rope`
    bit for bit."""
    half = x.shape[-1] // 2
    total = sum(sections)
    bounds = [half * s // total for s in sections]
    bounds[-1] = half - sum(bounds[:-1])
    # which of (t, h, w) drives each frequency band
    sel = torch.cat([torch.full((b,), i, dtype=torch.long, device=x.device) for i, b in enumerate(bounds)])
    pos = positions3.to(torch.float32)[..., sel]  # [..., S, half]
    return _rotate(x, pos * rope_freqs(half, theta, x.device))


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    use_mrope: bool = False
    q_chunk: int = 1024


@functools.lru_cache(maxsize=None)
def _attn_scale(hd: int, dtype: torch.dtype) -> float:
    """The reference's ``1 / sqrt(hd).astype(dtype)``, rounded in ``dtype``;
    a Python float (exact in ``dtype``) so no tensor is made per call."""
    return (1.0 / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype)).item()


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, *, scale: float) -> torch.Tensor:
    # q: [B, Sq, H, hd]; k: [B, Sk, G, hd] -> [B, G, H/G, Sq, Sk]
    B, Sq, H, hd = q.shape
    G = k.shape[2]
    qg = q.reshape(B, Sq, G, H // G, hd)
    return torch.einsum("bqghd,bkgd->bghqk", qg, k) * scale


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, G, hd] -> [B, S, H, hd], each kv head repeated H/G times."""
    G = k.shape[2]
    return k if G == n_heads else torch.repeat_interleave(k, n_heads // G, dim=2)


def attention_train(
    params: dict,
    s: AttnSpec,
    x: torch.Tensor,  # [B, S, d]
    positions: torch.Tensor,  # [B, S] ([B, S, 3] with M-RoPE)
    *,
    window: int = 0,
    quant: QuantConfig = NO_QUANT,
    partial: bool = False,
) -> torch.Tensor:
    """Full-sequence attention, ``x + attn(x)``: ``window`` -1 is
    bidirectional (the encoder), 0 full causal, > 0 a causal sliding
    window.  Queries go in ``q_chunk`` blocks (``max(1, S // min(q_chunk,
    S))`` of them), each against every key, as the reference's scan.

    A tensor-parallel rank passes its local spec (its contiguous heads and
    KV groups), its column slices of ``wq``/``wk``/``wv`` and its row slice
    of ``wo`` with ``partial=True``, and gets its share of the output
    projection, before the residual, for the mesh to sum."""
    B, S, d = x.shape
    H, G, hd = s.n_heads, s.kv_heads, s.head_dim
    h = rmsnorm(params["ln"], x)
    q = dense(params["wq"], h, name="attn_q", quant=quant).reshape(B, S, H, hd)
    k = dense(params["wk"], h, name="attn_k", quant=quant).reshape(B, S, G, hd)
    v = dense(params["wv"], h, name="attn_v", quant=quant).reshape(B, S, G, hd)
    if s.use_mrope:
        q = mrope(q, positions, theta=s.rope_theta)
        k = mrope(k, positions, theta=s.rope_theta)
        pos1d = positions[..., 0]
    else:
        q = rope(q, positions, theta=s.rope_theta)
        k = rope(k, positions, theta=s.rope_theta)
        pos1d = positions
    k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    scale = _attn_scale(hd, x.dtype)
    n_chunks = max(1, S // min(s.q_chunk, S))
    cq = S // n_chunks
    outs = []
    for c in range(n_chunks):
        q_blk = q[:, c * cq:(c + 1) * cq]
        qpos = pos1d[:, c * cq:(c + 1) * cq]
        scores = torch.einsum("bqhd,bkhd->bhqk", q_blk, k) * scale  # [B, H, cq, S]
        if window < 0:
            allow = torch.ones((B, cq, S), dtype=torch.bool, device=x.device)
        else:
            allow = pos1d[:, None, :] <= qpos[:, :, None]  # causal [B, cq, S]
            if window > 0:
                allow = allow & ((qpos[:, :, None] - pos1d[:, None, :]) < window)
        scores = torch.where(allow[:, None], scores, torch.finfo(scores.dtype).min)
        p = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v))
    o = torch.cat(outs, dim=1).reshape(B, S, H * hd)
    out = dense(params["wo"], o, name="attn_o", quant=quant)
    return out if partial else x + out


def quantize_kv_row(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of KV rows [..., D]."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True).to(torch.float32) / 127.0 + 1e-12
    levels = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return levels, scale


def attention_decode(
    params: dict,
    s: AttnSpec,
    x: torch.Tensor,  # [B, 1, d] the new token
    cache_k: torch.Tensor,  # [B, T, G*hd] flat KV cache (updated in place)
    cache_v: torch.Tensor,
    pos: torch.Tensor,  # [] int32 current position
    *,
    window: int = 0,
    quant: QuantConfig = NO_QUANT,
    cache_k_scale: torch.Tensor | None = None,  # [B, T, 1] float32 for int8 caches
    cache_v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One new token against a flat KV cache; returns ``x + attn(x)``.

    The token's K/V row is written into the cache in place at row ``pos``
    clamped to ``T - 1``, as ``jax.lax.dynamic_update_slice_in_dim``
    clamps: past the cache's end the last row is overwritten and, every key
    being at or before ``pos``, nothing is masked but the window.  An int8
    cache (``cache_k.dtype == int8``) takes quantized rows and per-row
    scales and is dequantized whole in ``x.dtype``.  ``pos`` is a device
    tensor, so a captured step reads it from its buffer."""
    B = x.shape[0]
    H, G, hd = s.n_heads, s.kv_heads, s.head_dim
    T = cache_k.shape[1]
    kv_int8 = cache_k.dtype == torch.int8
    h = rmsnorm(params["ln"], x)
    q = dense(params["wq"], h, name="attn_q", quant=quant).reshape(B, 1, H, hd)
    k = dense(params["wk"], h, name="attn_k", quant=quant).reshape(B, 1, G, hd)
    v = dense(params["wv"], h, name="attn_v", quant=quant).reshape(B, 1, G, hd)
    if s.use_mrope:
        pos3 = pos.reshape(1, 1, 1).expand(B, 1, 3)
        q = mrope(q, pos3, theta=s.rope_theta)
        k = mrope(k, pos3, theta=s.rope_theta)
    else:
        posb = pos.reshape(1, 1).expand(B, 1)
        q = rope(q, posb, theta=s.rope_theta)
        k = rope(k, posb, theta=s.rope_theta)
    row = torch.clamp(pos, 0, T - 1).reshape(1).long()
    k_row = k.reshape(B, 1, G * hd)
    v_row = v.reshape(B, 1, G * hd)
    if kv_int8:
        k_lvl, k_sc = quantize_kv_row(k_row)
        v_lvl, v_sc = quantize_kv_row(v_row)
        for cache, new in ((cache_k, k_lvl), (cache_v, v_lvl), (cache_k_scale, k_sc), (cache_v_scale, v_sc)):
            cache.index_copy_(1, row, new)
        k_view = (cache_k.to(x.dtype) * cache_k_scale.to(x.dtype)).reshape(B, T, G, hd)
        v_view = (cache_v.to(x.dtype) * cache_v_scale.to(x.dtype)).reshape(B, T, G, hd)
    else:
        cache_k.index_copy_(1, row, k_row.to(cache_k.dtype))
        cache_v.index_copy_(1, row, v_row.to(cache_v.dtype))
        k_view = cache_k.reshape(B, T, G, hd)
        v_view = cache_v.reshape(B, T, G, hd)
    scores = _gqa_scores(q, k_view.to(x.dtype), scale=_attn_scale(hd, x.dtype))  # [B,G,H/G,1,T]
    kpos = torch.arange(T, dtype=torch.int32, device=x.device)
    mask = kpos <= pos
    if window > 0:
        mask = mask & ((pos - kpos) < window)
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    p = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
    o = torch.einsum("bghqk,bkgd->bqghd", p, v_view.to(x.dtype))
    return x + dense(params["wo"], o.reshape(B, 1, H * hd), name="attn_o", quant=quant)


def cross_attention(
    params: dict,
    s: AttnSpec,
    x: torch.Tensor,  # [B, Sq, d]
    enc_kv: tuple[torch.Tensor, torch.Tensor],  # ([B, Se, G, hd], [B, Se, G, hd])
    *,
    quant: QuantConfig = NO_QUANT,
) -> torch.Tensor:
    """Queries of ``x`` against the encoder's precomputed K/V, unmasked;
    returns ``x + attn(x)`` (the whisper decoder's cross-attention)."""
    B, Sq, d = x.shape
    H, G, hd = s.n_heads, s.kv_heads, s.head_dim
    h = rmsnorm(params["ln"], x)
    q = dense(params["wq"], h, name="xattn_q", quant=quant).reshape(B, Sq, H, hd)
    k, v = enc_kv
    scores = _gqa_scores(q, k.to(x.dtype), scale=_attn_scale(hd, x.dtype))
    p = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
    o = torch.einsum("bghqk,bkgd->bqghd", p, v.to(x.dtype))
    return x + dense(params["wo"], o.reshape(B, Sq, H * hd), name="xattn_o", quant=quant)


def attention_decode_paged(
    params: dict,
    s: AttnSpec,
    x: torch.Tensor,  # [S, C, d]
    pool_k: torch.Tensor,  # [P, page_size, G*hd] this layer's page pool (updated in place)
    pool_v: torch.Tensor,
    block_table: torch.Tensor,  # [S, n_blocks] int32 (0 = null page)
    pos: torch.Tensor,  # [S] int32 position of each slot's first token
    *,
    window: int = 0,
    quant: QuantConfig = NO_QUANT,
    pool_k_scale: torch.Tensor | None = None,  # [P, page_size, 1] for int8 pools
    pool_v_scale: torch.Tensor | None = None,
    lens: torch.Tensor | None = None,
    gather: str = "xla",
    partial: bool = False,
) -> torch.Tensor:
    """One decode step against a paged KV pool; returns ``x + attn(x)``.

    The chunk's K/V rows are written into the pools in place; ``gather``
    picks the ``pool[block_table]`` view ("xla") or the CUDA paged-gather
    kernel ("kernel"), bit-exact with each other on every active slot (the
    kernel zeroes the null page, which only an inactive slot's lanes see).

    Chunked prefill: with ``lens`` given, lane ``j`` of slot ``i`` is valid
    when ``j < lens[i]``; each valid lane attends causally up to its own
    position ``pos + j`` (the chunk's own rows included, just written), and
    invalid lanes scatter onto null page 0.  ``lens=None``: every lane is
    valid.

    A tensor-parallel rank (the reference's ``axis_name``) passes its local
    spec (``n_heads / mp`` heads, ``kv_heads / mp`` KV groups), its column
    slices of ``wq``/``wk``/``wv``, its row slice of ``wo`` and pools of its
    KV groups, with ``partial=True``: it gets its share of the output
    projection, before the residual, which the mesh sums over the ranks
    and adds to ``x`` (a sum after the residual would scale it by ``mp``)."""
    S, C, d = x.shape
    H, G, hd = s.n_heads, s.kv_heads, s.head_dim
    page_size = pool_k.shape[1]
    n_blocks = block_table.shape[1]
    T = n_blocks * page_size
    kv_int8 = pool_k.dtype == torch.int8
    h = rmsnorm(params["ln"], x)
    q = dense(params["wq"], h, name="attn_q", quant=quant).reshape(S, C, H, hd)
    k = dense(params["wk"], h, name="attn_k", quant=quant).reshape(S, C, G, hd)
    v = dense(params["wv"], h, name="attn_v", quant=quant).reshape(S, C, G, hd)
    posc = pos[:, None] + torch.arange(C, dtype=torch.int32, device=x.device)[None]  # [S, C]
    if s.use_mrope:  # the decode feeds one position to all three streams
        pos3 = posc[..., None].expand(S, C, 3)
        q = mrope(q, pos3, theta=s.rope_theta)
        k = mrope(k, pos3, theta=s.rope_theta)
    else:
        q = rope(q, posc, theta=s.rope_theta)
        k = rope(k, posc, theta=s.rope_theta)
    k_rows = k.reshape(S, C, G * hd)
    v_rows = v.reshape(S, C, G * hd)
    if lens is None:
        page = torch.gather(block_table, 1, (posc // page_size).long()).long()  # [S, C]
        off = (posc % page_size).long()
    else:
        # invalid lanes (j >= lens) scatter onto null page 0 (several of them
        # onto one row: whichever write lands, no live lane reads page 0);
        # their positions are clamped so the block-table lookup stays in range
        lane_ok = torch.arange(C, dtype=torch.int32, device=x.device)[None] < lens[:, None]
        idx = torch.clamp(posc, max=T - 1)
        page = torch.where(lane_ok, torch.gather(block_table, 1, (idx // page_size).long()), 0).long()
        off = (idx % page_size).long()
    if kv_int8:
        k_lvl, k_sc = quantize_kv_row(k_rows)
        v_lvl, v_sc = quantize_kv_row(v_rows)
        pool_k[page, off] = k_lvl
        pool_v[page, off] = v_lvl
        pool_k_scale[page, off] = k_sc
        pool_v_scale[page, off] = v_sc
    else:
        pool_k[page, off] = k_rows.to(pool_k.dtype)
        pool_v[page, off] = v_rows.to(pool_v.dtype)
    k_flat, v_flat, lane_mask = paged_gather_kv(
        pool_k, pool_v, block_table, pos, window=window, chunk=C,
        k_scale=pool_k_scale, v_scale=pool_v_scale, out_dtype=x.dtype, backend=gather,
    )
    k_view = k_flat.reshape(S, T, G, hd)
    v_view = v_flat.reshape(S, T, G, hd)
    mask = lane_mask[:, None, None, :, :]
    scores = _gqa_scores(q, k_view.to(x.dtype), scale=_attn_scale(hd, x.dtype))  # [S,G,H/G,C,T]
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    p = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
    o = torch.einsum("bghqk,bkgd->bqghd", p, v_view.to(x.dtype))
    out = dense(params["wo"], o.reshape(S, C, H * hd), name="attn_o", quant=quant)
    return out if partial else x + out


def prepack_lm_head(
    embed: torch.Tensor,
    *,
    w_bits: int = 8,
    a_bits: int = 8,
    t_max: torch.Tensor | float | None = None,
    device: str | torch.device = "cuda",
) -> PackedDenseParams:
    """One-time quantize + bit-pack of the tied LM head (``embed.T``).
    ``t_max``: a vocab slice of the embedding packed against the whole
    embedding's normalizer (a tensor-parallel rank's head) is a column
    slice of the whole head's packed words."""
    return prepack_dense(embed.T.contiguous(), w_bits=w_bits, a_bits=a_bits, t_max=t_max,
                         device=device)


def lm_head(x: torch.Tensor, embed: torch.Tensor, dtype: torch.dtype,
            packed: PackedDenseParams | None = None) -> torch.Tensor:
    """Final logits: x [B, d] -> [B, V] float32, packed or tied float.  A
    tensor-parallel rank passes its vocab slice (``head_embed``, or the
    packed head of those rows) and gets its columns of the logits."""
    if packed is not None:
        xq = torch.sigmoid(x).to(torch.float32)
        return packed_dense(xq, packed).to(torch.float32)
    return (x @ embed.to(dtype).T).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    d_model: int
    d_ff: int
    kind: str = "swiglu"  # swiglu | geglu | squared_relu | gelu


def mlp(params: dict, s: MLPSpec, x: torch.Tensor, *, quant: QuantConfig = NO_QUANT,
        partial: bool = False) -> torch.Tensor:
    """``x + mlp(x)``.  A tensor-parallel rank passes its column slices of
    ``w_up``/``w_gate`` and its row slice of ``w_down`` (``s.d_ff`` the
    local width) with ``partial=True`` and gets its share of the output,
    before the residual, for the mesh to sum."""
    h = rmsnorm(params["ln"], x)
    up = dense(params["w_up"], h, name="mlp_up", quant=quant)
    if s.kind in ("swiglu", "geglu"):
        gate = dense(params["w_gate"], h, name="mlp_gate", quant=quant)
        # jax.nn.gelu defaults to the tanh approximation
        act = (F.silu(gate) if s.kind == "swiglu" else F.gelu(gate, approximate="tanh")) * up
    elif s.kind == "squared_relu":
        r = F.relu(up)
        act = r * r
    else:
        act = F.gelu(up, approximate="tanh")
    out = dense(params["w_down"], act, name="mlp_down", quant=quant)
    return out if partial else x + out
