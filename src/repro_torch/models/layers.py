"""Decode-path layers (``repro.models.layers``) in PyTorch.

Params are plain dicts of tensors with the reference's keys and layouts
(``x @ W`` with W ``[d_in, d_out]``).  Every projection goes through
:func:`dense`; prepacked weights (:class:`PackedDenseParams`) run the
packed matmul kernels.  The paged KV pools are updated in place (the
reference returns new pools; its jitted step donates the old ones).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Mapping

import torch
import torch.nn.functional as F

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
    """``x @ W``, or the packed serving path for prepacked weights."""
    w = params["w"]
    if isinstance(w, PackedDenseParams):
        # the sigmoid proxy bounds activations to [0, 1], as the QAT path
        lead = x.shape[:-1]
        xq = torch.sigmoid(x).to(torch.float32).reshape(-1, x.shape[-1])
        y = packed_dense(xq, w)
        return y.reshape(*lead, w.n_out).to(x.dtype)
    if isinstance(w, dict):
        raise NotImplementedError("int8 serving weights come with the int8 slice (ROADMAP.md, port queue)")
    if quant.for_proj(name) is not None:
        raise NotImplementedError("QAT fake-quant comes with the training slice (ROADMAP.md, port queue)")
    return x @ w.to(x.dtype)


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = torch.mean(torch.square(x), dim=-1, keepdim=True, dtype=torch.float32)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * params["g"].to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10_000.0) -> torch.Tensor:
    """Standard RoPE.  x: [..., S, H, hd]; positions broadcastable to [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


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


def quantize_kv_row(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of KV rows [..., D]."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True).to(torch.float32) / 127.0 + 1e-12
    levels = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return levels, scale


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
) -> torch.Tensor:
    """One decode step against a paged KV pool; returns ``x + attn(x)``.

    The chunk's K/V rows are written into the pools in place; ``gather``
    picks the ``pool[block_table]`` view ("xla") or the CUDA paged-gather
    kernel ("kernel"), bit-exact with each other on every active slot (the
    kernel zeroes the null page, which only an inactive slot's lane 0 sees)."""
    if lens is not None:
        raise NotImplementedError("chunked prefill (lens) comes with the next slice (ROADMAP.md, port queue)")
    if s.use_mrope:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP.md, port queue)")
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
    q = rope(q, posc, theta=s.rope_theta)
    k = rope(k, posc, theta=s.rope_theta)
    k_rows = k.reshape(S, C, G * hd)
    v_rows = v.reshape(S, C, G * hd)
    page = torch.gather(block_table, 1, (posc // page_size).long()).long()  # [S, C]
    off = (posc % page_size).long()
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
    return x + out


def prepack_lm_head(
    embed: torch.Tensor,
    *,
    w_bits: int = 8,
    a_bits: int = 8,
    t_max: torch.Tensor | float | None = None,
    device: str | torch.device = "cuda",
) -> PackedDenseParams:
    """One-time quantize + bit-pack of the tied LM head (``embed.T``)."""
    return prepack_dense(embed.T.contiguous(), w_bits=w_bits, a_bits=a_bits, t_max=t_max,
                         device=device)


def lm_head(x: torch.Tensor, embed: torch.Tensor, dtype: torch.dtype,
            packed: PackedDenseParams | None = None) -> torch.Tensor:
    """Final logits: x [B, d] -> [B, V] float32, packed or tied float."""
    if packed is not None:
        xq = torch.sigmoid(x).to(torch.float32)
        return packed_dense(xq, packed).to(torch.float32)
    return (x @ embed.to(dtype).T).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    d_model: int
    d_ff: int
    kind: str = "swiglu"  # swiglu | geglu | squared_relu | gelu


def mlp(params: dict, s: MLPSpec, x: torch.Tensor, *, quant: QuantConfig = NO_QUANT) -> torch.Tensor:
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
    return x + out
