"""The paged decode path of ``repro.models.transformer`` in PyTorch.

Params are a dict with the reference's pytree keys: ``embed`` [V, d],
``final_ln``, and ``layers`` — stacked ``[L, ...]`` tensors (the
reference's scan layout) or a list of per-layer dicts.  The reference
scans the stacked layers; here a Python loop walks them.  This slice
serves the attention family; the other families raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Field-for-field mirror of ``repro.models.transformer.ModelConfig``
    (``dtype`` is a torch dtype)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0
    mlp_kind: str = "swiglu"
    rope_theta: float = 10_000.0
    use_mrope: bool = False
    family: str = "attn"
    window_pattern: tuple[int, ...] = (0,)
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    hybrid_attn_every: int = 6
    enc_layers: int = 0
    q_chunk: int = 1024
    remat: bool = True
    remat_block: int = 1
    zero3_regather: bool = False
    dtype: Any = torch.bfloat16
    quant: L.QuantConfig = L.NO_QUANT
    cache_shard: str = "kv_heads"
    kv_dtype: str = "bf16"
    tp_shards: int = 1

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def attn_spec(self) -> L.AttnSpec:
        return L.AttnSpec(
            d_model=self.d_model,
            n_heads=self.n_heads // self.tp_shards,
            kv_heads=self.kv_heads // self.tp_shards,
            head_dim=self.hd,
            rope_theta=self.rope_theta,
            use_mrope=self.use_mrope,
            q_chunk=self.q_chunk,
        )

    def mlp_spec(self) -> L.MLPSpec:
        return L.MLPSpec(d_model=self.d_model, d_ff=self.d_ff // self.tp_shards, kind=self.mlp_kind)

    def windows(self) -> list[int]:
        pat = self.window_pattern
        reps = -(-self.n_layers // len(pat))
        return list((pat * reps)[: self.n_layers])


def _check_served(cfg: ModelConfig) -> None:
    if cfg.family != "attn" or cfg.is_moe:
        raise NotImplementedError(
            f"the port serves the dense attention family so far, not {cfg.name!r} "
            f"(family {cfg.family!r}, {cfg.n_experts} experts); see ROADMAP.md, port queue"
        )


def init_params(cfg: ModelConfig, *, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random float32 params in the reference's layout, made on ``device``
    from a seeded ``torch.Generator`` (the reference's ``jax.random``
    draws differ; tests share weights through :mod:`repro_torch.bridge`)."""
    _check_served(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    Ln, d, H, G, hd, ff = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd, cfg.d_ff

    def normal(*shape, fan_in=None):
        x = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return x / math.sqrt(fan_in) if fan_in else x

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    attn = {
        "wq": {"w": normal(Ln, d, H * hd, fan_in=d)},
        "wk": {"w": normal(Ln, d, G * hd, fan_in=d)},
        "wv": {"w": normal(Ln, d, G * hd, fan_in=d)},
        "wo": {"w": normal(Ln, H * hd, d, fan_in=H * hd)},
        "ln": {"g": ones(Ln, d)},
    }
    mlp = {
        "w_up": {"w": normal(Ln, d, ff, fan_in=d)},
        "w_down": {"w": normal(Ln, ff, d, fan_in=ff)},
        "ln": {"g": ones(Ln, d)},
    }
    if cfg.mlp_kind in ("swiglu", "geglu"):
        mlp["w_gate"] = {"w": normal(Ln, d, ff, fan_in=d)}
    return {
        "embed": normal(cfg.vocab, d) * 0.01,
        "final_ln": {"g": ones(d)},
        "layers": {"attn": attn, "mlp": mlp},
    }


def map_leaves(tree, fn):
    """Apply ``fn`` to every tensor / packed leaf of a params tree."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(v, fn) for v in tree)
    return fn(tree)


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of stacked ``[L, ...]`` layer params (views, no copies)."""
    return map_leaves(stacked, lambda a: a.layer(i) if isinstance(a, PackedDenseParams) else a[i])


def unstack_layers(params: dict, n_layers: int) -> dict:
    """The per-layer list form of ``params["layers"]`` (views)."""
    if isinstance(params["layers"], (list, tuple)):
        return params
    return dict(params, layers=[layer_params(params["layers"], i) for i in range(n_layers)])


def init_paged_state(cfg: ModelConfig, n_slots: int, n_pages: int, page_size: int, *,
                     dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = "cuda") -> dict:
    """Paged KV pools ``[L, n_pages, page_size, G*hd]`` (page 0 = null page):
    ``dtype`` pools, or, for ``cfg.kv_dtype == "int8"``, int8 level pools
    plus float32 per-row scale pools."""
    _check_served(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size, (cfg.kv_heads // cfg.tp_shards) * cfg.hd)
    if cfg.kv_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=dev),
            "v_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=dev),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def embed_paged(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding ``[S, C] -> [S, C, d]`` in ``cfg.dtype`` (rows are
    gathered before the cast, so the table is never converted whole)."""
    return params["embed"][tokens.long()].to(cfg.dtype)


def decode_paged_layer(p: dict, cfg: ModelConfig, layer_state: dict, block_table: torch.Tensor,
                       h: torch.Tensor, pos: torch.Tensor, *, window: int = -1,
                       lens: torch.Tensor | None = None, gather: str = "xla") -> torch.Tensor:
    """One layer of the paged decode step; ``layer_state`` (this layer's
    ``k``/``v`` [+ scales] pools) is updated in place."""
    _check_served(cfg)
    h = L.attention_decode_paged(
        p["attn"], cfg.attn_spec(), h, layer_state["k"], layer_state["v"], block_table, pos,
        window=window, quant=cfg.quant, pool_k_scale=layer_state.get("k_scale"),
        pool_v_scale=layer_state.get("v_scale"), lens=lens, gather=gather,
    )
    return L.mlp(p["mlp"], cfg.mlp_spec(), h, quant=cfg.quant)


def head_paged(params: dict, cfg: ModelConfig, x: torch.Tensor, lens: torch.Tensor | None = None,
               head: PackedDenseParams | None = None) -> torch.Tensor:
    """Final norm + last lane + LM head -> [S, V] float32."""
    if lens is not None:
        raise NotImplementedError("chunked prefill (lens) comes with the next slice (ROADMAP.md, port queue)")
    x = L.rmsnorm(params["final_ln"], x)
    return L.lm_head(x[:, -1, :], params["embed"], cfg.dtype, packed=head)


def forward_decode_paged(params: dict, cfg: ModelConfig, state: dict, block_table: torch.Tensor,
                         tokens: torch.Tensor, pos: torch.Tensor, head: PackedDenseParams | None = None,
                         lens: torch.Tensor | None = None, gather: str = "xla"):
    """One continuous-batching decode step over the slot set.

    Returns ``(logits [S, V] float32, state)``; the pools in ``state`` are
    updated in place, so the returned state is the same dict."""
    _check_served(cfg)
    x = embed_paged(params, cfg, tokens)
    layers = params["layers"]
    windows = cfg.windows()
    for i in range(cfg.n_layers):
        p = layers[i] if isinstance(layers, (list, tuple)) else layer_params(layers, i)
        layer_state = {name: pool[i] for name, pool in state.items()}
        x = decode_paged_layer(p, cfg, layer_state, block_table, x, pos, window=windows[i],
                               lens=lens, gather=gather)
    return head_paged(params, cfg, x, lens=lens, head=head), state
