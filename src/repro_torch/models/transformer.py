"""The paged decode path of ``repro.models.transformer`` in PyTorch.

Params are a dict with the reference's pytree keys: ``embed`` [V, d],
``final_ln``, and ``layers`` — stacked ``[L, ...]`` tensors (the
reference's scan layout) or a list of per-layer dicts.  The reference
scans the stacked layers; here a Python loop walks them.  The dense
attention family (KV page pools), with an MLP or with experts (a layer's
``moe`` block in place of its ``mlp``: :mod:`repro_torch.models.moe`, one
device), and the SSM family (mamba2: slot-indexed recurrent state) are
served; hybrid and encoder-decoder configs raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as X


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

    def moe_spec(self) -> X.MoESpec:
        return X.MoESpec(d_model=self.d_model, d_ff=self.expert_d_ff, n_experts=self.n_experts,
                         top_k=self.top_k, capacity_factor=self.capacity_factor, kind=self.mlp_kind)

    def ssm_spec(self) -> M.MambaSpec:
        """One device's spec (the reference's ``shard_heads`` waits for the mesh)."""
        return M.MambaSpec(d_model=self.d_model, d_state=self.ssm_state,
                           head_dim=self.ssm_head_dim, chunk=self.ssm_chunk)

    def windows(self) -> list[int]:
        pat = self.window_pattern
        reps = -(-self.n_layers // len(pat))
        return list((pat * reps)[: self.n_layers])


def _check_served(cfg: ModelConfig) -> None:
    if cfg.family not in ("attn", "ssm"):
        raise NotImplementedError(
            f"the port serves the attention family (with an MLP or with experts) and the SSM "
            f"family so far, not {cfg.name!r} (family {cfg.family!r}); the hybrid and encdec paths "
            f"wait for 'Training, QAT and NAS' (ROADMAP.md, port queue)"
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

    def top(layers: dict) -> dict:  # the embedding is drawn after the layers
        return {"embed": normal(cfg.vocab, d) * 0.01, "final_ln": {"g": ones(d)}, "layers": layers}

    if cfg.family == "ssm":
        return top(M.mamba_init(g, cfg.ssm_spec(), Ln))
    attn = {
        "wq": {"w": normal(Ln, d, H * hd, fan_in=d)},
        "wk": {"w": normal(Ln, d, G * hd, fan_in=d)},
        "wv": {"w": normal(Ln, d, G * hd, fan_in=d)},
        "wo": {"w": normal(Ln, H * hd, d, fan_in=H * hd)},
        "ln": {"g": ones(Ln, d)},
    }
    if cfg.is_moe:  # the experts replace the MLP: router/w, w_up, w_gate, w_down, ln
        return top({"attn": attn, "moe": X.moe_init(g, cfg.moe_spec(), lead=(Ln,))})
    mlp = {
        "w_up": {"w": normal(Ln, d, ff, fan_in=d)},
        "w_down": {"w": normal(Ln, ff, d, fan_in=ff)},
        "ln": {"g": ones(Ln, d)},
    }
    if cfg.mlp_kind in ("swiglu", "geglu"):
        mlp["w_gate"] = {"w": normal(Ln, d, ff, fan_in=d)}
    return top({"attn": attn, "mlp": mlp})


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
                     dtype: torch.dtype = torch.bfloat16, kv_dtype=None,
                     device: str | torch.device = "cuda") -> dict:
    """The paged serving state.  Attention: KV pools ``[L, n_pages,
    page_size, G*hd]`` (page 0 = null page), ``dtype`` pools or int8 level
    pools plus float32 per-row scale pools.  SSM: the recurrent state is
    O(1) a sequence, so it stays slot-indexed, a float32 ``ssm`` state
    ``[L, n_slots, H, N, P]`` and a ``conv`` state ``[L, n_slots,
    conv_width - 1, d_inner + 2N]`` in ``dtype``, zeroed on admission
    (:func:`reset_paged_slot`); no pools.

    ``kv_dtype`` overrides ``cfg.kv_dtype``: "int8", ``torch.int8``, or a
    float dtype (which then replaces ``dtype``)."""
    _check_served(cfg)
    dev = resolve_device(device)
    kv = cfg.kv_dtype if kv_dtype is None else kv_dtype
    kv_int8 = kv == "int8" or kv == torch.int8
    if not kv_int8 and kv_dtype is not None and not isinstance(kv, str):
        dtype = kv  # an explicit float override (e.g. float32 pools)
    if cfg.family == "ssm":
        s = cfg.ssm_spec()
        return {
            "ssm": torch.zeros((cfg.n_layers, n_slots, s.n_heads, s.d_state, s.head_dim),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros((cfg.n_layers, n_slots, s.conv_width - 1, s.d_inner + 2 * s.d_state),
                                dtype=dtype, device=dev),
        }
    shape = (cfg.n_layers, n_pages, page_size, (cfg.kv_heads // cfg.tp_shards) * cfg.hd)
    if kv_int8:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=dev),
            "v_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=dev),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def reset_paged_slot(cfg: ModelConfig, state: dict, slot: int) -> dict:
    """Zero one slot's recurrent state in place when the scheduler
    (re-)admits into it; returns ``state``.  Attention state needs no
    reset (a fresh sequence starts at position 0, so every stale page row
    is masked until overwritten), but the SSM and conv states are carried
    from step to step and must start from zero."""
    if cfg.family == "ssm":
        state["ssm"][:, slot].zero_()
        state["conv"][:, slot].zero_()
    return state


def embed_paged(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding ``[S, C] -> [S, C, d]`` in ``cfg.dtype`` (rows are
    gathered before the cast, so the table is never converted whole)."""
    return params["embed"][tokens.long()].to(cfg.dtype)


def decode_paged_layer(p: dict, cfg: ModelConfig, layer_state: dict, block_table: torch.Tensor,
                       h: torch.Tensor, pos: torch.Tensor, *, window: int = -1,
                       lens: torch.Tensor | None = None, gather: str = "xla") -> torch.Tensor:
    """One layer of the paged decode step; ``layer_state`` (this layer's
    ``k``/``v`` [+ scales] pools, or its ``ssm``/``conv`` state) is updated
    in place.  The SSM family ignores ``block_table``, ``pos``, ``window``
    and ``gather``; its new states are copied into the given ones, never
    rebound, so a captured step writes the buffers it was captured on.
    With experts the MLP is the MoE block on the step's ``S * C`` tokens
    (the reference's ``_moe_block`` outside a mesh)."""
    _check_served(cfg)
    if cfg.family == "ssm":
        s = cfg.ssm_spec()
        st, cv = layer_state["ssm"], layer_state["conv"]
        if h.shape[1] > 1 or lens is not None:
            # recurrent over the lane axis; invalid lanes leave the state alone
            h, ns, nc = M.mamba_decode_chunk(p, s, h, st, cv, lens=lens, quant=cfg.quant)
        else:
            h, ns, nc = M.mamba_decode(p, s, h, st, cv, quant=cfg.quant)
        st.copy_(ns)
        cv.copy_(nc)
        return h
    h = L.attention_decode_paged(
        p["attn"], cfg.attn_spec(), h, layer_state["k"], layer_state["v"], block_table, pos,
        window=window, quant=cfg.quant, pool_k_scale=layer_state.get("k_scale"),
        pool_v_scale=layer_state.get("v_scale"), lens=lens, gather=gather,
    )
    if cfg.is_moe:
        return X.moe_apply(p["moe"], cfg.moe_spec(), h)
    return L.mlp(p["mlp"], cfg.mlp_spec(), h, quant=cfg.quant)


def head_paged(params: dict, cfg: ModelConfig, x: torch.Tensor, lens: torch.Tensor | None = None,
               head: PackedDenseParams | None = None) -> torch.Tensor:
    """Final norm + each slot's last valid lane + LM head -> [S, V] float32.

    ``lens=None``: every lane is valid, so the last lane.  The lane is
    taken before the head, so the head runs at S rows whatever the chunk."""
    x = L.rmsnorm(params["final_ln"], x)
    if lens is None:
        x_last = x[:, -1, :]
    else:
        last = torch.clamp(lens.long() - 1, min=0)
        x_last = x[torch.arange(x.shape[0], device=x.device), last]
    return L.lm_head(x_last, params["embed"], cfg.dtype, packed=head)


def forward_decode_paged(params: dict, cfg: ModelConfig, state: dict, block_table: torch.Tensor,
                         tokens: torch.Tensor, pos: torch.Tensor, head: PackedDenseParams | None = None,
                         lens: torch.Tensor | None = None, gather: str = "xla"):
    """One continuous-batching decode/prefill step over the slot set.

    ``tokens`` is ``[S, C]``; with ``lens`` given, slot ``i`` feeds its
    first ``lens[i]`` lanes (a prompt chunk while prefilling, 1 while
    decoding, 0 while inactive) and the logits are those of its last valid
    lane.  Returns ``(logits [S, V] float32, state)``; the pools (SSM: the
    recurrent states) in ``state`` are updated in place, so the returned
    state is the same dict.  The SSM family ignores ``block_table``."""
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
