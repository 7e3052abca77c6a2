"""The train forward and the decode paths of ``repro.models.transformer``
in PyTorch.

Params are a dict with the reference's pytree keys: ``embed`` [V, d],
``final_ln``, and ``layers`` — stacked ``[L, ...]`` tensors (the
reference's scan layout) or a list of per-layer dicts; the encoder-decoder
family adds ``enc_layers`` and ``xattn_layers`` (stacked), the hybrid
family one unstacked ``shared_attn``.  The reference scans the stacked
layers; here a Python loop walks them.

The train forward (:func:`forward_train`, the mean next-token loss of
:func:`ce_loss_chunked`) runs every family, the QAT projections of
``cfg.quant`` included, with each layer (or each ``remat_block`` group)
recomputed in the backward when ``cfg.remat`` is set
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).

Two decode paths.  The paged one (:func:`forward_decode_paged`, the
continuous-batching engine's step) serves the dense attention family
(KV page pools), with an MLP or with experts (a layer's ``moe`` block in
place of its ``mlp``: :mod:`repro_torch.models.moe`), and the SSM family
(mamba2: slot-indexed recurrent state).  Its tensor-parallel form
(:func:`forward_decode_paged_tp`, the mesh engine's step) runs ``mp``
ranks' shards in lockstep, block by block, with one reduction over the
ranks before each residual and the logits gathered over the vocab.  The
fixed-batch one
(:func:`init_cache`, :func:`forward_decode`, :func:`encode_for_decode`:
the serve CLI's ``--engine static``) serves every family on a flat
``[L, B, T, ...]`` cache, the encoder-decoder (whisper) and hybrid
(zamba2) families included; its caches are updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
from repro_torch.launch import mesh as LM
from repro_torch.launch.mesh import all_gather, all_reduce_sum
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as X
from repro_torch.parallel import sharding as PS


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
        """The SSM spec; under tensor parallelism (``tp_shards > 1``) a
        rank's, its ``shard_heads`` the rank's share of the heads."""
        shard_heads = None
        if self.tp_shards > 1:
            shard_heads = (2 * self.d_model) // self.ssm_head_dim // self.tp_shards  # expand=2
        return M.MambaSpec(d_model=self.d_model, d_state=self.ssm_state, head_dim=self.ssm_head_dim,
                           chunk=self.ssm_chunk, shard_heads=shard_heads)

    def windows(self) -> list[int]:
        pat = self.window_pattern
        reps = -(-self.n_layers // len(pat))
        return list((pat * reps)[: self.n_layers])


def _check_paged(cfg: ModelConfig) -> None:
    """The reference's engine refuses these families at construction."""
    if cfg.family not in ("attn", "ssm"):
        raise NotImplementedError(
            f"continuous batching supports attn/ssm families, not {cfg.family!r}; "
            f"{cfg.name} decodes through the fixed-batch loop (--engine static: init_cache, forward_decode)"
        )


def init_params(cfg: ModelConfig, *, seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random float32 params in the reference's layout, made on ``device``
    from a seeded ``torch.Generator`` (the reference's ``jax.random``
    draws differ; tests share weights through :mod:`repro_torch.bridge`).
    Every family: attn (an MLP or experts a layer), ssm, encdec (plus
    ``enc_layers`` {attn, mlp} and ``xattn_layers`` {xattn}) and hybrid
    (mamba ``layers`` plus one unstacked ``shared_attn`` {attn, mlp})."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    Ln, d, H, G, hd, ff = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd, cfg.d_ff

    def normal(*shape, fan_in=None):
        x = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return x / math.sqrt(fan_in) if fan_in else x

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def attn(*lead):
        return {
            "wq": {"w": normal(*lead, d, H * hd, fan_in=d)},
            "wk": {"w": normal(*lead, d, G * hd, fan_in=d)},
            "wv": {"w": normal(*lead, d, G * hd, fan_in=d)},
            "wo": {"w": normal(*lead, H * hd, d, fan_in=H * hd)},
            "ln": {"g": ones(*lead, d)},
        }

    def mlp(*lead):
        p = {
            "w_up": {"w": normal(*lead, d, ff, fan_in=d)},
            "w_down": {"w": normal(*lead, ff, d, fan_in=ff)},
            "ln": {"g": ones(*lead, d)},
        }
        if cfg.mlp_kind in ("swiglu", "geglu"):
            p["w_gate"] = {"w": normal(*lead, d, ff, fan_in=d)}
        return p

    if cfg.family in ("ssm", "hybrid"):
        layers = M.mamba_init(g, cfg.ssm_spec(), Ln)
    elif cfg.is_moe:  # the experts replace the MLP: router/w, w_up, w_gate, w_down, ln
        layers = {"attn": attn(Ln), "moe": X.moe_init(g, cfg.moe_spec(), lead=(Ln,))}
    else:
        layers = {"attn": attn(Ln), "mlp": mlp(Ln)}
    extra = {}
    if cfg.family == "encdec":
        extra = {"enc_layers": {"attn": attn(cfg.enc_layers), "mlp": mlp(cfg.enc_layers)},
                 "xattn_layers": {"xattn": attn(Ln)}}
    elif cfg.family == "hybrid":
        extra = {"shared_attn": {"attn": attn(), "mlp": mlp()}}
    # the embedding is drawn after the layers
    return {"embed": normal(cfg.vocab, d) * 0.01, "final_ln": {"g": ones(d)}, "layers": layers, **extra}


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
    _check_paged(cfg)
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
    _check_paged(cfg)
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
    # a tensor-parallel rank's tree carries its vocab slice beside the embedding
    return L.lm_head(x_last, params.get("head_embed", params["embed"]), cfg.dtype, packed=head)


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
    _check_paged(cfg)
    x = embed_paged(params, cfg, tokens)
    layers = params["layers"]
    windows = cfg.windows()
    for i in range(cfg.n_layers):
        p = layers[i] if isinstance(layers, (list, tuple)) else layer_params(layers, i)
        layer_state = {name: pool[i] for name, pool in state.items()}
        x = decode_paged_layer(p, cfg, layer_state, block_table, x, pos, window=windows[i],
                               lens=lens, gather=gather)
    return head_paged(params, cfg, x, lens=lens, head=head), state


def decode_paged_layer_tp(ps: list, cfg: ModelConfig, layer_states: list, block_tables: list, hs: list,
                          poss: list, *, window: int = -1, lens: list | None = None,
                          gather: str = "xla") -> list:
    """One layer of the paged decode step on ``mp`` tensor-parallel ranks in
    lockstep: per-rank params, state (updated in place), batch and hidden
    states (replicated); ``cfg`` carries ``tp_shards = mp``.  Each block's
    rank shares are summed over the ranks (:func:`all_reduce_sum`) before
    its residual: attention, then the MLP (or the expert-sharded MoE); the
    SSM block reduces twice, in its output norm and after ``out_proj``."""
    mp = len(ps)
    if cfg.family == "ssm":
        outs, sts, cvs = M.mamba_decode_tp(
            ps, cfg.ssm_spec(), hs, [st["ssm"] for st in layer_states], [st["conv"] for st in layer_states],
            lens=lens, quant=cfg.quant)
        for st, ns, nc in zip(layer_states, sts, cvs):
            st["ssm"].copy_(ns)
            st["conv"].copy_(nc)
        return outs
    aspec = cfg.attn_spec()
    lane_lens = lens if lens is not None else [None] * mp
    parts = [L.attention_decode_paged(
        ps[r]["attn"], aspec, hs[r], layer_states[r]["k"], layer_states[r]["v"], block_tables[r], poss[r],
        window=window, quant=cfg.quant, lens=lane_lens[r], gather=gather, partial=True) for r in range(mp)]
    hs = [h + o for h, o in zip(hs, all_reduce_sum(parts))]
    if cfg.is_moe:
        S, C, d = hs[0].shape
        parts = [X._local_moe_expert_sharded(ps[r]["moe"], cfg.moe_spec(), hs[r].reshape(S * C, d),
                                             rank=r, mp=mp).reshape(S, C, d) for r in range(mp)]
    else:
        parts = [L.mlp(ps[r]["mlp"], cfg.mlp_spec(), hs[r], quant=cfg.quant, partial=True) for r in range(mp)]
    return [h + o for h, o in zip(hs, all_reduce_sum(parts))]


def forward_decode_paged_tp(shards: list, cfg: ModelConfig, states: list, block_table: torch.Tensor,
                            tokens: torch.Tensor, pos: torch.Tensor, heads: list | None = None,
                            lens: torch.Tensor | None = None, gather: str = "xla"):
    """:func:`forward_decode_paged` on ``mp`` tensor-parallel ranks (the
    reference's step under ``shard_map`` with ``axis_name="model"``).

    ``shards`` are the ranks' trees (:func:`~repro_torch.parallel.slice_decode_params`,
    packed or not; stacked or per-layer list layers), each on its rank's
    device; ``states`` their paged states (local KV groups or SSM heads,
    updated in place); ``cfg`` carries ``tp_shards = mp``; ``heads`` the
    ranks' packed vocab slices of the head, or None for the tied float
    head on ``head_embed``.  The batch is copied to every rank's device.
    Returns ``(logits [S, V] float32 on the first rank's device, states)``;
    the logits are the ranks' vocab slices concatenated, as the
    reference's tiled ``all_gather``."""
    _check_paged(cfg)
    mp = len(shards)
    if cfg.tp_shards != mp:
        raise ValueError(f"{mp} shards for a config with tp_shards={cfg.tp_shards}")
    devs = [sh["embed"].device for sh in shards]

    def put(t):
        return None if t is None else [t.to(dv) for dv in devs]

    tables, poss, lenss = put(block_table), put(pos), put(lens)
    xs = [embed_paged(sh, cfg, tk) for sh, tk in zip(shards, put(tokens))]
    windows = cfg.windows()
    for i in range(cfg.n_layers):
        ps = [sh["layers"][i] if isinstance(sh["layers"], (list, tuple)) else layer_params(sh["layers"], i)
              for sh in shards]
        layer_states = [{name: pool[i] for name, pool in st.items()} for st in states]
        xs = decode_paged_layer_tp(ps, cfg, layer_states, tables, xs, poss, window=windows[i], lens=lenss,
                                   gather=gather)
    heads = heads if heads is not None else [None] * mp
    parts = [head_paged(sh, cfg, x, lens=None if lenss is None else lenss[r], head=heads[r])
             for r, (sh, x) in enumerate(zip(shards, xs))]
    return all_gather(parts, dim=1), states


# -- the train forward (next-token loss) ------------------------------------------


def _hybrid_segments(cfg: ModelConfig) -> list[int]:
    """Segment sizes between shared-attention applications (zamba2):
    ``hybrid_attn_every`` layers each, the remainder last."""
    k, n = cfg.hybrid_attn_every, cfg.n_layers
    return [k] * (n // k) + ([n % k] if n % k else [])


def _unbind_layers(stacked, n: int) -> list:
    """Per-layer dicts of stacked ``[L, ...]`` params by ``torch.unbind``,
    whose backward stacks the layers' gradients into one tensor a leaf (a
    view per layer would add a zero-filled full-size gradient per layer);
    a per-layer list is returned as it is."""
    if isinstance(stacked, (list, tuple)):
        return list(stacked)

    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return tree.unbind(0)

    return split(stacked)


def _maybe_ckpt(f, cfg: ModelConfig):
    """``f`` recomputed in the backward (its activations not kept) when
    ``cfg.remat`` is set."""
    if not cfg.remat:
        return f
    return lambda *args: checkpoint(f, *args, use_reentrant=False)


def _attn_mlp_block(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                    window: int) -> torch.Tensor:
    x = L.attention_train(p["attn"], cfg.attn_spec(), x, positions, window=window, quant=cfg.quant)
    if cfg.is_moe:  # one device: the reference's _moe_block outside a mesh
        return X.moe_apply(p["moe"], cfg.moe_spec(), x)
    return L.mlp(p["mlp"], cfg.mlp_spec(), x, quant=cfg.quant)


def _scan_stack(body, cfg: ModelConfig, x: torch.Tensor, xs: list) -> torch.Tensor:
    """``x = body(x, item)`` over the layers' items, each layer
    checkpointed when ``cfg.remat``; with ``remat_block > 1`` dividing the
    layer count, groups of that many layers are checkpointed instead, so
    only group boundaries are kept for the backward."""
    rb, n = cfg.remat_block, len(xs)
    if cfg.remat and rb > 1 and n % rb == 0:
        def group(x, *items):
            for item in items:
                x = body(x, item)
            return x

        for g in range(n // rb):
            x = checkpoint(group, x, *xs[g * rb:(g + 1) * rb], use_reentrant=False)
        return x
    step = _maybe_ckpt(body, cfg)
    for item in xs:
        x = step(x, item)
    return x


def _run_attn_stack(layers: list, cfg: ModelConfig, x, positions, windows: list) -> torch.Tensor:
    def body(carry, item):
        p, win = item
        return _attn_mlp_block(p, cfg, carry, positions, win)

    return _scan_stack(body, cfg, x, list(zip(layers, windows)))


def _run_ssm_stack(layers: list, cfg: ModelConfig, x) -> torch.Tensor:
    s = cfg.ssm_spec()
    return _scan_stack(lambda carry, p: M.mamba_train(p, s, carry, quant=cfg.quant), cfg, x, layers)


def forward_train(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: ``tokens`` [B, S] int, ``labels`` [B, S] int (+ ``positions``
    [B, S, 3] for M-RoPE, + ``enc_embeds`` [B, Se, d] for encdec).
    Returns the mean next-token cross-entropy, a float32 scalar.

    The embedding table is cast to ``cfg.dtype`` before the rows are
    gathered, as the reference does (its gradient then sums repeated
    tokens in ``cfg.dtype``).  Stacked layer params are unbound once per
    call (:func:`_unbind_layers`).  Under sharding rules with a mesh
    (:func:`~repro_torch.parallel.sharding.use_rules`) the params are
    sharded and the mesh runs the step (:func:`_forward_train_mesh`);
    ``cfg.zero3_regather`` does nothing without one, as in the reference."""
    rules = PS.mesh_rules(PS.current_rules())
    if rules is not None:
        return _forward_train_mesh(params, cfg, batch, rules)
    if isinstance(params["embed"], LM.Sharded):
        raise TypeError("sharded params run under use_rules(ShardingRules(mesh=...))")
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    x = params["embed"].to(cfg.dtype)[tokens]
    if cfg.use_mrope:
        positions = batch["positions"]  # [B, S, 3]
    else:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    layers = _unbind_layers(params["layers"], cfg.n_layers)

    if cfg.family == "attn":
        x = _run_attn_stack(layers, cfg, x, positions, cfg.windows())
    elif cfg.family == "ssm":
        x = _run_ssm_stack(layers, cfg, x)
    elif cfg.family == "hybrid":
        idx = 0
        for seg in _hybrid_segments(cfg):
            x = _run_ssm_stack(layers[idx: idx + seg], cfg, x)
            idx += seg
            x = _attn_mlp_block(params["shared_attn"], cfg, x, positions, 0)
    elif cfg.family == "encdec":
        enc = batch["enc_embeds"].to(cfg.dtype)  # [B, Se, d] stub frontend
        Se = enc.shape[1]
        enc_pos = torch.arange(Se, dtype=torch.int32, device=x.device)[None].expand(B, Se)
        aspec, mspec = cfg.attn_spec(), cfg.mlp_spec()
        G, hd = cfg.kv_heads, cfg.hd

        def enc_body(carry, p):
            h = L.attention_train(p["attn"], aspec, carry, enc_pos, window=-1)
            return L.mlp(p["mlp"], mspec, h, quant=cfg.quant)

        enc_step = _maybe_ckpt(enc_body, cfg)
        for p in _unbind_layers(params["enc_layers"], cfg.enc_layers):
            enc = enc_step(enc, p)

        def dec_body(carry, p, px, enc):
            h = L.attention_train(p["attn"], aspec, carry, positions, window=0, quant=cfg.quant)
            ek = L.dense(px["xattn"]["wk"], enc, name="xattn_k", quant=cfg.quant).reshape(B, Se, G, hd)
            ev = L.dense(px["xattn"]["wv"], enc, name="xattn_v", quant=cfg.quant).reshape(B, Se, G, hd)
            h = L.cross_attention(px["xattn"], aspec, h, (ek, ev), quant=cfg.quant)
            return L.mlp(p["mlp"], mspec, h, quant=cfg.quant)

        dec_step = _maybe_ckpt(dec_body, cfg)
        for p, px in zip(layers, _unbind_layers(params["xattn_layers"], cfg.n_layers)):
            x = dec_step(x, p, px, enc)
    else:
        raise ValueError(cfg.family)

    x = L.rmsnorm(params["final_ln"], x)
    return ce_loss_chunked(x, params["embed"], batch["labels"])


# -- the train forward on a mesh ------------------------------------------------------

# ROADMAP.md, port queue 1: the families the mesh's train path refuses
MESH_TRAIN_ITEM = "ROADMAP.md, port queue 1, item 2 (the encdec and hybrid families under sharding rules)"


def _mesh_check(cfg: ModelConfig, rules) -> None:
    """What the port's mesh step supports: the attn and ssm families, the
    reference's default axis mapping (tensor parallelism over ``model``,
    the batch over ``data``, ZeRO over ``data`` or off), and head, width,
    expert and vocab counts that divide by ``mp`` (each rank runs whole
    heads)."""
    if cfg.family not in ("attn", "ssm"):
        raise NotImplementedError(f"forward_train under sharding rules runs the attn and ssm families, not "
                                  f"{cfg.family!r}: {MESH_TRAIN_ITEM}")
    mesh = rules.mesh
    for field in ("heads", "kv_heads", "ff", "vocab", "experts"):
        if getattr(rules, field) != "model":
            raise NotImplementedError(f"the mesh's train step maps {field} to the model axis, not "
                                      f"{getattr(rules, field)!r}")
    if LM._spec_axes(rules.batch, mesh) != ("data",) or rules.fsdp not in (None, "data"):
        raise NotImplementedError(f"the mesh's train step shards the batch (and ZeRO, if on) over the data "
                                  f"axis, not batch={rules.batch!r}, fsdp={rules.fsdp!r}")
    mp = mesh.mp
    counts = {"vocab": cfg.vocab}
    if cfg.family == "attn":
        counts.update(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads)
        counts.update({"n_experts": cfg.n_experts} if cfg.is_moe else {"d_ff": cfg.d_ff})
    else:
        counts["ssm heads"] = cfg.ssm_spec().n_heads
    for what, n in counts.items():
        PS._tp_check(n, mp, what)


def _attn_mlp_block_tp(ps: list, cfg: ModelConfig, xs: list, positions: list, window: int) -> list:
    """One attention (dense or MoE) layer on a replica's ``mp`` ranks in
    lockstep (``cfg`` carries ``tp_shards = mp``): each block's rank shares
    summed over the ranks before the residual."""
    aspec = cfg.attn_spec()
    parts = [L.attention_train(p["attn"], aspec, x, pos, window=window, quant=cfg.quant, partial=True)
             for p, x, pos in zip(ps, xs, positions)]
    xs = [x + o for x, o in zip(xs, all_reduce_sum(parts))]
    if cfg.is_moe:
        return _moe_block_tp([p["moe"] for p in ps], cfg, xs)
    parts = [L.mlp(p["mlp"], cfg.mlp_spec(), x, quant=cfg.quant, partial=True) for p, x in zip(ps, xs)]
    return [x + o for x, o in zip(xs, all_reduce_sum(parts))]


def _moe_block_tp(ps: list, cfg: ModelConfig, xs: list) -> list:
    """The reference's ``_moe_block`` under a mesh, one replica's ranks:
    when the sequence divides by ``mp`` the tokens shard over the model
    axis (rank ``r`` takes positions ``r S/mp ..``) and exchange copies
    with the experts' ranks (:func:`~repro_torch.models.moe._local_moe`
    with the axis), the outputs gathered back along the sequence; else
    every rank runs its local experts on every token and the shares are
    summed (:func:`~repro_torch.models.moe._local_moe_expert_sharded`)."""
    B, S, d = xs[0].shape
    mp = len(ps)
    s = cfg.moe_spec()
    if S % mp == 0:
        sl = S // mp
        loc = [x[:, r * sl:(r + 1) * sl] for r, x in enumerate(xs)]
        ys = X.moe_apply(ps, s, loc, axis_name="model")
        full = all_gather(ys, dim=1)
        return [full.to(x.device) for x in xs]
    parts = [X._local_moe_expert_sharded(p, s, x.reshape(B * S, d), rank=r, mp=mp).reshape(B, S, d)
             for r, (p, x) in enumerate(zip(ps, xs))]
    return [x + o for x, o in zip(xs, all_reduce_sum(parts))]


def _ce_loss_vocab_tp(xs: list, embeds: list, labels: list, chunk: int = 512) -> torch.Tensor:
    """:func:`ce_loss_chunked`'s float32 sum (before the division) over a
    replica's ``mp`` vocab shards: rank ``r`` has embedding rows ``r V/mp
    ..``; each chunk's log-sum-exp is the log-sum-exp of the ranks' own,
    and each gold logit comes from the rank whose rows hold its label.  On
    the first rank's device."""
    B, S, _ = xs[0].shape
    n = max(1, S // min(chunk, S))
    cs = S // n
    total = None
    for i in range(n):
        lse, gold = [], []
        for x, emb, lab in zip(xs, embeds, labels):
            vl = emb.shape[0]
            off = len(lse) * vl
            logits = (x[:, i * cs:(i + 1) * cs] @ emb.to(x.dtype).T).to(torch.float32)  # [B, cs, V/mp]
            lse.append(torch.logsumexp(logits, dim=-1)[..., None])
            loc = lab[:, i * cs:(i + 1) * cs].long() - off
            ok = (loc >= 0) & (loc < vl)
            g = torch.gather(logits, -1, loc.clamp(0, vl - 1)[..., None])[..., 0]
            gold.append(torch.where(ok, g, 0.0)[..., None])
        logz = torch.logsumexp(all_gather(lse, dim=-1), dim=-1)
        part = torch.sum(logz - all_gather(gold, dim=-1).sum(-1))
        total = part if total is None else total + part
    return total


def _sharded_layers(layers, n: int) -> list:
    """Per-layer trees of sharded leaves: a per-layer list as it is, or
    each layer of stacked ``[L, ...]`` leaves."""
    if isinstance(layers, (list, tuple)):
        return list(layers)
    return [map_leaves(layers, lambda a, i=i: a.layer(i)) for i in range(n)]


def _forward_train_mesh(params: dict, cfg: ModelConfig, batch: dict, rules) -> torch.Tensor:
    """:func:`forward_train` on the rules' ``dp x mp`` mesh: the
    reference's sharded step, whose loss is the unsharded one.

    ``params`` hold :class:`~repro_torch.launch.mesh.Sharded` leaves laid
    out by ``param_shardings`` (stacked ``[L, ...]`` layers, or a list of
    per-layer trees); the batch's rows split over the ``dp`` replicas, and
    each replica's ``mp`` ranks run in lockstep, every rank holding the
    replicated hidden states: the embedding lookup over vocab shards
    (each rank's rows, summed over the ranks), each layer's attention or
    SSM heads and MLP columns (or experts) on their ranks, each block's
    shares summed before its residual, and the loss over vocab shards with
    a global log-sum-exp.  With ``fsdp="data"`` each rank's weights are
    gathered over the data axis before use: a layer's inside the layer
    loop when ``cfg.zero3_regather`` (freed after it, and gathered again in
    the backward under remat), every layer's before layer 0 otherwise.
    The mean over every replica's tokens is returned on the first rank's
    device."""
    _mesh_check(cfg, rules)
    mesh = rules.mesh
    dp, mp = mesh.shape
    lcfg = dataclasses.replace(cfg, tp_shards=mp)
    tokens = batch["tokens"]
    B, S = tokens.shape
    if B % dp:
        raise ValueError(f"a batch of {B} rows does not split over {dp} data replicas")
    rows = B // dp

    def local(key: str, i: int, r: int) -> torch.Tensor:
        return batch[key][i * rows:(i + 1) * rows].to(mesh.device(i, r))

    emb = PS.regather_layer_params(params["embed"], rules)
    vl = cfg.vocab // mp
    xs, positions = [], []
    for i in range(dp):
        looked = []
        for r in range(mp):
            tok = local("tokens", i, r).long() - r * vl
            ok = (tok >= 0) & (tok < vl)
            looked.append(torch.where(ok[..., None], emb.part(i, r).to(cfg.dtype)[tok.clamp(0, vl - 1)], 0.0))
        xs.append(all_reduce_sum(looked))
        if cfg.use_mrope:
            positions.append([local("positions", i, r) for r in range(mp)])
        else:
            positions.append([torch.arange(S, dtype=torch.int32, device=mesh.device(i, r))[None].expand(rows, S)
                              for r in range(mp)])

    layers = _sharded_layers(params["layers"], cfg.n_layers)
    if not cfg.zero3_regather:
        layers = [PS.regather_layer_params(lp, rules) for lp in layers]

    def gathered(lp):
        return PS.regather_layer_params(lp, rules) if cfg.zero3_regather else lp

    if cfg.family == "attn":
        def body(xs, item):
            lp, win = item
            lp = gathered(lp)
            return [_attn_mlp_block_tp(PS.rank_trees(lp, i, mp), lcfg, xs[i], positions[i], win) for i in range(dp)]

        xs = _scan_stack(body, cfg, xs, list(zip(layers, cfg.windows())))
    else:
        s = lcfg.ssm_spec()

        def body(xs, lp):
            lp = gathered(lp)
            xbc = LM.gather_axis(lp["in_xbc"]["w"], "model")
            out = []
            for i in range(dp):
                ps = [PS.ssm_compute_shard(st, xbc.part(i, r), cfg, mp, r)
                      for r, st in enumerate(PS.rank_trees(lp, i, mp))]
                out.append(M.mamba_train_tp(ps, s, xs[i], quant=cfg.quant))
            return out

        xs = _scan_stack(body, cfg, xs, layers)

    total = None
    for i in range(dp):
        fl = PS.rank_trees(params["final_ln"], i, mp)
        hs = [L.rmsnorm(f, x) for f, x in zip(fl, xs[i])]
        part = _ce_loss_vocab_tp(hs, [emb.part(i, r) for r in range(mp)], [local("labels", i, r) for r in range(mp)])
        total = part if total is None else total + part.to(total.device)
    return total / (B * S)


def ce_loss_chunked(x: torch.Tensor, embed: torch.Tensor, labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Tied-head cross-entropy, chunked over the sequence to bound the
    ``[B, cs, V]`` logit buffer: ``n = max(1, S // min(chunk, S))`` chunks
    of ``cs = S // n`` tokens, summed in float32 in order, divided by
    ``B * S`` (tokens past ``n * cs`` count in the divisor only, as in
    the reference)."""
    B, S, d = x.shape
    n = max(1, S // min(chunk, S))
    cs = S // n
    emb_t = embed.to(x.dtype).T
    labels = labels.long()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        logits = (x[:, i * cs:(i + 1) * cs] @ emb_t).to(torch.float32)  # [B, cs, V]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, i * cs:(i + 1) * cs, None])[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (B * S)


# -- the fixed-batch decode (the serve CLI's --engine static) ---------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype: torch.dtype = torch.bfloat16,
               enc_len: int | None = None, device: str | torch.device = "cuda") -> dict:
    """The fixed-batch cache, zeroed, in the reference's layout and dtypes.

    attn / encdec: flat KV ``k``/``v`` ``[L, B, T, G*hd]`` in ``dtype``, or
    (attn with ``cfg.kv_dtype == "int8"``) int8 levels with float32
    ``[L, B, T, 1]`` scales; encdec adds ``enc_k``/``enc_v`` ``[L, B, Se,
    G*hd]`` with ``Se = enc_len or max(1, max_len // 2)`` (filled by
    :func:`encode_for_decode`).  ssm / hybrid: the float32 ``ssm`` state
    ``[L, B, H, N, P]`` and the ``conv`` state ``[L, B, K-1, conv_dim]``
    in ``dtype``; hybrid adds **one** ``k``/``v`` ``[1, B, T, G*hd]``, which
    every application of the shared block reads and writes."""
    dev = resolve_device(device)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    D = cfg.kv_heads * cfg.hd
    if cfg.family in ("attn", "encdec"):
        shape = (cfg.n_layers, batch, max_len, D)
        if cfg.kv_dtype == "int8" and cfg.family == "attn":
            return {"k": zeros(*shape, dt=torch.int8), "v": zeros(*shape, dt=torch.int8),
                    "k_scale": zeros(*shape[:-1], 1, dt=torch.float32),
                    "v_scale": zeros(*shape[:-1], 1, dt=torch.float32)}
        cache = {"k": zeros(*shape), "v": zeros(*shape)}
        if cfg.family == "encdec":
            se = enc_len or max(1, max_len // 2)
            cache["enc_k"] = zeros(cfg.n_layers, batch, se, D)
            cache["enc_v"] = zeros(cfg.n_layers, batch, se, D)
        return cache
    s = cfg.ssm_spec()
    cache = {"ssm": zeros(cfg.n_layers, batch, s.n_heads, s.d_state, s.head_dim, dt=torch.float32),
             "conv": zeros(cfg.n_layers, batch, s.conv_width - 1, s.d_inner + 2 * s.d_state)}
    if cfg.family == "hybrid":
        cache["k"] = zeros(1, batch, max_len, D)
        cache["v"] = zeros(1, batch, max_len, D)
    return cache


def _ssm_layers(layers, cfg: ModelConfig, cache: dict, x: torch.Tensor, start: int, n: int,
                convs: list) -> torch.Tensor:
    """Mamba layers ``start .. start + n - 1`` of one decode step.  The
    float32 ``ssm`` state is written in place; each new ``conv`` state too,
    unless the step promotes its dtype (a float32 step on a bfloat16 cache,
    as the reference's ``concatenate`` promotes): then ``convs`` collects
    it, for :func:`forward_decode` to rebind."""
    s = cfg.ssm_spec()
    for i in range(start, start + n):
        p = layers[i] if isinstance(layers, (list, tuple)) else layer_params(layers, i)
        x, ns, nc = M.mamba_decode(p, s, x, cache["ssm"][i], cache["conv"][i], quant=cfg.quant)
        cache["ssm"][i].copy_(ns)
        if nc.dtype == cache["conv"].dtype:
            cache["conv"][i].copy_(nc)
        convs.append(nc)
    return x


def forward_decode(params: dict, cfg: ModelConfig, cache: dict, tokens: torch.Tensor, pos,
                   head: PackedDenseParams | None = None) -> tuple[torch.Tensor, dict]:
    """One fixed-batch decode step: ``tokens [B, 1]`` at position ``pos``
    (a 0-d int32 tensor or an int) -> ``(logits [B, V] float32, cache)``.

    ``cache`` (:func:`init_cache`) is updated in place and returned; the
    one exception is a ``conv`` state whose dtype the step promotes, which
    is rebound in ``cache`` as the reference's new cache carries it (after
    one step the dtypes are stable, so a captured step writes in place).
    attn: each layer's attention (flat cache, its window; int8 cache with
    ``cfg.kv_dtype == "int8"``) then its MLP or experts, stacked layers or
    a plan's per-layer list.  encdec: cross-attention against ``enc_k`` /
    ``enc_v`` after each self-attention.  ssm: :func:`mamba_decode` a
    layer, stacked or per-layer.  hybrid: :func:`_hybrid_segments` of
    mamba layers, each followed by the shared attention and MLP, every
    application on the one ``k``/``v`` cache (each overwrites row ``pos``,
    so the cache keeps the last application's rows).  ``head``: a
    prepacked LM head, else the tied embedding."""
    x = embed_paged(params, cfg, tokens)  # [B, 1, d]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    aspec = cfg.attn_spec()
    layers = params["layers"]
    per_layer = isinstance(layers, (list, tuple))
    if per_layer and cfg.family not in ("attn", "ssm"):
        raise NotImplementedError(f"per-layer (list) params support attn/ssm families, not {cfg.family!r}")
    if cfg.family in ("attn", "encdec"):
        windows = cfg.windows()
        kv_int8 = cfg.kv_dtype == "int8" and cfg.family == "attn"
        for i in range(cfg.n_layers):
            p = layers[i] if per_layer else layer_params(layers, i)
            x = L.attention_decode(
                p["attn"], aspec, x, cache["k"][i], cache["v"][i], pos, window=windows[i], quant=cfg.quant,
                cache_k_scale=cache["k_scale"][i] if kv_int8 else None,
                cache_v_scale=cache["v_scale"][i] if kv_int8 else None,
            )
            if cfg.family == "encdec":
                px = layer_params(params["xattn_layers"], i)
                B, se = cache["enc_k"].shape[1:3]
                ekv = (cache["enc_k"][i].reshape(B, se, cfg.kv_heads, cfg.hd),
                       cache["enc_v"][i].reshape(B, se, cfg.kv_heads, cfg.hd))
                x = L.cross_attention(px["xattn"], aspec, x, ekv, quant=cfg.quant)
            if cfg.is_moe:
                x = X.moe_apply(p["moe"], cfg.moe_spec(), x)
            else:
                x = L.mlp(p["mlp"], cfg.mlp_spec(), x, quant=cfg.quant)
    else:
        convs: list[torch.Tensor] = []
        if cfg.family == "ssm":
            x = _ssm_layers(layers, cfg, cache, x, 0, cfg.n_layers, convs)
        else:  # hybrid
            shared, start = params["shared_attn"], 0
            for seg in _hybrid_segments(cfg):
                x = _ssm_layers(layers, cfg, cache, x, start, seg, convs)
                start += seg
                x = L.attention_decode(shared["attn"], aspec, x, cache["k"][0], cache["v"][0], pos,
                                       quant=cfg.quant)
                x = L.mlp(shared["mlp"], cfg.mlp_spec(), x, quant=cfg.quant)
        if convs[0].dtype != cache["conv"].dtype:
            cache["conv"] = torch.stack(convs)
    return head_paged(params, cfg, x, head=head), cache


def encode_for_decode(params: dict, cfg: ModelConfig, enc_embeds: torch.Tensor) -> dict:
    """The encoder stack over ``enc_embeds [B, Se, d]`` (bidirectional
    attention, then the MLP, a layer), then each decoder layer's cross K/V
    through ``dense``: ``{"enc_k", "enc_v"}`` ``[L, B, Se, G*hd]`` in
    ``cfg.dtype``, for :func:`init_cache`'s entries (whisper's serve path;
    its audio frontend is the reference's stub: the frame embeddings are
    given).  As the reference's, the cross K/V projections are called with
    no QAT config."""
    if cfg.family != "encdec":
        raise ValueError(f"encode_for_decode needs an encdec config, not {cfg.family!r}")
    B, Se, _ = enc_embeds.shape
    enc = enc_embeds.to(cfg.dtype)
    enc_pos = torch.arange(Se, dtype=torch.int32, device=enc.device)[None].expand(B, Se)
    for i in range(cfg.enc_layers):
        p = layer_params(params["enc_layers"], i)
        h = L.attention_train(p["attn"], cfg.attn_spec(), enc, enc_pos, window=-1)
        enc = L.mlp(p["mlp"], cfg.mlp_spec(), h, quant=cfg.quant)
    D = cfg.kv_heads * cfg.hd
    eks, evs = [], []
    for i in range(cfg.n_layers):
        px = layer_params(params["xattn_layers"], i)["xattn"]
        eks.append(L.dense(px["wk"], enc).reshape(B, Se, D))
        evs.append(L.dense(px["wv"], enc).reshape(B, Se, D))
    return {"enc_k": torch.stack(eks), "enc_v": torch.stack(evs)}
