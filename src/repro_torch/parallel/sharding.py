"""Logical-axis sharding rules and tensor-parallel shards
(``repro.parallel.sharding``).

The training half: model code reads the active :class:`ShardingRules`
(:func:`use_rules`, :func:`current_rules`), which map logical axes to the
mesh's ``data`` and ``model`` axes; :func:`spec_for_param_path` and
:func:`param_shardings` give each parameter its partition spec by tree
path, as the reference's do (tensor parallelism over ``model``, ZeRO
parameter sharding over ``data`` with ``fsdp="data"``), and
:func:`regather_layer_params` is the ZeRO-3 gather of one layer's weights.
A spec is the port's :class:`P`, a tuple with one entry a dimension.
Outside a mesh the rules are inactive and :func:`shard` is a no-op; under
one it is a no-op too, since the per-rank parts of a
:class:`~repro_torch.launch.mesh.Sharded` leaf fix the layout.

The serving half: a model rank runs the paged decode path on a
*contiguous rank-order slice* of every sharded matrix: ``wq``/``wk``/
``wv``/``w_up``/``w_gate``/``in_z``/``in_xbc``/``in_dt`` column-parallel,
``wo``/``w_down``/``out_proj`` row-parallel, MoE experts on the expert
axis, the LM head on vocab rows.  Contiguity is what makes a shard
quantized and packed against the global normalizer equal a slice of the
global prepack, and keeps KV-head and SSM head groups adjacent in their
state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any

import torch

from repro_torch.kernels.packed_matmul.ops import PackedDenseParams
from repro_torch.launch import mesh as LM


class P(tuple):
    """A partition spec (the reference's ``jax.sharding.PartitionSpec``):
    one entry a dimension, a mesh axis name, a tuple of them, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    batch: Any = ("pod", "data")
    heads: Any = "model"
    kv_heads: Any = "model"
    ff: Any = "model"
    vocab: Any = "model"
    experts: Any = "model"
    seq_mp: Any = "model"
    fsdp: Any = None  # "data" for ZeRO parameter sharding
    enabled: bool = True
    mesh: Any = None  # a repro_torch.launch.mesh.Mesh

    def resolve(self, *logical: str | None) -> P:
        return P(*(None if name is None else getattr(self, name) for name in logical))


_state = threading.local()


def current_rules() -> ShardingRules | None:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def mesh_rules(rules) -> ShardingRules | None:
    """``rules`` when they run the mesh path (enabled, with a mesh), None
    when the one-device path runs (None, disabled, or no mesh)."""
    if rules is None:
        return None
    if not isinstance(rules, ShardingRules):
        raise TypeError(f"rules must be a ShardingRules or None, not {type(rules).__name__}")
    return rules if rules.enabled and rules.mesh is not None else None


def shard(x, *logical: str | None):
    """Annotate ``x`` with logical axes: a no-op (inactive rules, or the
    layout already fixed by a sharded leaf's parts)."""
    return x


def spec(*logical: str | None) -> P:
    """The partition spec of logical axes under the active rules (``P()``
    when inactive)."""
    rules = current_rules()
    if rules is None or not rules.enabled:
        return P()
    return rules.resolve(*logical)


def spec_for_param_path(path: str, rules: ShardingRules, ndim: int) -> P:
    mp, dp = rules.heads, rules.fsdp  # tensor-parallel axis, optional ZeRO axis
    if "embed" in path:
        return P(rules.vocab, dp)
    if re.search(r"(wq|wk|wv)/w", path):
        base = (dp, mp)
    elif "wo/w" in path:
        base = (mp, dp)
    elif re.search(r"(w_up|w_gate)/w$", path):  # dense MLP [d, ff]
        base = (dp, mp)
    elif path.endswith("w_down/w"):
        base = (mp, dp)
    elif re.search(r"(w_up|w_gate)$", path):  # MoE [E, d, f]
        base = (rules.experts, dp, None)
    elif path.endswith("w_down"):
        base = (rules.experts, None, dp)
    elif re.search(r"(in_z|in_xbc)/w", path):
        base = (dp, mp)
    elif "in_dt/w" in path:
        base = (dp, None)  # the small dt head: its output dim replicated
    elif "out_proj/w" in path:
        base = (mp, dp)
    elif "router" in path:
        base = (None, None)
    else:
        return P(*([None] * ndim))  # norms, conv, biases: replicated
    pad = ndim - len(base)  # stacked layer params carry a leading L axis
    return P(*([None] * pad), *base)


def _map_with_path(tree, fn, path: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_with_path(v, fn, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(params_shape, rules: ShardingRules):
    """Each leaf's spec by its path (``layers/attn/wq/w``), from its
    number of dimensions; leaves may be tensors, sharded leaves or
    anything with a ``shape``."""
    return _map_with_path(params_shape, lambda path, leaf: spec_for_param_path(path, rules, len(leaf.shape)))


def _tp_check(n: int, mp: int, what: str) -> None:
    if n % mp != 0:
        raise ValueError(f"tensor parallelism: {what} ({n}) must divide by mp={mp}")


def _w_cols(leaf, start: int, size: int):
    """Column (output) slice of a dense weight: a float tensor or an int8
    serving dict ``{"levels", "scale"}`` (per-column scales slice exactly)."""
    if isinstance(leaf, dict):
        return {"levels": leaf["levels"][..., start:start + size],
                "scale": leaf["scale"][..., start:start + size]}
    return leaf[..., start:start + size]


def _w_rows(leaf, start: int, size: int):
    """Row (input) slice of a dense weight; int8 per-column scales stay whole."""
    if isinstance(leaf, dict):
        return {"levels": leaf["levels"][..., start:start + size, :], "scale": leaf["scale"]}
    return leaf[..., start:start + size, :]


def _w_col_concat(leaf, ranges: list[tuple[int, int]]):
    """Several column ranges concatenated (SSM ``in_xbc``: the local x part
    and the whole B and C parts)."""
    def cat(a):
        return torch.cat([a[..., s:s + n] for s, n in ranges], dim=-1)

    if isinstance(leaf, dict):
        return {"levels": cat(leaf["levels"]), "scale": cat(leaf["scale"])}
    return cat(leaf)


def _experts(leaf, start: int, size: int):
    """Experts ``start .. start + size - 1`` of a stacked ``[L, E, d, f]``
    expert tensor, float or an int8 serving dict (its per-expert,
    per-column scales slice with the levels; the reference's slice takes
    float tensors only)."""
    if isinstance(leaf, dict):
        return {k: v[:, start:start + size] for k, v in leaf.items()}
    return leaf[:, start:start + size]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def slice_decode_params(params: dict, cfg, mp: int, rank: int) -> dict:
    """Rank ``rank``'s tensor-parallel slice of a decode params tree.

    ``cfg`` is the *global* ModelConfig (``tp_shards == 1``); ``params``
    holds float or int8-dict weights with stacked ``[L, ...]`` layers
    (prepacked leaves raise: a mesh slices first, then packs each shard
    against the global normalizer).  The slice carries the whole ``embed``
    (the replicated token lookup) and a ``head_embed`` vocab-row slice for
    the float LM head; its tensors are views of ``params`` where a slice
    is contiguous in memory order, copies only for ``in_xbc`` and the conv."""
    if any(isinstance(leaf, PackedDenseParams) for leaf in _leaves(params)):
        raise ValueError("slice_decode_params needs unpacked weights: slice per shard "
                         "first, then prepack with the global t_max")
    if cfg.family not in ("attn", "ssm"):
        raise NotImplementedError(f"tensor-parallel serving supports attn/ssm families, not {cfg.family!r}")
    if isinstance(params["layers"], (list, tuple)):
        raise ValueError("slice_decode_params needs stacked [L, ...] layers, not a per-layer list")
    vocab = params["embed"].shape[0]
    _tp_check(vocab, mp, "vocab")
    vs = vocab // mp
    out = {"embed": params["embed"], "final_ln": params["final_ln"],
           "head_embed": params["embed"][rank * vs:(rank + 1) * vs]}
    lp = params["layers"]
    if cfg.family == "attn":
        _tp_check(cfg.n_heads, mp, "n_heads")
        _tp_check(cfg.kv_heads, mp, "kv_heads")
        q_loc = cfg.n_heads // mp * cfg.hd
        kv_loc = cfg.kv_heads // mp * cfg.hd
        a = lp["attn"]
        block = {"attn": {
            "ln": a["ln"],
            "wq": {"w": _w_cols(a["wq"]["w"], rank * q_loc, q_loc)},
            "wk": {"w": _w_cols(a["wk"]["w"], rank * kv_loc, kv_loc)},
            "wv": {"w": _w_cols(a["wv"]["w"], rank * kv_loc, kv_loc)},
            "wo": {"w": _w_rows(a["wo"]["w"], rank * q_loc, q_loc)},
        }}
        if cfg.is_moe:
            _tp_check(cfg.n_experts, mp, "n_experts")
            e_loc = cfg.n_experts // mp
            m = lp["moe"]
            moe = {"router": m["router"], "ln": m["ln"]}
            for k in ("w_up", "w_down", "w_gate"):
                if k in m:  # stacked [L, E, d, f]: experts shard on the E axis
                    moe[k] = _experts(m[k], rank * e_loc, e_loc)
            block["moe"] = moe
        else:
            _tp_check(cfg.d_ff, mp, "d_ff")
            f_loc = cfg.d_ff // mp
            m = lp["mlp"]
            mlp = {"ln": m["ln"],
                   "w_up": {"w": _w_cols(m["w_up"]["w"], rank * f_loc, f_loc)},
                   "w_down": {"w": _w_rows(m["w_down"]["w"], rank * f_loc, f_loc)}}
            if "w_gate" in m:
                mlp["w_gate"] = {"w": _w_cols(m["w_gate"]["w"], rank * f_loc, f_loc)}
            block["mlp"] = mlp
        out["layers"] = block
        return out
    # ssm: heads shard contiguously; the B and C columns feed every head (replicated)
    H, P_ = cfg.ssm_spec().n_heads, cfg.ssm_spec().head_dim
    _tp_check(H, mp, "ssm heads")
    di_loc = H // mp * P_
    x0 = rank * di_loc
    storage = dict(lp, in_z={"w": _w_cols(lp["in_z"]["w"], x0, di_loc)},
                   out_proj={"w": _w_rows(lp["out_proj"]["w"], x0, di_loc)})
    out["layers"] = ssm_compute_shard(storage, lp["in_xbc"]["w"], cfg, mp, rank)
    return out


def ssm_compute_shard(storage: dict, in_xbc: torch.Tensor, cfg, mp: int, rank: int) -> dict:
    """Rank ``rank``'s compute shard of one mamba layer from its storage
    (``param_shardings``'s layout, gathered over the fsdp axis):
    ``in_z`` and ``out_proj`` are stored as the rank's head group already;
    ``in_xbc`` is stored column-sharded over the ranks without regard to
    its x, B and C parts, so the rank takes its x part and the whole B and
    C from ``in_xbc``, the whole matrix (gathered over the model axis);
    the replicated ``in_dt``, conv, ``a_log``, ``dt_bias``, ``d_skip`` and
    ``out_norm`` are cut to the rank's heads.  ``cfg`` is the global
    config; the values equal :func:`slice_decode_params`'s."""
    sspec = cfg.ssm_spec()
    P_, N, d_in = sspec.head_dim, sspec.d_state, sspec.d_inner
    h_loc = sspec.n_heads // mp
    di_loc = h_loc * P_
    x0 = rank * di_loc
    ranges = [(x0, di_loc), (d_in, N), (d_in + N, N)]
    heads = slice(rank * h_loc, (rank + 1) * h_loc)
    return {
        "ln": storage["ln"],
        "in_z": storage["in_z"],
        "in_xbc": {"w": _w_col_concat(in_xbc, ranges)},
        "in_dt": {"w": _w_cols(storage["in_dt"]["w"], rank * h_loc, h_loc)},
        "conv_w": _w_col_concat(storage["conv_w"], ranges),
        "conv_b": _w_col_concat(storage["conv_b"], ranges),
        "a_log": storage["a_log"][..., heads],
        "dt_bias": storage["dt_bias"][..., heads],
        "d_skip": storage["d_skip"][..., heads],
        "out_norm": {"g": storage["out_norm"]["g"][..., x0:x0 + di_loc]},
        "out_proj": storage["out_proj"],
    }


def rank_trees(tree, replica: int, mp: int) -> list:
    """Replica ``replica``'s ``mp`` per-rank trees of a tree of
    :class:`~repro_torch.launch.mesh.Sharded` leaves (each leaf's part of
    that rank), in rank order."""
    return [_map(tree, lambda a, r=r: a.part(replica, r) if isinstance(a, LM.Sharded) else a) for r in range(mp)]


def _zip_map(fn, trees: list):
    """``fn(leaves)`` over the leaves of same-structured trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_map(fn, [t[i] for t in trees]) for i in range(len(first)))
    return fn(trees)


def stack_decode_shards(shards: list):
    """Per-rank trees stacked on a new leading ``[mp]`` axis (the
    reference's layout for its ``shard_map`` step).  Packed leaves stack
    their words; their metadata must be the same on every rank, which the
    global-normalizer prepack guarantees."""
    def stack(leaves):
        first = leaves[0]
        if isinstance(first, PackedDenseParams):
            meta = dataclasses.replace(first, w_packed=None, w_lvl=None)
            if any(dataclasses.replace(p, w_packed=None, w_lvl=None) != meta for p in leaves):
                raise ValueError("shards must share their packing metadata")
            return first._with(torch.stack([p.data for p in leaves]))
        if first is None:
            return None
        return torch.stack(leaves)

    return _zip_map(stack, shards)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def unstack_decode_shards(shards, mp: int) -> list:
    """A shard set as a list of per-rank trees: a list as it is, a
    ``[mp]``-stacked tree (:func:`stack_decode_shards`, or the reference's
    carried across) indexed rank by rank."""
    if isinstance(shards, (list, tuple)):
        if len(shards) != mp:
            raise ValueError(f"{len(shards)} shards for mp={mp}")
        return list(shards)

    def rank_of(r):
        return lambda a: (a.layer(r) if isinstance(a, PackedDenseParams)
                          else None if a is None else a[r])

    return [_map(shards, rank_of(r)) for r in range(mp)]


def regather_layer_params(layer_params, rules: ShardingRules | None):
    """The ZeRO-3 gather point: a layer's sharded weights gathered over the
    fsdp axis (:func:`~repro_torch.launch.mesh.gather_axis`, one copy a
    device), called inside the layer loop so each layer's are gathered
    when it runs and freed after it (recomputed in the backward under
    remat).  A no-op without a mesh or ZeRO sharding."""
    if mesh_rules(rules) is None or rules.fsdp is None:
        return layer_params
    return _map(layer_params, lambda a: LM.gather_axis(a, rules.fsdp) if isinstance(a, LM.Sharded) else a)
