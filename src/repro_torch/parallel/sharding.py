"""Tensor-parallel decode shards for mesh serving (the serving half of
``repro.parallel.sharding``).

A model rank runs the paged decode path on a *contiguous rank-order slice*
of every sharded matrix: ``wq``/``wk``/``wv``/``w_up``/``w_gate``/``in_z``/
``in_xbc``/``in_dt`` column-parallel, ``wo``/``w_down``/``out_proj``
row-parallel, MoE experts on the expert axis, the LM head on vocab rows.
Contiguity is what makes a shard quantized and packed against the global
normalizer equal a slice of the global prepack, and keeps KV-head and SSM
head groups adjacent in their state.

The training half (``ShardingRules``, ``spec_for_param_path``,
``param_shardings``, ``regather_layer_params``) waits for the training
slice of the mesh (ROADMAP.md, port queue item 5).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.packed_matmul.ops import PackedDenseParams


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
    sspec = cfg.ssm_spec()
    H, P, N = sspec.n_heads, sspec.head_dim, sspec.d_state
    d_in = sspec.d_inner
    _tp_check(H, mp, "ssm heads")
    h_loc = H // mp
    di_loc = h_loc * P
    x0 = rank * di_loc
    xbc_ranges = [(x0, di_loc), (d_in, N), (d_in + N, N)]
    heads = slice(rank * h_loc, (rank + 1) * h_loc)
    out["layers"] = {
        "ln": lp["ln"],
        "in_z": {"w": _w_cols(lp["in_z"]["w"], x0, di_loc)},
        "in_xbc": {"w": _w_col_concat(lp["in_xbc"]["w"], xbc_ranges)},
        "in_dt": {"w": _w_cols(lp["in_dt"]["w"], rank * h_loc, h_loc)},
        "conv_w": _w_col_concat(lp["conv_w"], xbc_ranges),
        "conv_b": _w_col_concat(lp["conv_b"], xbc_ranges),
        "a_log": lp["a_log"][..., heads],
        "dt_bias": lp["dt_bias"][..., heads],
        "d_skip": lp["d_skip"][..., heads],
        "out_norm": {"g": lp["out_norm"]["g"][..., x0:x0 + di_loc]},
        "out_proj": {"w": _w_rows(lp["out_proj"]["w"], x0, di_loc)},
    }
    return out


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
