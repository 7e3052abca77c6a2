"""Apply a deployment plan to real params: per-layer quantize + prepack
(``repro.plan.apply``).

Generalizes ``serving.api.quantize_params_packed`` from one global
``(w_bits, a_bits)`` pair to a per-layer map.  Uniform plans keep the
stacked ``[L, ...]`` layout: byte for byte the params of the global
path.  Heterogeneous plans unstack ``params["layers"]`` into the
per-layer list that ``transformer.forward_decode_paged`` walks (each
layer's packed metadata differs).  ``tp=(mp, rank)`` gives a mesh rank's
tensor-parallel shard, sliced first, then packed against the global
normalizers (:func:`_tp_tmax_tree`).
"""
from __future__ import annotations

import re

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.packed_matmul.ops import prepack_dense
from repro_torch.models import transformer as T
from repro_torch.models.layers import prepack_lm_head
from repro_torch.plan.plan import DeployPlan

# projection weights live at ".../<name>/w"; MoE expert tensors are bare
# [E, d, f] / [L, E, d, f] arrays (no /w leaf)
PROJ_WEIGHT_RE = r"(wq|wk|wv|wo|w_up|w_gate|w_down|in_z|in_xbc|out_proj)/w$"
MOE_WEIGHT_RE = r"(w_up|w_gate|w_down)$"


def map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over the leaves of a dict/list tree
    (``rest``: trees of the same structure); paths join keys with "/"."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), path=f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest), path=f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tanh_max_tree(tree):
    """Per-matrix tanh-domain normalizers for every leaf of a params
    subtree (leading stack axes kept: [L, K, N] -> [L]), for
    :func:`prepack_tree`'s ``t_max_tree``: a slice of a matrix packed
    against the whole matrix's normalizer gives column slices of the
    whole matrix's packed words."""

    def one(_, leaf):
        if getattr(leaf, "ndim", 0) < 2:
            return torch.zeros(())  # never consumed (non-projection leaf)
        return torch.amax(torch.abs(torch.tanh(leaf)), dim=(-2, -1))

    return map_with_path(one, tree)


def _tp_tmax_tree(global_layers, sliced_layers):
    """The ``t_max_tree`` of a tensor-parallel slice: projection weights
    take the *global* matrix's normalizer (their rows or columns were
    sliced); MoE expert tensors take the slice's own (experts are whole
    matrices sliced on the expert axis, so each expert's normalizer is
    unchanged)."""

    def one(path, g, s):
        leaf = s if re.search(MOE_WEIGHT_RE, path) and not path.endswith("/w") else g
        if getattr(leaf, "ndim", 0) < 2:
            return torch.zeros(())
        return torch.amax(torch.abs(torch.tanh(leaf)), dim=(-2, -1))

    return map_with_path(one, global_layers, sliced_layers)


def prepack_tree(tree, *, w_bits: int, a_bits: int, block_k: int | None = None,
                 skipped: list | None = None, t_max_tree=None,
                 device: str | torch.device = "cuda"):
    """Quantize + bit-pack every projection weight of a params subtree on
    ``device``.

    Projection matrices ([K, N] or stacked [L, K, N]) and MoE expert
    tensors ([E, d, f] or [L, E, d, f]) become ``PackedDenseParams``
    leaves.  Projection-shaped tensors left in float are appended to
    ``skipped``, so precision gaps stay visible.  ``t_max_tree`` (the
    structure of ``tree``) supplies per-matrix level normalizers
    (:func:`tanh_max_tree`)."""
    dev = resolve_device(device)

    def one(path, leaf, t_max=None):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        proj, moe = re.search(PROJ_WEIGHT_RE, path), re.search(MOE_WEIGHT_RE, path)
        if (proj and leaf.ndim in (2, 3)) or (moe and leaf.ndim in (3, 4)):
            return prepack_dense(leaf, w_bits=w_bits, a_bits=a_bits, block_k=block_k, t_max=t_max,
                                 device=dev)
        if (proj or moe) and leaf.ndim >= 2 and skipped is not None:
            skipped.append(path)
        return leaf

    if t_max_tree is None:
        return map_with_path(one, tree)
    return map_with_path(one, tree, t_max_tree)


def apply_plan(params: dict, cfg, plan: DeployPlan, *, verbose: bool = True, tp=None,
               device: str | torch.device = "cuda"):
    """Turn float params + a plan into serveable mixed-precision params on
    ``device``.

    Returns ``(new_params, packed_head)``; ``packed_head`` is None when the
    plan has no ``lm_head`` entry, otherwise the prepacked LM head
    (:func:`~repro_torch.models.layers.prepack_lm_head`) for the engine.
    The float ``embed`` stays (token lookups read it); only the head's
    matmul goes to the plan's bits.  Uniform plans keep the stacked
    layout, heterogeneous ones become a per-layer list.

    ``tp=(mp, rank)`` makes mesh rank ``rank``'s tensor-parallel shard:
    the weights are sliced first (:func:`~repro_torch.parallel.slice_decode_params`,
    contiguous rank order), then quantized and packed against the global
    normalizers, so the shard's packed words, the head's vocab slice
    included, equal slices of the single-device prepack."""
    plan.validate()
    if plan.family != cfg.family:
        raise ValueError(
            f"plan family {plan.family!r} does not match config family {cfg.family!r}"
        )
    if len(plan.layers) != cfg.n_layers:
        raise ValueError(
            f"plan has {len(plan.layers)} layers, config {cfg.name!r} has {cfg.n_layers}"
        )
    dev = resolve_device(device)
    global_layers, head_embed, head_tmax = params["layers"], params["embed"], None
    if tp is not None:
        from repro_torch.core.quant import weight_tanh_max
        from repro_torch.parallel.sharding import slice_decode_params

        mp, rank = tp
        head_tmax = weight_tanh_max(params["embed"])
        params = slice_decode_params(params, cfg, mp, rank)
        head_embed = params["head_embed"]
    skipped: list[str] = []
    out = dict(params)
    if plan.uniform:
        lp = plan.layers[0]
        out["layers"] = prepack_tree(
            params["layers"], w_bits=lp.w_bits, a_bits=lp.a_bits, block_k=lp.block_k, skipped=skipped,
            t_max_tree=None if tp is None else _tp_tmax_tree(global_layers, params["layers"]), device=dev)
    else:
        per_layer = T.unstack_layers(params, cfg.n_layers)["layers"]
        global_per_layer = T.unstack_layers({"layers": global_layers}, cfg.n_layers)["layers"]
        out["layers"] = [
            prepack_tree(layer, w_bits=lp.w_bits, a_bits=lp.a_bits, block_k=lp.block_k, skipped=skipped,
                         t_max_tree=None if tp is None else _tp_tmax_tree(g, layer), device=dev)
            for layer, g, lp in zip(per_layer, global_per_layer, plan.layers)
        ]
    head = None
    if plan.lm_head is not None:
        head = prepack_lm_head(head_embed, w_bits=plan.lm_head.w_bits, a_bits=plan.lm_head.a_bits,
                               t_max=head_tmax, device=dev)
    if skipped and verbose:
        uniq = sorted(set(skipped))
        print(f"apply_plan: {len(uniq)} projection tensors left in float: " + ", ".join(uniq))
    return out, head
