"""The train and prefill steps (``repro.launch.steps``), on one device or
a mesh.

:func:`make_train_step` returns ``train_step(params, opt_state, batch)
-> (loss, params, opt_state)``: micro-batched gradient accumulation
(activation memory bound by ``n_micro``), optional gradient compression,
the params optionally cast to bfloat16 inside the loss (``param_dtype``:
float32 masters, float32 gradients), and one :class:`AdamW` step.  The
micro-batches' gradients accumulate into each param's ``.grad`` (no
second gradient tree; a stacked layer leaf's rows as each layer's
backward ends, see :func:`_layer_views`) and are divided by ``n_micro``;
the optimizer
writes params and moments in place, so the returned params and moments
are the given tensors.  :func:`make_prefill_step` returns the
teacher-forced loss without a backward.

Under ``ShardingRules(mesh=...)`` (:mod:`repro_torch.parallel.sharding`)
the step is the mesh's: params and moments are trees of
:class:`~repro_torch.launch.mesh.Sharded` leaves laid out by
:func:`param_shardings` (:func:`~repro_torch.launch.mesh.shard_tree`),
the batch is whole (its rows split over the data replicas,
:func:`batch_shardings`), the forward runs every rank in lockstep
(:func:`~repro_torch.models.transformer.forward_train` under the rules),
autograd through the per-rank tensors leaves each part its gradient
(a ZeRO-gathered weight's backward scatters into its shards), and the
gradient sum over each leaf's replicated axes
(:func:`~repro_torch.launch.mesh.sum_replicated_grads`: the data axis, and
the model axis for leaves tensor parallelism does not split) precedes the
division, compression and update.  ``rules=None``,
``ShardingRules(enabled=False)`` or rules without a mesh run the one-device
step.  The reference's shape-only dry-run helpers, ``make_serve_step`` and
``cache_shardings`` wait for the dry run (ROADMAP.md, port queue 1,
item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.launch import mesh as LM
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, AdamWState
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.compression import compress_tree
from repro_torch.parallel import sharding as PS
from repro_torch.parallel.sharding import P, ShardingRules, param_shardings, use_rules

__all__ = ["TrainStepConfig", "batch_shardings", "make_prefill_step", "make_train_step", "param_shardings",
           "param_shardings_opt"]


def param_shardings_opt(opt_shape: Any, p_specs: Any) -> Any:
    """AdamWState(step, mu, nu): moments shard exactly like the params."""
    return AdamWState(step=P(), mu=p_specs, nu=p_specs)


def batch_shardings(cfg: T.ModelConfig, rules: ShardingRules) -> Any:
    spec = {"tokens": P(rules.batch, None), "labels": P(rules.batch, None)}
    if cfg.use_mrope:
        spec["positions"] = P(rules.batch, None, None)
    if cfg.family == "encdec":
        spec["enc_embeds"] = P(rules.batch, None, None)
    return spec


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    n_micro: int = 1
    lr: float = 3e-4
    grad_clip: float = 1.0
    compress_grads: str = "none"  # none | int8 | topk
    # "bf16": cast float32 params to bf16 at the top of the loss; the
    # optimizer keeps float32 masters.  "f32": the params as they are.
    param_dtype: str = "f32"
    # "bf16": store the Adam moments in bf16 (halves optimizer memory)
    moment_dtype: str = "f32"


def _sharded_leaves(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, LM.Sharded)]


def make_train_step(cfg: T.ModelConfig, rules=None, step_cfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    mesh_rules = PS.mesh_rules(rules)
    opt = AdamW(
        lr=step_cfg.lr,
        grad_clip_norm=step_cfg.grad_clip,
        weight_decay=0.01,
        moment_dtype=torch.bfloat16 if step_cfg.moment_dtype == "bf16" else None,
    )

    def to_bf16(a):
        if isinstance(a, LM.Sharded):
            return a.map(to_bf16)
        return a.to(torch.bfloat16) if a.dtype == torch.float32 else a

    def loss_fn(p, micro):
        if step_cfg.param_dtype == "bf16":
            p = tree_map(to_bf16, p)
        with use_rules(mesh_rules):
            return T.forward_train(p, cfg, micro)

    def loss_and_grads(params, batch):
        """The micro-batches' mean loss and the gradient tree (the given
        params' ``.grad``s, summed over replicated axes and divided by
        ``n_micro``; before compression)."""
        n_micro = step_cfg.n_micro
        leaves = [q for x in tree_leaves(params) for q in (x.parts if isinstance(x, LM.Sharded) else [x])]
        for q in leaves:
            q.requires_grad_(True)
            q.grad = None
        views = _layer_views(params)
        rows = next(iter(batch.values())).shape[0] // n_micro
        losses = []
        for i in range(n_micro):
            loss = loss_fn(views, {k: a[i * rows:(i + 1) * rows] for k, a in batch.items()})
            loss.backward()  # accumulates into .grad
            losses.append(loss.detach())
        with torch.no_grad():
            for q in leaves:
                if q.grad is None:  # a param the loss does not reach: a zero gradient, as jax.grad's
                    q.grad = torch.zeros_like(q)
            for x in _sharded_leaves(params):
                LM.sum_replicated_grads(x)
            if n_micro > 1:
                for q in leaves:
                    q.grad.div_(n_micro)
            loss = torch.mean(torch.stack(losses))
        grads = tree_map(lambda x: x.map(lambda q: q.grad) if isinstance(x, LM.Sharded) else x.grad, params)
        return loss, grads

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        with torch.no_grad():
            if step_cfg.compress_grads != "none":
                grads = compress_tree(grads, method=step_cfg.compress_grads)
            new_params, new_opt = opt.update(grads, opt_state, params)
        for x in tree_leaves(params):
            for q in x.parts if isinstance(x, LM.Sharded) else [x]:
                q.grad = None
        return loss, new_params, new_opt

    train_step.optimizer = opt  # exposed for init
    train_step.loss_and_grads = loss_and_grads
    return train_step


_STACKED = ("layers", "enc_layers", "xattn_layers")


def _layer_views(params: dict) -> dict:
    """``params`` with each stacked ``[L, ...]`` tree (``layers``,
    ``enc_layers``, ``xattn_layers``) as a list of per-layer dicts of leaf
    views.  A view's gradient is added into its row of the stacked leaf's
    ``.grad`` as soon as autograd accumulates it, and freed: the backward
    then holds no layer's gradient past that layer (an ``unbind`` of the
    stacked leaf would keep every layer's until the first layer's is done,
    11 GB for llama3.2-3b, before stacking them).  The sums are the same."""
    out = dict(params)
    for key in _STACKED:
        if key not in params or isinstance(params[key], (list, tuple)):
            continue
        n = tree_leaves(params[key])[0].shape[0]
        out[key] = [tree_map(lambda a, i=i: _view(a, i), params[key]) for i in range(n)]
    return out


def _view(stacked, i: int):
    if isinstance(stacked, LM.Sharded):  # each part's row, a view of its own
        return LM.Sharded([_view(q, i) for q in stacked.parts], stacked.spec[1:], stacked.mesh, stacked.shape[1:])
    return _tensor_view(stacked, i)


def _tensor_view(stacked: torch.Tensor, i: int) -> torch.Tensor:
    v = stacked[i].detach().requires_grad_(True)

    def into_stacked(v: torch.Tensor) -> None:
        if stacked.grad is None:
            stacked.grad = torch.zeros_like(stacked)
        stacked.grad[i].add_(v.grad)
        v.grad = None

    v.register_post_accumulate_grad_hook(into_stacked)
    return v


def make_prefill_step(cfg: T.ModelConfig, rules=None) -> Callable:
    """Inference prefill: the teacher-forced loss over the prompt, no
    backward (under mesh rules, on sharded params)."""
    mesh_rules = PS.mesh_rules(rules)

    @torch.no_grad()
    def prefill_step(params, batch):
        with use_rules(mesh_rules):
            return T.forward_train(params, cfg, batch)

    return prefill_step
