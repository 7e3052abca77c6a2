"""The train and prefill steps (``repro.launch.steps``), one device.

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

The reference's ``ShardingRules`` (``rules``), its shape-only dry-run
helpers and ``make_serve_step`` need the mesh (ROADMAP.md, port queue
item 5): ``rules`` must be ``None``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import transformer as T
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.compression import compress_tree


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


def _one_device(rules) -> None:
    if rules is not None:
        raise NotImplementedError("sharding rules need the mesh, which waits for ROADMAP.md's port queue "
                                  "item 5; the port's steps run on one device (rules=None)")


def make_train_step(cfg: T.ModelConfig, rules=None, step_cfg: TrainStepConfig = TrainStepConfig()) -> Callable:
    _one_device(rules)
    opt = AdamW(
        lr=step_cfg.lr,
        grad_clip_norm=step_cfg.grad_clip,
        weight_decay=0.01,
        moment_dtype=torch.bfloat16 if step_cfg.moment_dtype == "bf16" else None,
    )

    def loss_fn(p, micro):
        if step_cfg.param_dtype == "bf16":
            p = tree_map(lambda a: a.to(torch.bfloat16) if a.dtype == torch.float32 else a, p)
        return T.forward_train(p, cfg, micro)

    def train_step(params, opt_state, batch):
        n_micro = step_cfg.n_micro
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        views = _layer_views(params)
        rows = next(iter(batch.values())).shape[0] // n_micro
        losses = []
        for i in range(n_micro):
            loss = loss_fn(views, {k: a[i * rows:(i + 1) * rows] for k, a in batch.items()})
            loss.backward()  # accumulates into .grad
            losses.append(loss.detach())
        with torch.no_grad():
            for p in leaves:
                if p.grad is None:  # a param the loss does not reach: a zero gradient, as jax.grad's
                    p.grad = torch.zeros_like(p)
                elif n_micro > 1:
                    p.grad.div_(n_micro)
            loss = torch.mean(torch.stack(losses))
            grads = tree_map(lambda p: p.grad, params)
            if step_cfg.compress_grads != "none":
                grads = compress_tree(grads, method=step_cfg.compress_grads)
            new_params, new_opt = opt.update(grads, opt_state, params)
        for p in leaves:
            p.grad = None
        return loss, new_params, new_opt

    train_step.optimizer = opt  # exposed for init
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


def _view(stacked: torch.Tensor, i: int) -> torch.Tensor:
    v = stacked[i].detach().requires_grad_(True)

    def into_stacked(v: torch.Tensor) -> None:
        if stacked.grad is None:
            stacked.grad = torch.zeros_like(stacked)
        stacked.grad[i].add_(v.grad)
        v.grad = None

    v.register_post_accumulate_grad_hook(into_stacked)
    return v


def make_prefill_step(cfg: T.ModelConfig, rules=None) -> Callable:
    """Inference prefill: the teacher-forced loss over the prompt, no backward."""
    _one_device(rules)

    @torch.no_grad()
    def prefill_step(params, batch):
        return T.forward_train(params, cfg, batch)

    return prefill_step
