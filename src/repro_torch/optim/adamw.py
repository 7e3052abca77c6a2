"""AdamW with schedules, clipping and accumulation (``repro.optim.adamw``).

Params, gradients and moments are trees (dicts, lists, tuples) of
tensors.  :meth:`AdamW.update` follows the reference's arithmetic (the
moments, bias corrections and update in float32, ``b ** step`` with
``step`` as a float32 tensor) but writes params and moments **in place**,
one leaf at a time under ``torch.no_grad``: at full width the largest
leaf (llama3.2-3b's stacked ``w_up``, 0.70 G elements) makes a
whole-tree float32 temporary about 3 GB a leaf, so only one leaf's
temporaries live at a time.  Leaves are visited in sorted-key order, as
``jax.tree.leaves`` visits a dict, so :func:`global_norm` sums in the
reference's order.

Sharded trees (:class:`~repro_torch.launch.mesh.Sharded` leaves, a
mesh's params): the moments are sharded as the params, every part is
updated in place on its own device, and :func:`global_norm` counts each
element once (one part a block), so a replicated leaf's copies add
nothing beyond the first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.launch.mesh import Sharded


def tree_leaves(tree: Any) -> list:
    """The tensors of a tree, dict keys in sorted order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float | None = None
    # storage dtype of the moments; bf16 halves optimizer memory, the
    # update still computes in float32
    moment_dtype: torch.dtype | None = None  # None => the param's dtype (float32 masters)

    def init(self, params: Any) -> AdamWState:
        def zeros(p):
            if isinstance(p, Sharded):
                return p.map(zeros)
            return torch.zeros(p.shape, dtype=self.moment_dtype or p.dtype, device=p.device)

        leaves = tree_leaves(params)
        first = leaves[0].parts[0] if leaves and isinstance(leaves[0], Sharded) else leaves[0] if leaves else None
        step = torch.zeros((), dtype=torch.int32, device=first.device if first is not None else None)
        return AdamWState(step=step, mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def _lr(self, step: torch.Tensor):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any) -> tuple[Any, AdamWState]:
        """One step; returns ``(params, state)``, the same param and moment
        tensors written in place (float32 gradients are scaled in place by
        the clip)."""
        scale = None
        if self.grad_clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-12), max=1.0)
        step = state.step + 1
        step_f = step.to(torch.float32)
        b1, b2 = (torch.tensor(b, dtype=torch.float32, device=step.device) for b in (self.b1, self.b2))
        mu_hat_scale = 1.0 / (1 - torch.pow(b1, step_f))
        nu_hat_scale = 1.0 / (1 - torch.pow(b2, step_f))
        lr = self._lr(step)
        for leaf in _part_leaves(params, grads, state.mu, state.nu):
            # a leaf past _SLICE elements goes in slices of its leading dim
            # of at most _SLICE elements (elementwise, so the same bits),
            # bounding the temporaries
            n = leaf[0].numel()
            consts = (scale, mu_hat_scale, nu_hat_scale, lr)
            if leaf[0].device != step.device:  # a mesh rank on another device
                consts = tuple(t.to(leaf[0].device) if isinstance(t, torch.Tensor) else t for t in consts)
            if n > _SLICE and leaf[0].dim() > 1:
                rows = max(1, _SLICE // (n // leaf[0].shape[0]))
                parts = zip(*(t.split(rows) for t in leaf))
            else:
                parts = [leaf]
            for p, g, m, v in parts:
                self._update_leaf(p, g, m, v, *consts)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)

    def _update_leaf(self, p, g, m, v, scale, mu_hat_scale, nu_hat_scale, lr) -> None:
        b1, b2 = self.b1, self.b2
        g32 = g.to(torch.float32)
        if scale is not None:
            g32.mul_(scale)  # a copy, or the caller's float32 gradient
        m.copy_((b1 * m.to(torch.float32)).add_(g32, alpha=1 - b1))
        v.copy_((b2 * v.to(torch.float32)).add_(torch.square(g32), alpha=1 - b2))
        del g32
        m32, v32 = m.to(torch.float32), v.to(torch.float32)  # the stored (rounded) moments
        u = (m32 * mu_hat_scale).div_(torch.sqrt(v32 * nu_hat_scale).add_(self.eps))
        del m32, v32
        p32 = p.to(torch.float32)
        u.add_(p32, alpha=self.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(u)
        else:
            p.copy_(p32 - u)


_SLICE = 1 << 26


def _part_leaves(*trees):
    """Matching leaves of same-structured trees, a sharded leaf's parts
    one by one (rank order)."""
    for leaf in zip(*(tree_leaves(t) for t in trees)):
        if isinstance(leaf[0], Sharded):
            yield from zip(*(x.parts for x in leaf))
        else:
            yield leaf


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, leaf by leaf (a
    sharded leaf's unique parts in rank order, on the first's device)."""
    total = None
    for x in tree_leaves(tree):
        for part in x.unique_parts() if isinstance(x, Sharded) else [x]:
            sq = torch.sum(torch.square(part.to(torch.float32)))
            total = sq if total is None else total + sq.to(total.device)
    return torch.sqrt(total)


def cosine_schedule(base_lr: float, warmup: int, total: int, floor: float = 0.0):
    def f(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / max(1.0, warmup)
        prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(step < warmup, warm, cos)

    return f


class GradAccumulator(NamedTuple):
    """Microbatch gradient accumulation (bounds activation memory)."""

    count: torch.Tensor
    acc: Any

    @classmethod
    def init(cls, params: Any) -> "GradAccumulator":
        return cls(torch.zeros((), dtype=torch.int32), tree_map(torch.zeros_like, params))

    def add(self, grads: Any) -> "GradAccumulator":
        return GradAccumulator(self.count + 1, tree_map(torch.add, self.acc, grads))

    def mean(self) -> Any:
        c = torch.clamp(self.count, min=1).to(torch.float32)
        return tree_map(lambda g: g / c, self.acc)
