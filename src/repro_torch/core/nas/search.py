"""The NAS search and the QAT fine-tune (§V + §VII-C; ``repro.core.nas.search``).

``search`` trains the super-net weights and architecture logits jointly
against Loss_acc + eta * Loss_comp (Eq. 9) and returns the argmax
bit-width selection plus its Eq.-6 DSP-operation count.  ``finetune``
then trains the selected fixed mixed-precision model (standard QAT).

Both run eagerly on ``device`` (the card unless the caller names the
CPU): the data is made on the host, moved to the device once, and each
batch indexes it there.  A step synchronises with the host only where it
writes a ``history`` row (the reference's cadence: every ``steps // 10``
steps and the last).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.core.nas import supernet
from repro_torch.core.packing import PackingLUT
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.models import convnets
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_map


@dataclasses.dataclass
class SearchResult:
    bits: list[tuple[int, int]]
    op_dsp: float
    final_task_loss: float
    final_metric: float
    history: list[dict]
    alphas: dict
    params: dict


def _dataset(spec: convnets.ConvNetSpec, seed: int, n: int, device: torch.device):
    if spec.head == "classify":
        data, labels = synthetic.classification_set(seed, n, hw=spec.in_hw[0])
    else:
        data, labels = synthetic.detection_set(seed, n, hw=spec.in_hw)
    return data.to(device), labels.to(device)


def _metric(spec, pred, labels):
    if spec.head == "classify":
        return convnets.accuracy(pred, labels)
    return convnets.iou(pred, labels)


def _trainable(tree: dict) -> dict:
    """A copy of ``tree`` whose leaves require gradients (AdamW writes
    them in place; the caller's tensors stay as they were)."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)


def search(
    spec: convnets.ConvNetSpec,
    luts: Mapping[int, PackingLUT],
    *,
    eta: float = 0.1,
    proxy: str = "dsp",
    steps: int = 200,
    batch: int = 32,
    n_data: int = 512,
    seed: int = 0,
    space: supernet.SearchSpace = supernet.SearchSpace(),
    device: str | torch.device = "cuda",
) -> SearchResult:
    dev = resolve_device(device)
    params = _trainable(convnets.init_params(seed, spec, device=dev))
    alphas = _trainable(supernet.init_alphas(spec, space, device=dev))
    tables = supernet.t_mul_tables(spec, luts, space, device=dev)
    ops = supernet.op_muls(spec, device=dev)
    data, labels = _dataset(spec, seed, n_data, dev)

    opt_w = AdamW(lr=2e-3, grad_clip_norm=5.0)
    opt_a = AdamW(lr=5e-2)
    state_w = opt_w.init(params)
    state_a = opt_a.init(alphas)

    def step(x, y):
        nonlocal state_w, state_a
        pred = supernet.supernet_apply(params, alphas, spec, x, space)
        acc = convnets.task_loss(pred, y, spec.head)
        comp = supernet.complexity_loss(
            alphas, tables, ops, proxy=proxy, bit_choices=space.bit_choices
        )
        loss = acc + eta * comp
        loss.backward()
        _, state_w = opt_w.update(_take_grads(params), state_w, params)
        _, state_a = opt_a.update(_take_grads(alphas), state_a, alphas)
        return loss.detach(), acc.detach(), comp.detach()

    history = []
    it = synthetic.batches(data, labels, batch, seed=seed, epochs=10_000)
    for i in range(steps):
        x, y = next(it)
        loss, acc, comp = step(x, y)
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            history.append(
                {"step": i, "loss": float(loss), "task": float(acc), "comp": float(comp)}
            )

    params, alphas = _detached(params), _detached(alphas)
    bits = supernet.select_bits(alphas, space)
    with torch.no_grad():
        pred = supernet.supernet_apply(params, alphas, spec, data[:128], space)
        metric = float(_metric(spec, pred, labels[:128]))
        final_task_loss = float(convnets.task_loss(pred, labels[:128], spec.head))
    return SearchResult(
        bits=bits,
        op_dsp=supernet.op_dsp(spec, bits, luts),
        final_task_loss=final_task_loss,
        final_metric=metric,
        history=history,
        alphas=alphas,
        params=params,
    )


def _take_grads(tree: dict) -> dict:
    """The gradients ``backward`` left on ``tree``'s leaves, cleared there;
    zeros for a leaf the loss does not reach (the first layer's activation
    logits: its input is never quantized), as ``jax.grad`` gives."""

    def take(t):
        g, t.grad = t.grad, None
        return torch.zeros_like(t) if g is None else g

    return tree_map(take, tree)


def _detached(tree: dict) -> dict:
    return tree_map(lambda t: t.detach(), tree)


def finetune(
    spec: convnets.ConvNetSpec,
    bits: list[tuple[int, int]],
    *,
    steps: int = 300,
    batch: int = 32,
    n_data: int = 512,
    seed: int = 0,
    params: dict | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """QAT fine-tune of a fixed mixed-precision assignment; returns metrics.
    ``params`` (if given) is copied, not trained in place."""
    dev = resolve_device(device)
    params = params if params is not None else convnets.init_params(seed + 1, spec, device=dev)
    params = _trainable(tree_map(lambda t: t.to(dev), params))
    data, labels = _dataset(spec, seed, n_data, dev)
    opt = AdamW(lr=2e-3, grad_clip_norm=5.0)
    state = opt.init(params)

    it = synthetic.batches(data, labels, batch, seed=seed, epochs=10_000)
    loss = torch.tensor(float("inf"))
    for i in range(steps):
        x, y = next(it)
        pred = convnets.apply(params, spec, x, bits=bits)
        loss = convnets.task_loss(pred, y, spec.head)
        loss.backward()
        _, state = opt.update(_take_grads(params), state, params)
        loss = loss.detach()

    params = _detached(params)
    test_x, test_y = _dataset(spec, seed + 7, 256, dev)
    with torch.no_grad():
        pred = convnets.apply(params, spec, test_x, bits=bits)
        return {
            "params": params,
            "train_loss": float(loss),
            "test_loss": float(convnets.task_loss(pred, test_y, spec.head)),
            "metric": float(_metric(spec, pred, test_y)),
        }
