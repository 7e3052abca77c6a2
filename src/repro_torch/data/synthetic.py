"""Deterministic synthetic datasets (``repro.data.synthetic``).

DAC-SDC and CIFAR-10 are not available offline; these stand-ins preserve
the *shape* of the learning problems (single-object detection scored by
IOU; 10-way classification scored by top-1) so NAS/QAT trends are
meaningful, and they are fully deterministic given a seed.

The data is made on the host with numpy, from the reference's
``default_rng(seed)`` draws in the reference's order, and returned as
CPU tensors in the port's NCHW layout (the reference's images are NHWC).
Labels and ``detection_set``'s images equal the reference's bit for bit.
``classification_set`` upsamples its templates as ``jax.image.resize(...,
"bilinear")`` does: the triangle kernel's normalised weights per axis,
contracted over H then W in float32, H's products fused into the sum (a
fused multiply-add), W's rounded first, as XLA's CPU dots compute them.
That equals the reference bit for bit at ``hw`` up to 48 and within 1e-6
above (XLA's dot changes its inner loop with the size).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


def _triangle_weights(m: int, n: int) -> np.ndarray:
    """[m, n] float32 weights of the bilinear resize from ``m`` to ``n``
    samples (``jax.image.scale.compute_weight_mat``, no translation)."""
    inv_scale = np.float32(1.0 / (n / m))
    sample = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def _resize_axis(x: np.ndarray, w: np.ndarray, axis: int, fused: bool) -> np.ndarray:
    """Contract ``axis`` of float32 ``x`` with ``w`` [m, n], summing the
    products in order in float32; ``fused`` adds each exact product (float64)
    before one rounding, else rounds the product first."""
    x = np.moveaxis(x, axis, -1)
    acc = np.zeros(x.shape[:-1] + (w.shape[1],), np.float32)
    for k in range(w.shape[0]):
        prod = x[..., k:k + 1].astype(np.float64) * w[k].astype(np.float64)
        acc = (acc + (prod if fused else prod.astype(np.float32))).astype(np.float32)
    return np.moveaxis(acc, -1, axis)


def _bilinear_nhwc(base: np.ndarray, hw: int) -> np.ndarray:
    """``jax.image.resize(base, (n, hw, hw, c), "bilinear")`` for float32
    ``base`` [n, h, w, c], H contracted first."""
    wh = _triangle_weights(base.shape[1], hw)
    ww = _triangle_weights(base.shape[2], hw)
    return _resize_axis(_resize_axis(base, wh, 1, fused=True), ww, 2, fused=False)


def _nchw(images: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2)))


def classification_set(seed: int, n: int, hw: int = 32, classes: int = 10):
    """Class-conditional low-frequency templates + noise, labels 0..C-1:
    images [n, 3, hw, hw] float32, labels [n] int32."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(classes, 4, 4, 3)).astype(np.float32)
    templates = _bilinear_nhwc(base, hw)
    labels = rng.integers(0, classes, n).astype(np.int32)
    noise = rng.normal(scale=0.6, size=(n, hw, hw, 3)).astype(np.float32)
    images = templates[labels] + noise
    return _nchw(images), torch.from_numpy(labels)


def detection_set(seed: int, n: int, hw: tuple[int, int] = (32, 64)):
    """One bright rectangle on textured noise: images [n, 3, H, W] float32,
    labels [n, 4] = (cx, cy, w, h) in [0, 1]."""
    rng = np.random.default_rng(seed)
    H, W = hw
    images = rng.normal(scale=0.35, size=(n, H, W, 3)).astype(np.float32)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        bw = rng.uniform(0.15, 0.5)
        bh = rng.uniform(0.15, 0.5)
        cx = rng.uniform(bw / 2, 1 - bw / 2)
        cy = rng.uniform(bh / 2, 1 - bh / 2)
        x0, x1 = int((cx - bw / 2) * W), int((cx + bw / 2) * W)
        y0, y1 = int((cy - bh / 2) * H), int((cy + bh / 2) * H)
        color = rng.uniform(0.8, 1.4, size=3)
        images[i, y0:y1, x0:x1] += color
        boxes[i] = (cx, cy, bw, bh)
    return _nchw(images), torch.from_numpy(boxes)


def batches(data, labels, batch: int, *, seed: int = 0, epochs: int = 1) -> Iterator[tuple]:
    """The reference's batches: a ``permutation`` an epoch, the remainder
    dropped; each batch indexes ``data`` and ``labels`` on their device."""
    n = data.shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(data.device)
        for i in range(0, n - batch + 1, batch):
            idx = order[i : i + batch]
            yield data[idx], labels[idx]
