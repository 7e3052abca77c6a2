"""The paper's evaluation convnets (UltraNet / SkyNet / VGG-Tiny) as
mixed-precision-first models (``repro.models.convnets``).

Every conv layer carries an explicit (w_bits, a_bits) pair; the same
``apply`` path serves the fixed-precision models, the QAT fine-tune, and
(through composite quantizers passed in by the NAS super-net) the
differentiable bit-width search.  BatchNorm is modeled folded
(per-channel scale+bias), which is how these DAC-SDC designs deploy.

PyTorch's layout throughout: activations NCHW, weights ``[cout,
cin/groups, k, k]`` (the reference's are NHWC and HWIO;
``repro_torch.bridge`` converts).  Convolutions pad as XLA's ``SAME``
does, and max-pooling is ``reduce_window`` over ``-inf``, ``VALID``:
``max_pool2d`` in floor mode.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.quant import fake_quant_act, fake_quant_weight
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One pipeline stage: conv (+folded BN, ReLU) with optional pooling."""

    cin: int
    cout: int
    kernel: int = 3
    stride: int = 1
    pool: int = 1  # max-pool window after the conv (1 = none)
    depthwise: bool = False
    act: bool = True


@dataclasses.dataclass(frozen=True)
class ConvNetSpec:
    name: str
    in_hw: tuple[int, int]
    in_ch: int
    layers: tuple[ConvSpec, ...]
    head: str  # "classify" (logits) or "detect" (4 box coords via grid head)
    num_out: int

    def op_mul(self, idx: int) -> int:
        """MAC count of layer ``idx`` (drives Eq. 6's Op_mul^l)."""
        h, w = self.in_hw
        for i, l in enumerate(self.layers[: idx + 1]):
            h, w = h // l.stride, w // l.stride
            if i < idx:
                h, w = h // l.pool, w // l.pool
        l = self.layers[idx]
        k2 = l.kernel * l.kernel
        cin = 1 if l.depthwise else l.cin
        return h * w * k2 * cin * l.cout


def ultranet(in_hw=(160, 320)) -> ConvNetSpec:
    """UltraNet (DAC-SDC'20 winner backbone): 4x pooled + 4x plain 3x3."""
    chans = [16, 32, 64, 64, 64, 64, 64, 64]
    layers, cin = [], 3
    for i, c in enumerate(chans):
        layers.append(ConvSpec(cin, c, kernel=3, pool=2 if i < 4 else 1))
        cin = c
    layers.append(ConvSpec(cin, 5, kernel=1, act=False))  # obj + 4 coords
    return ConvNetSpec("ultranet", in_hw, 3, tuple(layers), "detect", 5)


def skynet(in_hw=(160, 320)) -> ConvNetSpec:
    """SkyNet: stacked depthwise+pointwise bundles (MLSys'20)."""
    bundles = [(3, 48), (48, 96), (96, 192), (192, 384), (384, 512), (512, 96)]
    layers = []
    for i, (cin, cout) in enumerate(bundles):
        layers.append(ConvSpec(cin, cin, kernel=3, depthwise=True, pool=2 if i < 3 else 1))
        layers.append(ConvSpec(cin, cout, kernel=1))
    layers.append(ConvSpec(96, 5, kernel=1, act=False))
    return ConvNetSpec("skynet", in_hw, 3, tuple(layers), "detect", 5)


def vgg_tiny(in_hw=(32, 32)) -> ConvNetSpec:
    """VGG-alike 6 conv + 1 FC CIFAR-10 model from §VII-A."""
    chans = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256)]
    layers = [
        ConvSpec(cin, cout, kernel=3, pool=2 if i % 2 == 1 else 1)
        for i, (cin, cout) in enumerate(chans)
    ]
    layers.append(ConvSpec(256, 10, kernel=1, act=False))  # 1x1 head == FC after GAP
    return ConvNetSpec("vgg_tiny", in_hw, 3, tuple(layers), "classify", 10)


CONVNETS = {"ultranet": ultranet, "skynet": skynet, "vgg_tiny": vgg_tiny}


# ---------------------------------------------------------------------------
# Parameters and forward pass
# ---------------------------------------------------------------------------


def init_params(key: int, spec: ConvNetSpec, *, device: str | torch.device = "cuda") -> dict:
    """Seeded weights ``N(0, 1) / sqrt(fan_in)``, scales 1, biases 0.  ``key``
    seeds a ``torch.Generator`` on the host: the draws are not
    ``jax.random``'s (tests carry the reference's weights across)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(key)
    params = {}
    for i, l in enumerate(spec.layers):
        cin = 1 if l.depthwise else l.cin
        fan_in = l.kernel * l.kernel * cin
        w = torch.randn((l.cout, cin, l.kernel, l.kernel), generator=g) / math.sqrt(fan_in)
        params[f"layer{i}"] = {
            "w": w.to(dev),
            "scale": torch.ones((l.cout,), device=dev),
            "bias": torch.zeros((l.cout,), device=dev),
        }
    return params


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial axis: (low, high)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    (top, bottom), (left, right) = (_same_pads(x.shape[d], spec.kernel, spec.stride) for d in (2, 3))
    groups = spec.cin if spec.depthwise else 1
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=spec.stride, padding=(top, left), groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=spec.stride, groups=groups)


QuantFn = Callable[[torch.Tensor, int], torch.Tensor]


def apply(
    params: dict,
    spec: ConvNetSpec,
    x: torch.Tensor,
    bits: Sequence[tuple[int, int]] | None = None,
    *,
    quant_w: QuantFn = fake_quant_weight,
    quant_a: QuantFn = fake_quant_act,
) -> torch.Tensor:
    """Forward pass of NCHW ``x``.  ``bits[i] = (w_bits, a_bits)`` per
    layer; None = fp32.

    ``quant_w``/``quant_a`` are injection points: the NAS super-net passes
    composite (probability-weighted) quantizers here, so the exact same
    network definition is shared between search and deployment.
    """
    for i, l in enumerate(spec.layers):
        p = params[f"layer{i}"]
        w = p["w"]
        if bits is not None:
            wb, ab = bits[i]
            w = quant_w(w, wb)
            if i > 0:  # first layer input is raw pixels (paper keeps 8b+)
                x = quant_a(x, ab)
        x = _conv(x, w, l)
        x = x * p["scale"][:, None, None] + p["bias"][:, None, None]
        if l.act:
            x = F.relu(x)  # no gradient at 0, as jax.nn.relu
        if l.pool > 1:
            x = F.max_pool2d(x, l.pool, l.pool)
    if spec.head == "classify":
        return torch.mean(x, dim=(2, 3))  # GAP -> logits
    # detection head: per-cell (obj, cx, cy, w, h) over the grid in (h, w)
    # row-major order; decode soft-argmax box
    b = x.shape[0]
    obj = torch.softmax(x[:, 0].reshape(b, -1), dim=-1)
    coords = torch.sigmoid(x[:, 1:5]).permute(0, 2, 3, 1).reshape(b, -1, 4)
    return torch.einsum("bg,bgc->bc", obj, coords)  # [B, 4] normalized box


def task_loss(pred: torch.Tensor, labels: torch.Tensor, head: str) -> torch.Tensor:
    if head == "classify":
        logp = torch.log_softmax(pred, dim=-1)
        return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))
    return torch.mean(torch.square(pred - labels))  # box regression


def iou(pred_box: torch.Tensor, true_box: torch.Tensor) -> torch.Tensor:
    """Mean IOU of (cx, cy, w, h) normalized boxes (DAC-SDC metric)."""

    def corners(b):
        cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2

    ax0, ay0, ax1, ay1 = corners(pred_box)
    bx0, by0, bx1, by1 = corners(true_box)
    iw = torch.clamp(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0), min=0.0)
    ih = torch.clamp(torch.minimum(ay1, by1) - torch.maximum(ay0, by0), min=0.0)
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return torch.mean(inter / torch.clamp(union, min=1e-9))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
