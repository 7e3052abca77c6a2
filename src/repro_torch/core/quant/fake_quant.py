"""Fake-quantization (QAT) primitives and their integer-level
decomposition (``repro.core.quant.fake_quant``).

Weights follow the DoReFa transform (tanh-normalized, symmetric levels);
activations are clipped to [0, 1] and quantized to unsigned levels.
Straight-through estimators (STE) keep everything differentiable:
``ste_round`` is ``x + (round(x) - x).detach()``, the reference's
``stop_gradient`` form.  ``torch.round`` rounds half to even, as
``jnp.round``.

The serving half decomposes the same quantizers into unsigned integer
levels: weights ``w_q = scale * (levels - zero_point)`` with levels in
``[0, 2**bits - 1]``, activations ``x_q = scale * levels``.

Two gradients follow the reference's exactly, and a plain PyTorch
spelling would not: ``jnp.clip`` passes half the gradient at exactly 0
and 1 (a tie of its min/max), where ``torch.clamp`` passes all of it, so
:func:`fake_quant_act` clips with ``torch.maximum``/``torch.minimum``;
and ``jnp.max`` splits its gradient evenly among tied maxima, as the
full-reduction ``torch.max`` does.
"""
from __future__ import annotations

import torch


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() with identity gradient."""
    return x + (torch.round(x) - x).detach()


def quantize_unit(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Uniformly quantize values in [0, 1] to 2**bits levels (STE)."""
    n = (1 << bits) - 1
    return ste_round(x * n) / n


def fake_quant_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa-style weight quantizer: output in [-1, 1], 2**bits levels."""
    if bits >= 32:
        return w
    t = torch.tanh(w)
    t = t / (2.0 * torch.max(torch.abs(t)) + 1e-12) + 0.5  # -> [0, 1]
    return 2.0 * quantize_unit(t, bits) - 1.0


def fake_quant_act(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Activation quantizer: clip to [0, 1] then quantize (STE).  The clip
    is ``jnp.clip``'s min/max, half the gradient at either bound."""
    if bits >= 32:
        return x
    lo, hi = x.new_zeros(()), x.new_ones(())
    return quantize_unit(torch.minimum(torch.maximum(x, lo), hi), bits)


def weight_tanh_max(w: torch.Tensor) -> torch.Tensor:
    """The tanh-domain normalizer ``max|tanh(w)|``."""
    return torch.max(torch.abs(torch.tanh(w)))


def weight_to_int_levels(
    w: torch.Tensor, bits: int, *, t_max: torch.Tensor | float | None = None
) -> tuple[torch.Tensor, float, float]:
    """(levels int32, scale, zero_point) with ``w_q = scale * (levels - zero)``,
    matching :func:`fake_quant_weight`.

    ``t_max`` overrides the normalizer (tensor-parallel shards pass the
    whole matrix's value to get slice-exact levels)."""
    n = (1 << bits) - 1
    t = torch.tanh(w)
    if t_max is None:
        t_max = torch.max(torch.abs(t))
    t = t / (2.0 * t_max + 1e-12) + 0.5
    levels = torch.round(t * n).to(torch.int32)
    return levels, 2.0 / n, n / 2.0


def act_to_int_levels(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, float]:
    """Unsigned activation levels: ``x_q = scale * levels``."""
    n = (1 << bits) - 1
    levels = torch.round(torch.clamp(x, 0.0, 1.0) * n).to(torch.int32)
    return levels, 1.0 / n


def int_conv_equivalence(w_levels, a_levels, w_scale, w_zero, a_scale):
    """Reference identity used by tests: float conv of fake-quant tensors ==
    scale-folded integer conv of levels.

        (s_w (W - z_w)) * (s_a A) = s_w s_a (W*A - z_w * sum(A))
    """
    wa = w_levels.to(torch.int32), a_levels.to(torch.int32)
    return wa, w_scale * a_scale, w_zero
