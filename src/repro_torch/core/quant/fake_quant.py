"""Integer-level decomposition of the DoReFa quantizers (the serving half
of ``repro.core.quant.fake_quant``; the QAT ``fake_quant_*`` functions
come with the training slice).

Weights: ``w_q = scale * (levels - zero_point)`` with levels in
``[0, 2**bits - 1]``.  Activations: clipped to [0, 1] and quantized to
unsigned levels.  ``torch.round`` rounds half to even, as ``jnp.round``.
"""
from __future__ import annotations

import torch


def weight_tanh_max(w: torch.Tensor) -> torch.Tensor:
    """The tanh-domain normalizer ``max|tanh(w)|``."""
    return torch.max(torch.abs(torch.tanh(w)))


def weight_to_int_levels(
    w: torch.Tensor, bits: int, *, t_max: torch.Tensor | float | None = None
) -> tuple[torch.Tensor, float, float]:
    """(levels int32, scale, zero_point) with ``w_q = scale * (levels - zero)``.

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
