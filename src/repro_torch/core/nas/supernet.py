"""DSP-aware differentiable NAS super-net (DeepBurning-MixQ §V;
``repro.core.nas.supernet``).

Each quantizable layer gets architecture logits over candidate weight and
activation bit-widths.  Following EdMIPS's factorized formulation the
composite (probability-weighted) quantized weight/activation is formed
*before* the convolution, so the super-net costs one conv per layer
regardless of branch count:

    w_eff = sum_i softmax(alpha_w)_i * Q_{b_i}(w)
    x_eff = sum_j softmax(alpha_a)_j * Q_{b_j}(x)

The hardware loss is the paper's Eq. 6-8: expected total DSP operations,
with per-layer multiplication-throughput tables T_mul(w_b, a_b) taken
from the DSP Packing Optimizer's LUTs, instead of EdMIPS's bit-product
proxy (implemented here too, as the comparison baseline).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from repro_torch.core.packing import PackingLUT
from repro_torch.core.quant import fake_quant_act, fake_quant_weight
from repro_torch.device import resolve_device
from repro_torch.models import convnets


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    bit_choices: tuple[int, ...] = (2, 3, 4, 5, 6, 7, 8)

    @property
    def n(self) -> int:
        return len(self.bit_choices)


def init_alphas(
    spec: convnets.ConvNetSpec, space: SearchSpace, *, device: str | torch.device = "cuda"
) -> dict:
    """Uniform-initialized architecture logits per layer."""
    dev = resolve_device(device)
    return {
        f"layer{i}": {"w": torch.zeros((space.n,), device=dev), "a": torch.zeros((space.n,), device=dev)}
        for i in range(len(spec.layers))
    }


def t_mul_tables(
    spec: convnets.ConvNetSpec,
    luts: Mapping[int, PackingLUT],
    space: SearchSpace,
    *,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """[L, n_w, n_a] multiplication-throughput tables (Eq. 7's T_mul^l)."""
    rows = []
    for l in spec.layers:
        lut = luts[l.kernel if l.kernel in luts else max(luts)]
        rows.append(
            [[lut.t_mul(w, a) for a in space.bit_choices] for w in space.bit_choices]
        )
    return torch.tensor(rows, dtype=torch.float32, device=resolve_device(device))  # [L, n, n]


def op_muls(spec: convnets.ConvNetSpec, *, device: str | torch.device = "cuda") -> torch.Tensor:
    return torch.tensor([float(spec.op_mul(i)) for i in range(len(spec.layers))],
                        dtype=torch.float32, device=resolve_device(device))


def _composite(quant, alpha: torch.Tensor, v: torch.Tensor, space: SearchSpace) -> torch.Tensor:
    """``sum_i softmax(alpha)_i * quant(v, b_i)`` over the bit choices."""
    pi = torch.softmax(alpha, dim=-1)
    branches = torch.stack([quant(v, b) for b in space.bit_choices])
    return torch.tensordot(pi, branches, dims=1)


def supernet_apply(
    params: dict,
    alphas: dict,
    spec: convnets.ConvNetSpec,
    x: torch.Tensor,
    space: SearchSpace,
) -> torch.Tensor:
    """Forward with composite quantizers (shares convnets.apply exactly)."""

    def quant_w(w, layer_idx):
        return _composite(fake_quant_weight, alphas[f"layer{layer_idx}"]["w"], w, space)

    def quant_a(v, layer_idx):
        return _composite(fake_quant_act, alphas[f"layer{layer_idx}"]["a"], v, space)

    layer_ids = [(i, i) for i in range(len(spec.layers))]
    return convnets.apply(params, spec, x, bits=layer_ids, quant_w=quant_w, quant_a=quant_a)


def complexity_loss(
    alphas: dict,
    tables: torch.Tensor,
    ops: torch.Tensor,
    *,
    proxy: str = "dsp",
    bit_choices: Sequence[int] = (2, 3, 4, 5, 6, 7, 8),
) -> torch.Tensor:
    """Eq. 8 (``proxy='dsp'``) or the EdMIPS bit-product baseline.

    dsp:     sum_l Op^l / (pi_w^T T^l pi_a)      [expected DSP operations]
    edmips:  sum_l Op^l * E[w_bits] * E[a_bits]  [bit-product complexity]
    Both are normalized by sum_l Op^l so eta is comparable across models.
    """
    total = torch.sum(ops)
    loss = 0.0
    bits = torch.tensor(bit_choices, dtype=torch.float32, device=ops.device)
    for l in range(tables.shape[0]):
        a = alphas[f"layer{l}"]
        pi_w = torch.softmax(a["w"], dim=-1)
        pi_a = torch.softmax(a["a"], dim=-1)
        if proxy == "dsp":
            t_bar = pi_w @ tables[l] @ pi_a  # Eq. 7
            loss = loss + ops[l] / t_bar
        elif proxy == "edmips":
            loss = loss + ops[l] * (pi_w @ bits) * (pi_a @ bits)
        else:
            raise ValueError(proxy)
    return loss / total


def select_bits(alphas: dict, space: SearchSpace) -> list[tuple[int, int]]:
    """Paper's final step: per-layer argmax of the selection probability
    (the first index of a tie, as ``jnp.argmax``)."""
    out = []
    for i in range(len(alphas)):
        a = alphas[f"layer{i}"]
        out.append(
            (
                space.bit_choices[int(torch.argmax(a["w"]))],
                space.bit_choices[int(torch.argmax(a["a"]))],
            )
        )
    return out


def op_dsp(
    spec: convnets.ConvNetSpec,
    bits: Sequence[tuple[int, int]],
    luts: Mapping[int, PackingLUT],
) -> float:
    """Eq. 6: total DSP operations of a fixed bit-width assignment."""
    total = 0.0
    for i, l in enumerate(spec.layers):
        lut = luts[l.kernel if l.kernel in luts else max(luts)]
        wb, ab = bits[i]
        total += spec.op_mul(i) / lut.t_mul(wb, ab)
    return float(total)
