"""The Mamba2 decode path of ``repro.models.mamba`` in PyTorch.

One recurrent step per token: ``in_z``/``in_xbc``/``in_dt`` projections,
the depthwise causal conv of width ``conv_width`` over the last
``conv_width - 1`` inputs held in the conv state, the SSD state update
``S <- exp(dt * A) S + dt B (x) x`` in float32, the gated output RMSNorm
and ``out_proj``.  The projections go through :func:`dense`, so packed
weights run the packed matmul kernel; the recurrence is plain PyTorch,
as the reference's is plain ``jnp`` outside any Pallas kernel.

One device only: the reference's head sharding (``shard_heads``,
``axis_name``) waits for the mesh, and the chunked-scan training path
(``mamba_train``) for training (ROADMAP.md, port queue).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import NO_QUANT, QuantConfig, dense, rmsnorm


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_state: int  # N
    head_dim: int = 64  # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba_init(g: torch.Generator, s: MambaSpec, n_layers: int) -> dict:
    """Random float32 params of ``n_layers`` layers, stacked ``[L, ...]``,
    with the reference's keys and shapes, made on ``g``'s device from
    ``g``.  The deterministic parts equal the reference's: ``a_log =
    log(linspace(1, 16, H))``, ``dt_bias`` 0, ``d_skip`` 1."""
    dev = g.device
    d_in, H = s.d_inner, s.n_heads
    conv_dim = d_in + 2 * s.d_state

    def normal(*shape):
        return torch.randn((n_layers, *shape), generator=g, device=dev, dtype=torch.float32)

    def dense_init(d_i: int, d_o: int) -> dict:
        return {"w": normal(d_i, d_o) / math.sqrt(d_i)}

    def full(value, *shape):
        return torch.full((n_layers, *shape), value, dtype=torch.float32, device=dev)

    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev))
    return {
        "ln": {"g": full(1.0, s.d_model)},
        "in_z": dense_init(s.d_model, d_in),
        "in_xbc": dense_init(s.d_model, conv_dim),
        "in_dt": dense_init(s.d_model, H),
        "conv_w": normal(s.conv_width, conv_dim) * 0.2,
        "conv_b": full(0.0, conv_dim),
        "a_log": a_log.expand(n_layers, H).contiguous(),  # A = -exp(a_log)
        "dt_bias": full(0.0, H),
        "d_skip": full(1.0, H),
        "out_norm": {"g": full(1.0, d_in)},
        "out_proj": dense_init(d_in, s.d_model),
    }


def _project_in(params: dict, s: MambaSpec, h: torch.Tensor, quant: QuantConfig):
    z = dense(params["in_z"], h, name="ssm_in", quant=quant)
    xbc = dense(params["in_xbc"], h, name="ssm_in", quant=quant)
    dt = dense(params["in_dt"], h, name="ssm_dt", quant=quant)
    n = s.d_state
    x = xbc[..., : s.d_inner]
    b = xbc[..., s.d_inner : s.d_inner + n]
    c = xbc[..., s.d_inner + n :]
    return z, x, b, c, dt


def mamba_decode(
    params: dict,
    s: MambaSpec,
    x: torch.Tensor,  # [B, 1, d_model]
    ssm_state: torch.Tensor,  # [B, H, N, P] float32
    conv_state: torch.Tensor,  # [B, conv_width - 1, conv_dim]
    *,
    quant: QuantConfig = NO_QUANT,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token recurrent step; returns ``(x + out, ssm_state, conv_state)``
    as new tensors (the inputs are not written).

    Dtypes follow the reference op by op: ``dt`` leaves ``dense`` in
    ``x.dtype`` and ``dt + dt_bias`` promotes it to float32 (``dt_bias`` is
    float32); the conv runs in ``x.dtype``; the state, its update and the
    read-out in float32, cast to ``x.dtype`` before the ``d_skip`` term.
    ``F.softplus`` is the identity above 20 where ``jax.nn.softplus`` is
    not; in float32 the two agree there."""
    B = x.shape[0]
    H, P, N = s.n_heads, s.head_dim, s.d_state
    h = rmsnorm(params["ln"], x)
    z, xs, b, c, dt = _project_in(params, s, h, quant)
    xbc = torch.cat([xs, b, c], dim=-1)  # [B, 1, conv_dim]
    window = torch.cat([conv_state, xbc], dim=1)  # [B, K, conv_dim]
    w = params["conv_w"].to(x.dtype).to(window.dtype)  # the reference's cast, then its promotion
    conv_out = torch.einsum("bkc,kc->bc", window, w) + params["conv_b"].to(x.dtype)
    xbc = F.silu(conv_out)[:, None, :]
    new_conv_state = window[:, 1:, :]
    xs = xbc[..., : s.d_inner].reshape(B, H, P)
    b = xbc[..., s.d_inner : s.d_inner + N].reshape(B, N)
    c = xbc[..., s.d_inner + N :].reshape(B, N)
    dt = F.softplus(dt + params["dt_bias"]).reshape(B, H)
    a = -torch.exp(params["a_log"])
    g = torch.exp((dt * a).to(torch.float32))  # [B, H]
    # the outer product dt x B x x, as explicit broadcasts (elementwise, so
    # the same bits on every device)
    contrib = (dt.to(torch.float32)[:, :, None, None] * b.to(torch.float32)[:, None, :, None]
               * xs.to(torch.float32)[:, :, None, :])  # [B, H, N, P]
    new_state = ssm_state * g[:, :, None, None] + contrib
    y = torch.einsum("bs,bhsp->bhp", c.to(torch.float32), new_state).to(x.dtype)
    y = y + params["d_skip"].to(x.dtype)[None, :, None] * xs
    y = y.reshape(B, 1, s.d_inner) * F.silu(z)
    y = rmsnorm(params["out_norm"], y)  # the reference's _out_norm on one device
    out = dense(params["out_proj"], y, name="ssm_out", quant=quant)
    return x + out, new_state, new_conv_state


def mamba_decode_chunk(
    params: dict,
    s: MambaSpec,
    x: torch.Tensor,  # [B, C, d_model] a chunk of C token lanes per sequence
    ssm_state: torch.Tensor,  # [B, H, N, P] float32
    conv_state: torch.Tensor,  # [B, conv_width - 1, conv_dim]
    *,
    lens: torch.Tensor | None = None,  # [B] int32 valid lanes (None: all C)
    quant: QuantConfig = NO_QUANT,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recurrent step over a C-token chunk (chunked-prefill serving), as
    the reference writes it: :func:`mamba_decode` once per lane, each lane
    seeing the state the previous one left, so token-exact with C single
    steps.  Lanes ``j >= lens[b]`` leave sequence ``b``'s state as it was
    (a ``where`` on the device, no host read), so decoding slots ride in
    the same step as slots prefilling whole chunks.  Returns the lanes'
    outputs ``[B, C, d_model]`` and the final states, as new tensors."""
    st, cv = ssm_state, conv_state
    hs = []
    for j in range(x.shape[1]):
        h, ns, nc = mamba_decode(params, s, x[:, j : j + 1], st, cv, quant=quant)
        if lens is not None:
            ok = lens > j  # [B]
            ns = torch.where(ok[:, None, None, None], ns, st)
            nc = torch.where(ok[:, None, None], nc, cv)
        st, cv = ns, nc
        hs.append(h[:, 0])
    return torch.stack(hs, dim=1), st, cv
