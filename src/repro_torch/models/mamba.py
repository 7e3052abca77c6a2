"""The Mamba2 (SSD) block of ``repro.models.mamba`` in PyTorch.

Train path (:func:`mamba_train`): the sequence is split into chunks of
``chunk`` tokens; the intra-chunk term is the quadratic masked product of
the duality paper, the inter-chunk term a float32 recurrence over chunk
states ``[B, H, N, P]`` (the reference's ``lax.scan``, here a Python loop
over chunks).  Decode path: one recurrent step per token: ``in_z``/
``in_xbc``/``in_dt`` projections, the depthwise causal conv of width
``conv_width`` over the last ``conv_width - 1`` inputs held in the conv
state, the SSD state update ``S <- exp(dt * A) S + dt B (x) x`` in
float32, the gated output RMSNorm and ``out_proj``.  The projections go
through :func:`dense`, so packed weights run the packed matmul kernel and
QAT configs fake-quantize; the rest is plain PyTorch, as the reference's
is plain ``jnp`` outside any Pallas kernel.

Tensor parallelism (the reference's ``shard_heads`` and ``axis_name``):
a mesh rank runs the block on its contiguous group of heads
(:class:`MambaSpec` ``shard_heads``; ``in_z``, the x part of ``in_xbc``,
the conv channels, ``in_dt``, ``a_log``, ``dt_bias``, ``d_skip`` sliced per
head group, the B and C columns replicated), the gated output RMSNorm over
the *global* ``d_inner`` (a sum of squares reduced over the ranks in mid
block) and ``out_proj`` row-parallel, reduced before the residual.  The
ranks run in lockstep (:func:`mamba_decode_tp`, :func:`mamba_train_tp`),
so the block runs in two phases around each reduction.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import all_reduce_sum
from repro_torch.models.layers import NO_QUANT, QuantConfig, dense, rmsnorm


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_state: int  # N
    head_dim: int = 64  # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    # a tensor-parallel rank's head count (None: every head); d_inner is
    # then the rank's local inner width
    shard_heads: int | None = None

    @property
    def d_inner(self) -> int:
        if self.shard_heads is not None:
            return self.shard_heads * self.head_dim
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


def _conv1d_causal(w: torch.Tensor, bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence: x [B, S, C], w [K, C]
    (``out[s] = sum_k x[s - K + 1 + k] w[k]``, zeros before the start)."""
    K, C = w.shape
    xp = F.pad(x, (0, 0, K - 1, 0)).transpose(1, 2)  # [B, C, K - 1 + S]
    out = F.conv1d(xp, w.to(x.dtype).t().unsqueeze(1), groups=C)  # weight [C, 1, K]
    return out.transpose(1, 2) + bias.to(x.dtype)


def mamba_train(params: dict, s: MambaSpec, x: torch.Tensor, *, quant: QuantConfig = NO_QUANT) -> torch.Tensor:
    """x: [B, S, d_model] -> [B, S, d_model] (residual included).

    The reference's chunked SSD scan op by op, dtypes included: ``dt`` is
    float32 after ``+ dt_bias``, the decays, chunk states and inter-chunk
    read-out run in float32, the intra-chunk product in ``x.dtype``.  The
    upper triangle of the segment sums is zeroed **before** ``exp`` (it is
    positive and overflows; ``0 * inf`` would poison the backward)."""
    y = _train_core(params, s, x, quant)
    y = rmsnorm(params["out_norm"], y)
    out = dense(params["out_proj"], y, name="ssm_out", quant=quant)
    return x + out


def _train_core(params: dict, s: MambaSpec, x: torch.Tensor, quant: QuantConfig) -> torch.Tensor:
    """:func:`mamba_train` up to the output norm: the gated output ``y *
    silu(z)`` ``[B, S, d_inner]``."""
    B, S, _ = x.shape
    H, P, N, Q = s.n_heads, s.head_dim, s.d_state, min(s.chunk, S)
    assert S % Q == 0, "sequence must divide the SSD chunk size"
    h = rmsnorm(params["ln"], x)
    z, xs, b, c, dt = _project_in(params, s, h, quant)
    xbc = torch.cat([xs, b, c], dim=-1)
    xbc = F.silu(_conv1d_causal(params["conv_w"], params["conv_b"], xbc))
    xs = xbc[..., : s.d_inner].reshape(B, S, H, P)
    b = xbc[..., s.d_inner : s.d_inner + N]
    c = xbc[..., s.d_inner + N :]
    dt = F.softplus(dt + params["dt_bias"])  # [B, S, H]
    a = -torch.exp(params["a_log"])  # [H], negative
    log_a = (dt * a).to(torch.float32)  # [B, S, H] (<= 0)

    nc = S // Q
    xs_c = xs.reshape(B, nc, Q, H, P)
    b_c = b.reshape(B, nc, Q, N)
    c_c = c.reshape(B, nc, Q, N)
    dt_c = dt.reshape(B, nc, Q, H)
    cum = torch.cumsum(log_a.reshape(B, nc, Q, H), dim=2)  # inclusive

    # intra-chunk (quadratic, masked): y[i] += sum_{j<=i} (C_i.B_j) e^{cum_i-cum_j} dt_j x_j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, nc, Qi, Qj, H]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, seg, 0.0)) * mask
    cb = torch.einsum("bnis,bnjs->bnij", c_c, b_c)  # [B, nc, Qi, Qj]
    scores = cb[:, :, :, :, None] * decay * dt_c[:, :, None, :, :]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", scores.to(x.dtype), xs_c)

    # chunk states: S_n = e^{cum_Q} S_{n-1} + sum_j e^{cum_Q - cum_j} dt_j B_j (x) x_j
    tail = torch.exp(cum[:, :, -1:, :] - cum)  # [B, nc, Q, H]
    contrib = torch.einsum("bnqh,bnqs,bnqhp->bnhsp", (tail * dt_c).to(torch.float32),
                           b_c.to(torch.float32), xs_c.to(torch.float32))  # [B, nc, H, N, P]
    gamma = torch.exp(cum[:, :, -1, :])  # [B, nc, H] total chunk decay
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    prev = []  # the state *before* each chunk, for the inter-chunk term
    for n in range(nc):
        prev.append(state)
        state = state * gamma[:, n, :, None, None] + contrib[:, n]
    prev_states = torch.stack(prev, dim=1)  # [B, nc, H, N, P]

    # inter-chunk: y[i] += e^{cum_i} C_i . S_prev
    y_inter = torch.einsum("bnqh,bnqs,bnhsp->bnqhp", torch.exp(cum), c_c.to(torch.float32),
                           prev_states).to(x.dtype)

    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + params["d_skip"].to(x.dtype)[None, None, :, None] * xs.reshape(B, S, H, P)
    return y.reshape(B, S, s.d_inner) * F.silu(z)


def _out_norm_tp(params: list[dict], ys: list[torch.Tensor], eps: float) -> list[torch.Tensor]:
    """The gated output RMSNorm on ``mp`` ranks: each rank's sum of squares
    reduced over the ranks, the mean taken over the **global** ``d_inner``
    (the reference's ``_out_norm`` with an axis)."""
    sq = all_reduce_sum([torch.sum(torch.square(y), dim=-1, keepdim=True, dtype=torch.float32) for y in ys])
    d = float(len(ys) * ys[0].shape[-1])
    return [(y * torch.rsqrt(q / d + eps).to(y.dtype)) * p["out_norm"]["g"].to(y.dtype)
            for p, y, q in zip(params, ys, sq)]


def mamba_train_tp(params: list[dict], s: MambaSpec, xs: list[torch.Tensor], *,
                   quant: QuantConfig = NO_QUANT, eps: float = 1e-6) -> list[torch.Tensor]:
    """:func:`mamba_train` on ``mp`` tensor-parallel ranks in lockstep:
    each rank runs its heads (``s`` the local spec, ``params`` its compute
    shard: ``in_z``, the x part of ``in_xbc``, the conv channels,
    ``in_dt``, ``a_log``, ``dt_bias``, ``d_skip`` and ``out_norm`` of its
    heads, the whole B and C columns), the output norm over the global
    ``d_inner``, then its ``out_proj`` share, summed over the ranks before
    the replicated residual.  Returns each rank's ``x + out``."""
    ys = [_train_core(p, s, x, quant) for p, x in zip(params, xs)]
    parts = [dense(p["out_proj"], y, name="ssm_out", quant=quant)
             for p, y in zip(params, _out_norm_tp(params, ys, eps))]
    return [x + o for x, o in zip(xs, all_reduce_sum(parts))]


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
    y, new_state, new_conv_state = _decode_core(params, s, x, ssm_state, conv_state, quant)
    y = rmsnorm(params["out_norm"], y)  # the reference's _out_norm on one device
    out = dense(params["out_proj"], y, name="ssm_out", quant=quant)
    return x + out, new_state, new_conv_state


def _decode_core(params: dict, s: MambaSpec, x: torch.Tensor, ssm_state: torch.Tensor,
                 conv_state: torch.Tensor, quant: QuantConfig):
    """:func:`mamba_decode` up to the output norm: the gated output ``y *
    silu(z)`` ``[B, 1, d_inner]`` and the new states."""
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
    return y, new_state, new_conv_state


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


def mamba_decode_tp(
    params: list[dict],
    s: MambaSpec,
    xs: list[torch.Tensor],  # per rank [B, C, d_model], replicated
    ssm_states: list[torch.Tensor],  # per rank [B, H_loc, N, P] float32
    conv_states: list[torch.Tensor],  # per rank [B, conv_width - 1, conv_dim_loc]
    *,
    lens: list[torch.Tensor] | None = None,
    quant: QuantConfig = NO_QUANT,
    eps: float = 1e-6,
) -> tuple[list, list, list]:
    """The block on ``mp`` tensor-parallel ranks in lockstep: each lane runs
    every rank to its gated output, reduces the sums of squares for the
    output norm over the **global** ``d_inner`` (the reference's
    ``_out_norm`` with an axis), then every rank's ``out_proj`` share,
    reduced before the replicated residual.  ``s`` is the local spec
    (``shard_heads``).  One lane with ``lens=None`` is
    :func:`mamba_decode`'s step, otherwise :func:`mamba_decode_chunk`'s
    (lanes past ``lens`` keep the state).  Returns per-rank outputs ``[B,
    C, d_model]`` and final states, as new tensors."""
    mp = len(params)
    sts, cvs = list(ssm_states), list(conv_states)
    outs: list[list[torch.Tensor]] = [[] for _ in range(mp)]
    for j in range(xs[0].shape[1]):
        xj = [x[:, j:j + 1] for x in xs]
        core = [_decode_core(params[r], s, xj[r], sts[r], cvs[r], quant) for r in range(mp)]
        yns = _out_norm_tp(params, [c[0] for c in core], eps)
        red = all_reduce_sum([dense(params[r]["out_proj"], yns[r], name="ssm_out", quant=quant)
                              for r in range(mp)])
        for r in range(mp):
            _, ns, nc = core[r]
            if lens is not None:
                ok = lens[r] > j
                ns = torch.where(ok[:, None, None, None], ns, sts[r])
                nc = torch.where(ok[:, None, None], nc, cvs[r])
            sts[r], cvs[r] = ns, nc
            outs[r].append((xj[r] + red[r])[:, 0])
    return [torch.stack(o, dim=1) for o in outs], sts, cvs
