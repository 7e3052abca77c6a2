"""Mixture-of-Experts layer (``repro.models.moe``) in PyTorch.

Token-choice top-k routing with capacity, a scatter into per-expert
capacity buckets, one batched matmul pair over the experts, and the
combine back to the tokens; copies over capacity fall back to the
residual stream.  Two paths share one parameter layout, as in the
reference:

* :func:`moe_reference`: every expert sees every token, outputs masked
  (the dense oracle the tests use);
* :func:`moe_apply`: the serving path, :func:`_local_moe` with one
  expert group;
* :func:`_local_moe_expert_sharded`: the mesh's decode path, tokens
  replicated over the model ranks, each rank running its ``E / mp`` local
  experts, one reduction over the ranks combining them;
* :func:`_local_moe` with ``axis_name``: the mesh's train and prefill
  path, tokens sharded over the model ranks, each rank's copies sent to
  the rank that owns their expert and the results sent back, two
  :func:`~repro_torch.launch.mesh.all_to_all` exchanges each way (the
  ranks run in lockstep in one process, so the call takes every rank's
  params and tokens as lists in rank order).

The dispatch reproduces the reference's, including two behaviours that
the port must match bit for bit:

* **Top-k order.** ``jax.lax.top_k`` puts the lower index first among
  equal gates, and that order decides which copy an over-capacity expert
  keeps; ``torch.topk`` breaks ties otherwise, so :func:`top_k` takes a
  stable descending sort.
* **Colliding bucket rows.** The reference clips every bucket slot into
  range, so copies over an expert's capacity and the padding rows of the
  send buffer all land on the last expert's last row, after the copy kept
  there; on its CPU backend the scatter runs serially and the last of
  them (a zero row) wins, so the kept copy reads ``ffn(0)``.  Here every
  scatter with possible collisions keeps, for each target row, the writer
  with the highest position in sorted order (:func:`_scatter_last`), with
  a deterministic ``scatter_reduce(amax)`` and a gather; no
  ``index_put_`` or ``index_add_`` with duplicate indices, which on the
  card would be neither ordered nor deterministic.

Shapes stay static (no ``.item()``, ``nonzero`` or boolean-mask
indexing), so the engine's step stays one captured CUDA graph.  Packed
experts (:class:`PackedDenseParams` with a leading expert axis) run K1
(K2 at ``block_k < K``) over all experts in one launch a projection.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.packed_matmul.ops import PackedDenseParams, packed_dense
from repro_torch.launch.mesh import all_to_all
from repro_torch.models.layers import rmsnorm


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int  # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    kind: str = "swiglu"


def moe_init(g: torch.Generator, s: MoESpec, lead: tuple[int, ...] = ()) -> dict:
    """Random float32 params in the reference's layout and scales, made
    on the generator's device; ``lead`` stacks them (``(L,)`` for a
    layer stack).  Each tensor is drawn and scaled in place."""
    E, d, f = s.n_experts, s.d_model, s.d_ff

    def normal(*shape, fan_in):
        return torch.randn(lead + shape, generator=g, device=g.device).div_(math.sqrt(fan_in))

    p = {
        "router": {"w": normal(d, E, fan_in=d)},
        "w_up": normal(E, d, f, fan_in=d),
        "w_down": normal(E, f, d, fan_in=f),
        "ln": {"g": torch.ones(lead + (d,), device=g.device)},
    }
    if s.kind in ("swiglu", "geglu"):
        p["w_gate"] = normal(E, d, f, fan_in=d)
    return p


def _weight(w, dtype: torch.dtype) -> torch.Tensor:
    """Dequantize a float / int8-dict expert weight tensor."""
    if isinstance(w, dict):
        return w["levels"].to(dtype) * w["scale"].to(dtype)
    return w.to(dtype)


def _n_local_experts(w) -> int:
    """Leading (expert) dim of a float / int8-dict / packed expert weight."""
    if isinstance(w, PackedDenseParams):
        return w.data.shape[0]
    if isinstance(w, dict):
        return w["levels"].shape[0]
    return w.shape[0]


def _expert_matmul(x: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """Batched per-expert matmul [E, C, K] x [E, K, N] -> [E, C, N].

    Float and int8-dict weights use one einsum; packed weights take the
    sigmoid proxy of ``layers.dense``'s packed path and run one batched
    packed product (K1, K2 at ``block_k < K``, or the batched plain
    integer matmul for pairs with no placement)."""
    if not isinstance(w, PackedDenseParams):
        return torch.einsum("ecd,edf->ecf", x, _weight(w, dtype))
    xq = torch.sigmoid(x).to(torch.float32)
    return packed_dense(xq, w).to(dtype)


def _expert_ffn(p: dict, s: MoESpec, x: torch.Tensor) -> torch.Tensor:
    """x: [E, C, d] -> [E, C, d] batched over local experts."""
    up = _expert_matmul(x, p["w_up"], x.dtype)
    if s.kind in ("swiglu", "geglu"):
        gate = _expert_matmul(x, p["w_gate"], x.dtype)
        # jax.nn.gelu defaults to the tanh approximation
        act = (F.silu(gate) if s.kind == "swiglu" else F.gelu(gate, approximate="tanh")) * up
    elif s.kind == "squared_relu":
        r = F.relu(up)
        act = r * r
    else:
        act = F.gelu(up, approximate="tanh")
    return _expert_matmul(act, p["w_down"], x.dtype)


def top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest along the last axis, the lower
    index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params: dict, s: MoESpec, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Router of normed tokens ``h`` [T, d]: the top-k softmax gates
    [T, k] float32 (the caller renormalises them) and their expert ids."""
    logits = h @ params["router"]["w"].to(h.dtype)
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    return top_k(gates, s.top_k)


def _scatter_last(n_rows: int, slot: torch.Tensor, values: torch.Tensor, fill) -> torch.Tensor:
    """``out[slot[i]] = values[i]`` into ``n_rows`` rows of ``fill``, the
    highest ``i`` winning where several target one row (the reference's
    serial scatter on its CPU backend), deterministically: each row's
    writer is found with ``scatter_reduce(amax)`` and gathered."""
    pos = torch.arange(slot.shape[0], device=slot.device)
    writer = torch.full((n_rows,), -1, dtype=torch.long, device=slot.device)
    writer = writer.scatter_reduce(0, slot, pos, "amax", include_self=True)
    taken = values[writer.clamp(min=0)]
    has = (writer >= 0).reshape((n_rows,) + (1,) * (values.ndim - 1))
    return torch.where(has, taken, fill)


def moe_reference(params: dict, s: MoESpec, x: torch.Tensor) -> torch.Tensor:
    """Dense oracle: every expert sees every token, outputs are masked."""
    B, S, d = x.shape
    h = rmsnorm(params["ln"], x).reshape(B * S, d)
    topv, topi = _route(params, s, h)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    weights = torch.zeros((B * S, s.n_experts), dtype=topv.dtype, device=x.device).scatter(1, topi, topv)
    all_out = _expert_ffn(params, s, h.expand((s.n_experts,) + h.shape))  # [E, T, d]
    out = torch.einsum("te,etd->td", weights.to(h.dtype), all_out)
    return x + out.reshape(B, S, d)


def _local_moe(params, s: MoESpec, x, *, axis_name: str | None = None):
    """The reference's ``_local_moe``: x [t, d] tokens -> [t, d] expert
    outputs (no residual).

    One device (``axis_name=None``): with one expert group every copy's
    destination rank is 0, so the reference's stable sort by rank keeps
    the copies in token order (copy ``c`` of token ``t`` at ``t * k + c``)
    and its all_to_all is the identity; the send buffer, the per-expert
    buckets and the combine follow it step by step, capacities from
    Python's ``round`` as there.

    With ``axis_name`` (the model axis): ``params`` and ``x`` are lists,
    rank ``r``'s local experts and its local tokens, and so is the result
    (:func:`_local_moe_all_to_all`)."""
    if axis_name is not None:
        if isinstance(x, torch.Tensor):
            raise TypeError("_local_moe with an axis takes every rank's params and tokens as per-rank lists")
        return _local_moe_all_to_all(params, s, x)
    t, d = x.shape
    e_loc = _n_local_experts(params["w_up"])
    k = s.top_k
    dev = x.device

    h = rmsnorm(params["ln"], x)
    topv, topi = _route(params, s, h)
    topv = topv / (torch.sum(topv, dim=-1, keepdim=True) + 1e-9)

    # flatten token copies: copy c of token t goes to expert topi[t, c]
    n_copy = t * k
    expert_of_copy = topi.reshape(n_copy)
    gate_of_copy = topv.reshape(n_copy)
    token_of_copy = torch.div(torch.arange(n_copy, device=dev), k, rounding_mode="floor")

    # the send buffer: copies in order, c_send rows; copies past it are
    # clipped onto its last row, which the last of them (a zero row) wins
    c_send = int(max(1, round(n_copy * s.capacity_factor)))
    pos_in_rank = torch.arange(n_copy, device=dev)
    keep = pos_in_rank < c_send
    slot = torch.clamp(pos_in_rank, 0, c_send - 1)
    send_x = _scatter_last(c_send, slot, torch.where(keep[:, None], h[token_of_copy], 0.0), 0.0)
    send_e = _scatter_last(c_send, slot, torch.where(keep, expert_of_copy, -1), -1)

    # group the copies into per-expert capacity buckets (invalid -> overflow)
    n_recv = c_send
    local_expert = torch.where(send_e >= 0, send_e, e_loc)
    c_exp = int(max(1, round(n_recv / e_loc * s.capacity_factor)))
    order2 = torch.argsort(local_expert, stable=True)
    le_sorted = local_expert[order2]
    pos_in_exp = torch.arange(n_recv, device=dev) - torch.searchsorted(le_sorted, le_sorted)
    keep2 = (pos_in_exp < c_exp) & (le_sorted < e_loc)
    slot2 = torch.clamp(le_sorted * c_exp + pos_in_exp, 0, e_loc * c_exp - 1)
    buckets = _scatter_last(e_loc * c_exp, slot2, torch.where(keep2[:, None], send_x[order2], 0.0), 0.0)
    y = _expert_ffn(params, s, buckets.reshape(e_loc, c_exp, d)).reshape(e_loc * c_exp, d)

    # route results back to their send rows: order2 is a permutation, so
    # each row has one writer, and the inverse permutation gathers them
    inv = torch.empty_like(order2).scatter_(0, order2, torch.arange(n_recv, device=dev))
    back = torch.where(keep2[:, None], y[slot2], 0.0)[inv]

    # combine: token t's k copies, weighted by their gates, added in copy
    # order as the reference's serial scatter-add does (dropped copies add
    # nothing to their token)
    gate_w = torch.where(keep, gate_of_copy, 0.0).to(h.dtype)
    contrib = torch.where(keep[:, None], back[slot] * gate_w[:, None], 0.0).reshape(t, k, d)
    out = contrib[:, 0]
    for c in range(1, k):
        out = out + contrib[:, c]
    return out


def _local_moe_all_to_all(params: list, s: MoESpec, xs: list) -> list:
    """The reference's ``_local_moe`` under ``shard_map`` with the model
    axis named, its ``M = len(params)`` ranks in lockstep: rank ``r``
    routes its ``t`` local tokens' ``n = t k`` copies, groups them by the
    rank owning their expert (a stable sort) into a send buffer of ``M``
    blocks of ``c_send = round(n / M * capacity_factor)`` rows, copies past
    a block's capacity dropped (clipped onto a later row, which the
    reference's serial scatter lets the later writer win:
    :func:`_scatter_last`); one :func:`all_to_all` sends each block to its
    rank with the experts' ids; each rank buckets what it received by
    local expert (``c_exp = round(M c_send / e_loc * capacity_factor)`` rows
    each, invalid rows in an overflow bucket), runs its experts, and a
    second :func:`all_to_all` returns the rows to their senders, which
    combine each token's kept copies weighted by their gates, added in
    the send buffer's order as the reference's scatter-add does.
    Capacities follow each rank's local counts, so copies drop differently
    from one device's dispatch."""
    M = len(params)
    e_loc = _n_local_experts(params[0]["w_up"])
    k = s.top_k
    t, d = xs[0].shape
    n_copy = t * k
    c_send = int(max(1, round(n_copy / M * s.capacity_factor)))
    n_recv = M * c_send
    c_exp = int(max(1, round(n_recv / e_loc * s.capacity_factor)))
    sends_x, sends_e, routes = [], [], []
    for p, x in zip(params, xs):
        dev = x.device
        h = rmsnorm(p["ln"], x)
        topv, topi = _route(p, s, h)
        topv = topv / (torch.sum(topv, dim=-1, keepdim=True) + 1e-9)
        expert_of_copy = topi.reshape(n_copy)
        token_of_copy = torch.div(torch.arange(n_copy, device=dev), k, rounding_mode="floor")
        dest_rank = torch.div(expert_of_copy, e_loc, rounding_mode="floor")
        order = torch.argsort(dest_rank, stable=True)
        rank_sorted = dest_rank[order]
        pos_in_rank = torch.arange(n_copy, device=dev) - torch.searchsorted(rank_sorted, rank_sorted)
        keep = pos_in_rank < c_send
        slot = torch.clamp(rank_sorted * c_send + pos_in_rank, 0, n_recv - 1)
        sends_x.append(_scatter_last(n_recv, slot, torch.where(keep[:, None], h[token_of_copy[order]], 0.0), 0.0))
        sends_e.append(_scatter_last(n_recv, slot, torch.where(keep, expert_of_copy[order], -1), -1))
        routes.append((order, keep, slot, topv.reshape(n_copy), h.dtype))
    backs = []
    for r, (p, recv_x, recv_e) in enumerate(zip(params, all_to_all(sends_x), all_to_all(sends_e))):
        dev = recv_x.device
        local_expert = torch.where(recv_e >= 0, recv_e - r * e_loc, e_loc)
        order2 = torch.argsort(local_expert, stable=True)
        le_sorted = local_expert[order2]
        pos_in_exp = torch.arange(n_recv, device=dev) - torch.searchsorted(le_sorted, le_sorted)
        keep2 = (pos_in_exp < c_exp) & (le_sorted < e_loc)
        slot2 = torch.clamp(le_sorted * c_exp + pos_in_exp, 0, e_loc * c_exp - 1)
        buckets = _scatter_last(e_loc * c_exp, slot2, torch.where(keep2[:, None], recv_x[order2], 0.0), 0.0)
        y = _expert_ffn(p, s, buckets.reshape(e_loc, c_exp, d)).reshape(e_loc * c_exp, d)
        inv2 = torch.empty_like(order2).scatter_(0, order2, torch.arange(n_recv, device=dev))
        backs.append(torch.where(keep2[:, None], y[slot2], 0.0)[inv2])
    outs = []
    for back, (order, keep, slot, gate_of_copy, dtype) in zip(all_to_all(backs), routes):
        dev = back.device
        gate_w = torch.where(keep, gate_of_copy[order], 0.0).to(dtype)
        contrib = back[slot] * gate_w[:, None]
        # to copy order, then each token's k copies in send-buffer order
        inv = torch.empty_like(order).scatter_(0, order, torch.arange(n_copy, device=dev))
        keep_c = keep[inv].reshape(t, k)
        contrib_c = contrib[inv].reshape(t, k, d)
        by_send = torch.argsort(inv.reshape(t, k), dim=1)
        keep_c = torch.gather(keep_c, 1, by_send)
        contrib_c = torch.gather(contrib_c, 1, by_send[..., None].expand(t, k, d))
        out = torch.zeros((t, d), dtype=dtype, device=dev)
        for c in range(k):
            out = out + torch.where(keep_c[:, c, None], contrib_c[:, c], 0.0)
        outs.append(out)
    return outs


def _local_moe_expert_sharded(params: dict, s: MoESpec, x: torch.Tensor, *, rank: int,
                              mp: int) -> torch.Tensor:
    """The mesh's decode-path MoE on model rank ``rank`` of ``mp``: x [t, d]
    tokens (replicated on every rank) -> this rank's share of the expert
    outputs [t, d], before the reduction over the ranks (no residual).

    ``params`` hold the rank's ``E / mp`` local experts (experts
    ``rank * E/mp`` onwards) and the whole router.  Every rank routes every
    token; copies bound for another rank's experts, and copies over a local
    expert's capacity ``round(t k / E * capacity_factor * mp)``, are
    dropped here.  The dispatch follows the reference's: its stable sort by
    local expert, its clipped bucket rows (:func:`_scatter_last`, the
    reference's serial scatter), and its scatter-add combine, which adds
    each token's kept copies in sorted order, i.e. by local expert."""
    t, d = x.shape
    e_loc = _n_local_experts(params["w_up"])
    E = e_loc * mp
    k = s.top_k
    dev = x.device

    h = rmsnorm(params["ln"], x)
    topv, topi = _route(params, s, h)
    topv = topv / (torch.sum(topv, dim=-1, keepdim=True) + 1e-9)

    n_copy = t * k
    expert_of_copy = topi.reshape(n_copy)
    gate_of_copy = topv.reshape(n_copy)
    token_of_copy = torch.div(torch.arange(n_copy, device=dev), k, rounding_mode="floor")

    local_e = expert_of_copy - rank * e_loc
    mine = (local_e >= 0) & (local_e < e_loc)
    le = torch.where(mine, local_e, e_loc)
    cap = int(max(1, round(n_copy / E * s.capacity_factor * mp)))  # per local expert
    order = torch.argsort(le, stable=True)
    le_s = le[order]
    pos = torch.arange(n_copy, device=dev) - torch.searchsorted(le_s, le_s)
    keep = (pos < cap) & (le_s < e_loc)
    slot = torch.clamp(le_s * cap + pos, 0, e_loc * cap - 1)
    buckets = _scatter_last(e_loc * cap, slot, torch.where(keep[:, None], h[token_of_copy[order]], 0.0), 0.0)
    y = _expert_ffn(params, s, buckets.reshape(e_loc, cap, d)).reshape(e_loc * cap, d)

    gate_w = torch.where(keep, gate_of_copy[order], 0.0).to(h.dtype)
    contrib = y[slot] * gate_w[:, None]
    # back to copy order (order is a permutation), then each token's k
    # copies in sorted order: by local expert, its copies' experts being
    # distinct; a dropped copy adds nothing to its token
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(n_copy, device=dev))
    keep_c = keep[inv].reshape(t, k)
    contrib_c = contrib[inv].reshape(t, k, d)
    by_expert = torch.argsort(le.reshape(t, k), dim=1, stable=True)
    keep_c = torch.gather(keep_c, 1, by_expert)
    contrib_c = torch.gather(contrib_c, 1, by_expert[..., None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=h.dtype, device=dev)
    for c in range(k):
        out = out + torch.where(keep_c[:, c, None], contrib_c[:, c], 0.0)
    return out


def moe_apply(params, s: MoESpec, x, *, axis_name: str | None = None):
    """Production MoE block: x [B, S, d] -> x + MoE(x).  Packed experts
    carry their own bits, so it takes no ``quant`` (the reference's is
    unused).  With ``axis_name``, per-rank lists of params and local
    tokens in, per-rank results out (:func:`_local_moe`)."""
    if axis_name is not None:
        if isinstance(x, torch.Tensor):
            raise TypeError("moe_apply with an axis takes every rank's params and tokens as per-rank lists")
        outs = _local_moe(params, s, [a.reshape(-1, a.shape[-1]) for a in x], axis_name=axis_name)
        return [a + o.reshape(a.shape) for a, o in zip(x, outs)]
    B, S, d = x.shape
    out = _local_moe(params, s, x.reshape(B * S, d), axis_name=axis_name)
    return x + out.reshape(B, S, d)
