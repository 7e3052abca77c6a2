"""On-device block-shape autotuner for deployment plans
(``repro.plan.autotune``).

The port's static ``block_k`` default is whole K (K1, the fused kernel);
this module measures the winner for every unique ``(M, K, N, w_bits,
a_bits)`` matmul of a plan by timing the real serving entry point
(:func:`~repro_torch.kernels.packed_matmul.ops.packed_dense` over one
prepack) on the device, and writes the winning ``block_k`` into each
:class:`LayerPlan`: ``block_k < K`` routes a layer's projections to K2,
the K-blocked kernel.  :mod:`repro_torch.plan.apply` threads it into
``PackedDenseParams.block_k``.

Results are cached inside the plan artifact (``plan.autotune``), keyed
by shape, bits and backend (``"cuda"`` on the card, ``"cpu"`` for the
plain versions), so re-applying a tuned plan never re-times.  Each
timed unit is ``R`` calls: one CUDA graph replay on the card
(:func:`repro_torch.kernels.common.repeat`), where the engine's step is
a graph too, and the calls cycle through ``R`` copies of the packed
weights, so that they come from device memory as a step's do.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import common
from repro_torch.kernels.packed_matmul.ops import packed_dense, prepack_dense
from repro_torch.plan.plan import DeployPlan
from repro_torch.plan.search import layer_matmul_shapes

R = 8  # calls per timed unit (the reference's R independent matmuls per dispatch)


def candidate_block_ks(k_dim: int) -> list[int]:
    """The whole K extent, power-of-two fractions down to 64, and 256 (the
    reference's compiled-backend candidates), deduplicated in that order."""
    cands: list[int] = [k_dim]
    step = k_dim // 2
    while step >= 64:
        cands.append(step)
        step //= 2
    cands.append(256)
    return list(dict.fromkeys(cands))


def _inputs(m: int, k: int, n: int, w_bits: int, a_bits: int, seed: int, dev: torch.device):
    """Seeded float activations ``[R, m, k]`` in [0, 1) and one prepack of a
    seeded ``[k, n]`` weight, with ``R`` copies of its words on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    xs = torch.rand((R, m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev)
    pre = prepack_dense(w, w_bits=w_bits, a_bits=a_bits, device=dev)
    if dev.type != "cuda":
        return xs, [pre] * R
    return xs, [pre] + [pre._with(pre.data.clone()) for _ in range(R - 1)]


def _unit_time(xs, pres, dev, reps: int, block_k: int | None = None) -> float:
    """Seconds of one call: the best of ``reps`` timed units of ``R`` calls."""
    unit = common.repeat(lambda r: packed_dense(xs[r], pres[r], block_k=block_k), R, dev)
    return common.best_time(unit, device=dev, reps=reps) / R


def measure_block_k(m: int, k: int, n: int, w_bits: int, a_bits: int, *, reps: int = 3,
                    seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Time every candidate ``block_k`` for one matmul shape on ``device``;
    returns ``{"block_k": winner, "timings_us": {candidate: us}}``.  The
    weight is packed once: only the kernel's K-tiling differs."""
    dev = resolve_device(device)
    xs, pres = _inputs(m, k, n, w_bits, a_bits, seed, dev)
    timings: dict[str, float] = {}
    best, best_t = None, float("inf")
    for bk in candidate_block_ks(k):
        t = _unit_time(xs, pres, dev, reps, block_k=bk)
        timings[str(bk)] = t * 1e6
        if t < best_t:
            best, best_t = bk, t
    return {"block_k": best, "timings_us": timings}


def measure_pair_times(cfg, *, bit_choices, n_slots: int = 8, reps: int = 3, seed: int = 0,
                       device: str | torch.device = "cuda") -> dict:
    """Seconds per layer of every ``(w_bits, a_bits)`` pair of
    ``bit_choices`` on the model's decode-step matmul shapes at the static
    default (whole K): ``{(w, a): seconds}``, each unique projection shape
    weighted by its count per layer (a layer's time is the sum of its
    projections').

    The packing LUT's T_mul ranks placements by multiplier throughput,
    blind to a backend's per-call costs (a small ``acc_chunk`` peels
    often); plan search takes this table (``pair_times=``) to regularize
    its bit choices by measured time on the serving device."""
    dev = resolve_device(device)
    shapes = layer_matmul_shapes(cfg, n_slots)
    uniq: dict[tuple[int, int, int], int] = {}
    for projs in shapes:
        for p in projs:
            uniq[(p.m, p.k, p.n)] = uniq.get((p.m, p.k, p.n), 0) + p.count
    out: dict[tuple[int, int], float] = {}
    for w_b, a_b in ((w, a) for w in bit_choices for a in bit_choices):
        t_sum = 0.0
        for (m, k, n), n_occur in uniq.items():
            xs, pres = _inputs(m, k, n, w_b, a_b, seed, dev)
            t_sum += _unit_time(xs, pres, dev, reps) * n_occur / len(shapes)
            del xs, pres
        out[(w_b, a_b)] = t_sum
    return out


def autotune_plan(plan: DeployPlan, cfg, *, n_slots: int | None = None, reps: int = 3,
                  verbose: bool = False, device: str | torch.device = "cuda") -> DeployPlan:
    """Fill every layer's ``block_k`` from measurements on ``device``.

    One measurement per unique ``(M, K, N, w_bits, a_bits)``: layers
    sharing a shape and bit pair share the cached winner.  A layer takes
    the winner of its *largest* matmul.  The table lands in
    ``plan.autotune``, so the artifact documents its own tuning."""
    dev = resolve_device(device)
    backend = dev.type
    n_slots = n_slots or int(plan.budget.get("n_slots", 8))
    shapes = layer_matmul_shapes(cfg, n_slots)
    if len(shapes) != len(plan.layers):
        raise ValueError(
            f"plan has {len(plan.layers)} layers but config yields {len(shapes)}"
        )
    cache: dict[str, dict] = dict(plan.autotune.get("table", {}))
    new_layers = []
    for lp, projs in zip(plan.layers, shapes):
        dom = max(projs, key=lambda p: p.m * p.k * p.n)
        key = f"{dom.m}x{dom.k}x{dom.n}|w{lp.w_bits}a{lp.a_bits}|{backend}"
        if key not in cache:
            cache[key] = measure_block_k(dom.m, dom.k, dom.n, lp.w_bits, lp.a_bits, reps=reps,
                                         device=dev)
            if verbose:
                print(f"autotune {key}: block_k={cache[key]['block_k']}")
        new_layers.append(dataclasses.replace(lp, block_k=cache[key]["block_k"]))
    tuned = dataclasses.replace(
        plan,
        layers=new_layers,
        autotune={"backend": backend, "reps": reps, "n_slots": n_slots, "table": cache},
    )
    return tuned.validate()
