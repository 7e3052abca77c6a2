"""Engine construction (``repro.serving.api``): the front door.

    from repro_torch.configs import get_config
    from repro_torch.serving import EngineConfig, build_engine
    eng = build_engine(get_config("llama3.2-3b"),
                       EngineConfig(packed_head=True, head_bits=(4, 4), gather_backend="kernel"),
                       quant="packed", w_bits=4, a_bits=4)
    eng.submit([1, 2, 3], max_new_tokens=16)
    eng.warmup()
    metrics = eng.run()

A deployment plan (:mod:`repro_torch.plan`) serves per-layer bit pairs
and its own LM head: ``build_engine(cfg, ecfg, plan=DeployPlan.load(path))``.
``quant="int8"`` stores every projection as int8 levels and per-column
scales; int8 KV pools come with the model config
(``dataclasses.replace(cfg, kv_dtype="int8")``).

A mesh (``EngineConfig(mesh=MeshConfig(dp, mp))``) enters here: with
``mp > 1`` the weights are **sliced first, then packed**, each rank's
slice quantized against the *global* tanh normalizer
(:func:`repro_torch.plan.apply._tp_tmax_tree`), so a shard's packed words
equal slices of the single-device prepack and nothing is repacked after a
reduction.  ``devices`` places the ``dp x mp`` ranks (default: one per
visible device, raising when there are fewer):

    eng = build_engine(cfg, EngineConfig(mesh=MeshConfig(dp=2, mp=2)), quant="packed",
                       w_bits=4, a_bits=4, device="cpu", devices=["cpu"] * 4)
"""
from __future__ import annotations

import re

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.layers import quantize_weight_int8
from repro_torch.plan.apply import MOE_WEIGHT_RE, PROJ_WEIGHT_RE, apply_plan, map_with_path, prepack_tree
from repro_torch.serving.engine import Engine, EngineConfig

QUANT_MODES = (None, "int8", "packed")


def quantize_params_int8(params: dict) -> dict:
    """Every matmul weight as int8 levels + float32 scales.

    Per-output-column symmetric int8 over the contraction dim (-2), the
    scales keeping it, so a stacked ``[L, K, N]`` weight gets ``[L, 1,
    N]`` scales and slices per layer like the levels."""

    def one(path, leaf):
        matched = re.search(PROJ_WEIGHT_RE, path) or re.search(MOE_WEIGHT_RE, path)
        if matched and isinstance(leaf, torch.Tensor) and leaf.ndim >= 2:
            return quantize_weight_int8(leaf, dim=-2)
        return leaf

    return map_with_path(one, params)


def quantize_params_packed(params: dict, *, w_bits: int, a_bits: int,
                           device: str | torch.device = "cuda") -> dict:
    """One-time quantize + bit-pack of every projection weight, on ``device``."""
    return prepack_tree(params, w_bits=w_bits, a_bits=a_bits, device=device)


def _packed_shards(params: dict, cfg, mp: int, *, w_bits: int, a_bits: int,
                   device: str | torch.device = "cuda") -> list:
    """Per-rank slice, then quantize + pack against the global normalizers:
    the ranks' trees, as a list (the reference stacks them)."""
    from repro_torch.parallel.sharding import slice_decode_params
    from repro_torch.plan.apply import _tp_tmax_tree

    shards = []
    for rank in range(mp):
        sliced = slice_decode_params(params, cfg, mp, rank)
        sliced["layers"] = prepack_tree(sliced["layers"], w_bits=w_bits, a_bits=a_bits,
                                        t_max_tree=_tp_tmax_tree(params["layers"], sliced["layers"]),
                                        device=device)
        shards.append(sliced)
    return shards


def _plan_shards(params: dict, cfg, plan, mp: int, device: str | torch.device = "cuda"):
    """Per-rank :func:`apply_plan` (sliced, then packed): the ranks' trees
    and their heads (None when the plan has no LM head)."""
    shards, heads = [], []
    for rank in range(mp):
        p_r, h_r = apply_plan(params, cfg, plan, verbose=rank == 0, tp=(mp, rank), device=device)
        shards.append(p_r)
        heads.append(h_r)
    return shards, None if heads[0] is None else heads


def build_engine(
    cfg: T.ModelConfig,
    ecfg: EngineConfig = EngineConfig(),
    *,
    params: dict | None = None,
    head=None,
    quant: str | None = None,
    w_bits: int = 4,
    a_bits: int = 8,
    plan=None,
    seed: int = 0,
    device: str | torch.device = "cuda",
    capture: bool | None = None,
    devices=None,
) -> Engine:
    """Construct a serving :class:`Engine` on ``device``.

    ``params`` are float decode params (default: :func:`init_params`
    with ``seed``) or an already quantized tree; ``quant="int8"`` stores
    every projection as int8 levels + scales; ``quant="packed"`` packs
    every projection at ``(w_bits, a_bits)``; ``plan`` (a
    :class:`~repro_torch.plan.DeployPlan`, exclusive with ``quant`` and
    with ``head``) packs each layer at its own pair and ``block_k``
    (:func:`~repro_torch.plan.apply_plan`) and serves the plan's LM head.
    Float params are dropped once quantized, so only the levels or packed
    words and the embedding stay.  ``capture`` is :class:`Engine`'s: on a
    CUDA device the step runs as one captured CUDA graph unless it is
    False.

    With ``ecfg.mesh.mp > 1`` each mode makes per-rank tensor-parallel
    shards (sliced before they are quantized or packed, against global
    normalizers), and the packed head and a plan's head shard on vocab
    rows; ``params`` must then be float (``quant=`` or ``plan=`` declares
    the preparation).  ``head`` injects a packed head (a list of per-rank
    vocab slices when ``mp > 1``).  ``devices`` places the mesh's ranks
    (:func:`repro_torch.launch.mesh.make_mesh`)."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
    if plan is not None and quant is not None:
        raise ValueError("a deployment plan already fixes per-layer quantization; "
                         "pass plan= or quant=, not both")
    if plan is not None and head is not None:
        raise ValueError("plan.lm_head and head= are exclusive — pass one")
    dev = resolve_device(device)
    if params is None:
        params = T.init_params(cfg, seed=seed, device=dev)
    else:
        params = T.map_leaves(params, lambda a: a.to(dev))
    mp = ecfg.mesh.mp
    shard_params = None
    if plan is not None:
        if mp > 1:
            shard_params, head = _plan_shards(params, cfg, plan, mp, device=dev)
        else:
            params, head = apply_plan(params, cfg, plan, device=dev)
    elif quant == "int8":
        # per-column scales slice exactly: the engine slices the int8 tree
        params = quantize_params_int8(params)
    elif quant == "packed":
        if mp > 1:
            shard_params = _packed_shards(params, cfg, mp, w_bits=w_bits, a_bits=a_bits, device=dev)
        else:
            params = quantize_params_packed(params, w_bits=w_bits, a_bits=a_bits, device=dev)
    if head is not None:
        head = [h.to(dev) for h in head] if isinstance(head, (list, tuple)) else head.to(dev)
    return Engine(cfg, params, ecfg, head=head, device=dev, capture=capture,
                  shard_params=shard_params, devices=devices)
