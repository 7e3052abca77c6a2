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
    False."""
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
    if plan is not None:
        params, head = apply_plan(params, cfg, plan, device=dev)
    elif quant == "int8":
        params = quantize_params_int8(params)
    elif quant == "packed":
        params = quantize_params_packed(params, w_bits=w_bits, a_bits=a_bits, device=dev)
    return Engine(cfg, params, ecfg, head=head if head is None else head.to(dev), device=dev,
                  capture=capture)
