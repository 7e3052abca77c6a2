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
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.plan.apply import apply_plan, prepack_tree
from repro_torch.serving.engine import Engine, EngineConfig

QUANT_MODES = (None, "int8", "packed")


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
    with ``seed``) or an already packed tree; ``quant="packed"`` packs
    every projection at ``(w_bits, a_bits)``; ``plan`` (a
    :class:`~repro_torch.plan.DeployPlan`, exclusive with ``quant`` and
    with ``head``) packs each layer at its own pair and ``block_k``
    (:func:`~repro_torch.plan.apply_plan`) and serves the plan's LM head.
    Float params are dropped once packed, so only the packed words and the
    embedding stay.  ``capture`` is :class:`Engine`'s: on a CUDA device the
    step runs as one captured CUDA graph unless it is False."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
    if plan is not None and quant is not None:
        raise ValueError("a deployment plan already fixes per-layer quantization; "
                         "pass plan= or quant=, not both")
    if plan is not None and head is not None:
        raise ValueError("plan.lm_head and head= are exclusive — pass one")
    if quant == "int8":
        raise NotImplementedError("int8 serving weights come in a later slice (ROADMAP.md, port queue)")
    dev = resolve_device(device)
    if params is None:
        params = T.init_params(cfg, seed=seed, device=dev)
    else:
        params = T.map_leaves(params, lambda a: a.to(dev))
    if plan is not None:
        params, head = apply_plan(params, cfg, plan, device=dev)
    elif quant == "packed":
        params = quantize_params_packed(params, w_bits=w_bits, a_bits=a_bits, device=dev)
    return Engine(cfg, params, ecfg, head=head if head is None else head.to(dev), device=dev,
                  capture=capture)
