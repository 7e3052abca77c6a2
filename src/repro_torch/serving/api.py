"""Engine construction (``repro.serving.api``): the front door.

    from repro_torch.configs import get_config
    from repro_torch.serving import EngineConfig, build_engine
    eng = build_engine(get_config("llama3.2-3b"),
                       EngineConfig(packed_head=True, head_bits=(4, 4), gather_backend="kernel"),
                       quant="packed", w_bits=4, a_bits=4)
    eng.submit([1, 2, 3], max_new_tokens=16)
    eng.warmup()
    metrics = eng.run()
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.plan.apply import prepack_tree
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
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> Engine:
    """Construct a serving :class:`Engine` on ``device``.

    ``params`` are float decode params (default: :func:`init_params`
    with ``seed``) or an already packed tree; ``quant="packed"`` packs
    every projection at ``(w_bits, a_bits)``.  Float params are dropped
    once packed, so only the packed words and the embedding stay."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
    if quant == "int8":
        raise NotImplementedError("int8 serving weights come in a later slice (ROADMAP.md, port queue)")
    dev = resolve_device(device)
    if params is None:
        params = T.init_params(cfg, seed=seed, device=dev)
    else:
        params = T.map_leaves(params, lambda a: a.to(dev))
    if quant == "packed":
        params = quantize_params_packed(params, w_bits=w_bits, a_bits=a_bits, device=dev)
    return Engine(cfg, params, ecfg, head=head if head is None else head.to(dev), device=dev)
