"""Deployment-plan compiler (``repro.plan``): search -> autotune -> apply -> serve.

``search`` picks per-layer ``(w_bits, a_bits)`` with the DSP-packing
LUTs, ``autotune`` times kernel block shapes on the card, ``plan``
serializes the decision as a hashed JSON artifact, and ``apply`` lowers
it onto real params for the engine (``serving.build_engine(plan=...)``).
"""
from .plan import PLAN_SCHEMA_VERSION, PLANS_DIR, DeployPlan, LayerPlan, PlanError, summarize
from .search import (
    DEFAULT_BIT_CHOICES,
    layer_matmul_shapes,
    plan_from_bits,
    search_plan,
    serving_lut,
    uniform_plan,
)
from .autotune import autotune_plan, measure_block_k, measure_pair_times
from .apply import apply_plan, prepack_tree

__all__ = [
    "PLAN_SCHEMA_VERSION",
    "PLANS_DIR",
    "DeployPlan",
    "LayerPlan",
    "PlanError",
    "summarize",
    "DEFAULT_BIT_CHOICES",
    "layer_matmul_shapes",
    "plan_from_bits",
    "search_plan",
    "serving_lut",
    "uniform_plan",
    "autotune_plan",
    "measure_block_k",
    "measure_pair_times",
    "apply_plan",
    "prepack_tree",
]
