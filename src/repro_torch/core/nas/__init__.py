"""The DSP-aware differentiable bit-width search (``repro.core.nas``, §V)."""
from .supernet import (
    SearchSpace,
    complexity_loss,
    init_alphas,
    op_dsp,
    op_muls,
    select_bits,
    supernet_apply,
    t_mul_tables,
)
from .search import SearchResult, finetune, search

__all__ = [
    "SearchSpace",
    "complexity_loss",
    "init_alphas",
    "op_dsp",
    "op_muls",
    "select_bits",
    "supernet_apply",
    "t_mul_tables",
    "SearchResult",
    "finetune",
    "search",
]
