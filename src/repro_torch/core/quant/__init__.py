from .fake_quant import (
    act_to_int_levels,
    fake_quant_act,
    fake_quant_weight,
    quantize_unit,
    ste_round,
    weight_tanh_max,
    weight_to_int_levels,
)

__all__ = [
    "act_to_int_levels",
    "fake_quant_act",
    "fake_quant_weight",
    "quantize_unit",
    "ste_round",
    "weight_tanh_max",
    "weight_to_int_levels",
]
