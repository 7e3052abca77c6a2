from .fake_quant import act_to_int_levels, weight_tanh_max, weight_to_int_levels

__all__ = ["act_to_int_levels", "weight_tanh_max", "weight_to_int_levels"]
