"""Boundary activation codecs (``simulate``: quantize -> dequantize in fp)."""
from .simulate import (
    token_select_mask,
    top_rho_mask,
    int4_token_select,
    simulate_symmetric,
    per_token_affine_int8,
    channel_wise_quant,
    CHANNEL_METHODS,
)

__all__ = [
    "token_select_mask",
    "top_rho_mask",
    "int4_token_select",
    "simulate_symmetric",
    "per_token_affine_int8",
    "channel_wise_quant",
    "CHANNEL_METHODS",
]
