"""Quantized layers."""
from .linear import (QuantizedLinear, mx_linear, nv_linear, quantize_weight,
                     quantized_linear)

__all__ = ["QuantizedLinear", "mx_linear", "nv_linear", "quantize_weight",
           "quantized_linear"]
