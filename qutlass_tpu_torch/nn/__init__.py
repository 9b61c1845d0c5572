"""Quantized layers."""
from .linear import QuantizedLinear, mx_linear, quantize_weight

__all__ = ["QuantizedLinear", "mx_linear", "quantize_weight"]
