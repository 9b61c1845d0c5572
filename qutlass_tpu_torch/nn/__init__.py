"""Quantized layers: the serving linears and the Quartet QAT linear."""
from .linear import (QuantizedLinear, QuartetLinear, QuartetMLP, mx_linear,
                     nv_linear, quantize_weight, quantize_weights_mx,
                     quantized_linear, quartet_linear,
                     quartet_linear_reference_flow)

__all__ = ["QuantizedLinear", "QuartetLinear", "QuartetMLP", "mx_linear",
           "nv_linear", "quantize_weight", "quantize_weights_mx",
           "quantized_linear", "quartet_linear", "quartet_linear_reference_flow"]
