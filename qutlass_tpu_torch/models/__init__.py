"""Model family (Qwen3 / Llama-3.1 geometries, and LFM2-MoE's hybrid of
short-conv and attention layers with a dropless expert layer) and serving
harness on the MXFP4 and NVFP4 W4A4 paths, and the loader of the QAT
example's weights."""
from .convert import params_from_numpy, quartet_mlp_from_numpy, tensor_from_numpy
from .serving import decode_step, generate, prefill, sample_logits
from .transformer import (LFM2_24B_A2B, LLAMA31_8B, LLAMA31_70B, QWEN3_8B, QWEN3_14B,
                          QWEN3_32B, ModelConfig, calibrate_nv_gsx, forward, init_cache,
                          init_params, quantize_model_weights, quantize_weight,
                          tiny_config)

__all__ = ["ModelConfig", "QWEN3_8B", "QWEN3_14B", "QWEN3_32B", "LLAMA31_8B",
           "LLAMA31_70B", "LFM2_24B_A2B", "tiny_config", "init_params", "quantize_weight",
           "quantize_model_weights", "calibrate_nv_gsx", "forward", "init_cache",
           "prefill", "decode_step", "sample_logits", "generate",
           "params_from_numpy", "quartet_mlp_from_numpy", "tensor_from_numpy"]
