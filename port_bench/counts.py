"""The yardstick's arithmetic: peaks of the card, the least time of a
kernel's work (its roofline bound), and the model FLOPs of a step.

The bound is a frozen copy of ``chip_smoke.py``'s ``bound`` and
``gemm_bound`` (the larger of the bytes over the memory rate and the
operations over the peak of the operands' type) with the published peaks
of one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).  A GEMM
of fp4 operands is bounded at the int8 peak: doubled e2m1 values are
exact in int8, and the H100 has no fp4 tensor core.

Every count here comes from the shapes a cell runs (its configuration and
its traffic), never from the kernel that happens to run them, so a later
change of kernel leaves the yardstick as it is.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp8": 1979e12, "int8": 1979e12, "fp32": 67e12,
                  "fp64": 33.5e12}
MFU_PEAK = PEAK_OPS_PER_S["int8"]    # the W4A4 GEMMs run on the int8 tensor cores


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    """The least seconds of a kernel that moves ``nbytes`` and does
    ``ops`` operations of type ``kind``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


# the scale group of each fp4 format along k
GROUP = {"mxfp4": 32, "nvfp4": 16}


def fp4_gemm_bytes(m: int, n: int, k: int, group: int = 32) -> int:
    """Bytes of one W4A4 GEMM read or written once: fp4 codes of the
    activation [m, k] and the weight [n, k] (half a byte each), one scale
    byte a group of ``group`` along k for each, and the bf16 output."""
    return (m * k + n * k) // 2 + (m * k + n * k) // group + 2 * m * n


def fp4_gemm_bound_s(m: int, n: int, k: int, group: int = 32) -> float:
    return bound_s(fp4_gemm_bytes(m, n, k, group), 2 * m * n * k, "int8")


def linear_shapes(model: dict) -> list[tuple[int, int]]:
    """(n, k) of the seven projections of one Qwen3 block, weight [n, k]."""
    d, i = model["hidden_size"], model["intermediate_size"]
    q = model["num_attention_heads"] * model["head_dim"]
    kv = model["num_key_value_heads"] * model["head_dim"]
    return [(q, d), (kv, d), (kv, d), (d, q), (i, d), (i, d), (d, i)]


def gemms_of_rows(model: dict, rows: int) -> list[tuple[int, int, int]]:
    """(m, n, k) of every projection GEMM of one forward over ``rows``
    token rows through all layers."""
    per = [(rows, n, k) for n, k in linear_shapes(model)]
    return per * model["num_hidden_layers"]


def fp4_gemms_bound_s(gemms, group: int = 32) -> float:
    return sum(fp4_gemm_bound_s(m, n, k, group) for m, n, k in gemms)


def linear_flops_per_token(model: dict) -> int:
    return model["num_hidden_layers"] * sum(2 * n * k for n, k in linear_shapes(model))


def attention_flops(model: dict, context: int) -> int:
    """QK^T and PV of one token attending ``context`` positions, all layers."""
    return (model["num_hidden_layers"] * 4 * model["num_attention_heads"] * model["head_dim"]
            * context)


def head_flops(model: dict) -> int:
    """The lm head of one logits row."""
    return 2 * model["vocab_size"] * model["hidden_size"]


def prefill_flops(model: dict, length: int) -> int:
    """A prompt of ``length`` real tokens (padding is not useful work):
    every token's linears, token p attending p + 1 positions, and one
    logits row."""
    lin = linear_flops_per_token(model) * length
    att = attention_flops(model, 1) * length * (length + 1) // 2
    return lin + att + head_flops(model)


def decode_flops(model: dict, position: int) -> int:
    """One decoded token at ``position``: linears, attention over
    position + 1 positions, one logits row."""
    return (linear_flops_per_token(model) + attention_flops(model, position + 1)
            + head_flops(model))

