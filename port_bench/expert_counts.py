"""The yardstick's arithmetic for LFM2-MoE cells: the work bound of the
grouped expert GEMMs (K18) of a stretch, and the model FLOPs of a step.

A grouped launch runs one projection of one expert layer for every
routed token.  Its least time is the larger of its bytes over the memory
rate and its operations over the int8 peak (``counts.bound_s``): each
expert that got a row reads its weight once (packed fp4 and a scale byte
a 32-group), each routed row reads its activation codes and scales and
writes its bf16 output.  The numbers come from the configuration's shapes
and from the program's routing counter (rows routed, experts active),
never from the kernel that runs them.
"""
from __future__ import annotations

from port_bench import counts


def expert_shapes(model: dict) -> list[tuple[int, int]]:
    """(n, k) of an expert's three projections, weight [n, k]: gate, up, down."""
    d, f = model["hidden_size"], model["moe_intermediate_size"]
    return [(f, d), (f, d), (d, f)]


def expert_gemm_bytes(active: int, rows: int, n: int, k: int, group: int = 32) -> int:
    """Bytes of one grouped launch (or of several summed): ``active``
    expert weights [n, k] read once, ``rows`` routed rows' activation
    codes and scales read and bf16 outputs written."""
    return active * (n * k // 2 + n * k // group) + rows * (k // 2 + k // group) + 2 * rows * n


def expert_gemm_bound_s(active: int, rows: int, n: int, k: int, group: int = 32) -> float:
    return counts.bound_s(expert_gemm_bytes(active, rows, n, k, group), 2 * rows * n * k, "int8")


def expert_gemms(model: dict, routed: list) -> list[tuple[int, int, int, int]]:
    """(active, rows, n, k) of each projection of each expert layer, from
    ``routed``: per expert layer, the routing counter's change over a
    stretch, [rows routed to each expert, calls in which each was active]."""
    out = []
    for rows, active in routed:
        out += [(sum(active), sum(rows), n, k) for n, k in expert_shapes(model)]
    return out


def experts_bound_s(gemms) -> float:
    return sum(expert_gemm_bound_s(a, r, n, k) for a, r, n, k in gemms)


def _layers(model: dict):
    """(mixer, has experts) of each layer."""
    return [(t, i >= model["num_dense_layers"]) for i, t in enumerate(model["layer_types"])]


def linear_flops_per_token(model: dict) -> int:
    """2 N K of every projection a token runs: its mixer's, its dense MLP's
    or its k experts' and the router's."""
    d, hd = model["hidden_size"], model["hidden_size"] // model["num_attention_heads"]
    q, kv = model["num_attention_heads"] * hd, model["num_key_value_heads"] * hd
    total = 0
    for mixer, sparse in _layers(model):
        shapes = [(3 * d, d), (d, d)] if mixer == "conv" else [(q, d), (kv, d), (kv, d), (d, q)]
        if sparse:
            shapes += expert_shapes(model) * model["num_experts_per_tok"]
            shapes.append((model["num_experts"], d))
        else:
            i = model["intermediate_size"]
            shapes += [(i, d), (i, d), (d, i)]
        total += sum(2 * n * k for n, k in shapes)
    return total


def attention_flops(model: dict, context: int) -> int:
    """QK^T and PV of one token attending ``context`` positions, every
    attention layer."""
    return model["layer_types"].count("full_attention") * 4 * model["hidden_size"] * context


def conv_flops(model: dict) -> int:
    """One token's taps, 2 W D a conv layer."""
    return model["layer_types"].count("conv") * 2 * model["conv_L_cache"] * model["hidden_size"]


def prefill_flops(model: dict, length: int) -> int:
    """A prompt of ``length`` real tokens: their linears and taps, token p
    attending p + 1 positions, one logits row."""
    return ((linear_flops_per_token(model) + conv_flops(model)) * length
            + attention_flops(model, 1) * length * (length + 1) // 2 + counts.head_flops(model))


def decode_flops(model: dict, position: int) -> int:
    return (linear_flops_per_token(model) + conv_flops(model)
            + attention_flops(model, position + 1) + counts.head_flops(model))
