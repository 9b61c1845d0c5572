"""The benchmark's seeded inputs: random model weights, drawn on the
device in a few large calls, in the type they are served in.

Each tensor group has its own generator, seeded from the run's seed and
the group's name, so the reference can draw any one layer again without
drawing the ones before it.  The program and the reference are handed
the same bf16 tensors; neither draws its own.
"""
from __future__ import annotations

from .traffic import derive


def _gen(torch, seed: int, tag: str, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, tag))
    return gen


def _dense_group(torch, shapes, std_of, seed, tag, device):
    """One randn call for all ``shapes``, each scaled by ``std_of(shape)``
    and rounded to bf16."""
    total = sum(n * k for n, k in shapes)
    flat = torch.randn(total, generator=_gen(torch, seed, tag, device), device=device,
                       dtype=torch.float32)
    out, at = [], 0
    for n, k in shapes:
        out.append((flat[at:at + n * k].view(n, k) * std_of(n, k)).to(torch.bfloat16))
        at += n * k
    return out


PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def qwen3_layer(torch, model: dict, seed: int, index: int, device) -> dict:
    """Layer ``index``'s projections (bf16, std fan_in^-1/2) and its norm
    weights (ones), under the Hugging Face names."""
    from ..counts import linear_shapes
    ws = _dense_group(torch, linear_shapes(model), lambda n, k: k ** -0.5, seed,
                      f"layer{index}", device)
    layer = dict(zip(PROJECTIONS, ws))
    d, hd = model["hidden_size"], model["head_dim"]
    for name, n in (("input_norm", d), ("post_attn_norm", d), ("q_norm", hd), ("k_norm", hd)):
        layer[name] = torch.ones((n,), dtype=torch.bfloat16, device=device)
    return layer


def qwen3_embed_head(torch, model: dict, seed: int, device):
    """(embedding [V, D] with std 0.02, lm head [V, D] with std D^-1/2 or
    None where ``tie_word_embeddings``, final norm weight)."""
    v, d = model["vocab_size"], model["hidden_size"]
    (embed,) = _dense_group(torch, [(v, d)], lambda n, k: 0.02, seed, "embed", device)
    head = None
    if not model["tie_word_embeddings"]:
        (head,) = _dense_group(torch, [(v, d)], lambda n, k: k ** -0.5, seed, "head", device)
    return embed, head, torch.ones((d,), dtype=torch.bfloat16, device=device)

