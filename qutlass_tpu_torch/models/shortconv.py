"""The gated short-convolution mixer of LFM2 (``Lfm2ShortConv``):

    B, C, x = in_proj(h).chunk(3)           [..., 3D] -> three [..., D]
    y = out_proj(C * conv(B * x))

``conv`` is depthwise and causal over positions, ``W`` taps a channel
(LFM2's ``conv_L_cache``, ``CONV_WIDTH``), no bias: out[t] = sum_j w[j]
(B x)[t - W + 1 + j], the oldest input first.  ``in_proj`` [3D, D] and ``out_proj`` [D, D]
are W4A4 linears like every projection; the taps ``conv`` [D, W] stay bf16.

Precision: ``B * x`` is formed in fp32 (a product of two bf16 values,
exact), the taps are added in fp32 in that fixed order, oldest first, one
rounding a step (``((i0 w0 + i1 w1) + i2 w2)``), and ``C * conv`` is fp32,
rounded once to bf16 before ``out_proj``.  Every step is elementwise, so
no shape changes a bit.

State: the conv's last ``W - 1`` inputs of each row, fp32 [B, W - 1, D],
oldest first, zero before a sequence's first position.  It lives in the
layer's cache entry (``"conv"``) beside the attention layers' keys and
values, and is updated in place: after a ragged prefill each row keeps the
inputs at its own last positions (zeros where the prompt is shorter than
the window), after a decode step the window moves by one.
"""
from __future__ import annotations

import torch

from ..nn.linear import linear
from ..ops.dispatch import span

CONV_WIDTH = 3                     # the taps of a channel, W


@span("qt.conv")
def short_conv(layer: dict, x: torch.Tensor, state: torch.Tensor, h, method: str,
               quantized: bool, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The mixer over x [B, T, D] (bf16, normed) -> [B, T, D] bf16.

    ``state`` [B, W - 1, D] fp32 holds the inputs before x's first
    position; it is updated in place to each row's last ``W - 1`` inputs:
    those before ``lengths[b]`` where ``lengths`` [B] is given (a ragged
    batch), else those of all T positions."""
    b, t, d = x.shape
    bg, cg, xg = linear(x, layer["in_proj"], h, method, quantized).chunk(3, dim=-1)
    bx = bg.to(torch.float32) * xg.to(torch.float32)
    taps = layer["conv"].to(torch.float32)                   # [D, W]
    width = taps.shape[1]
    full = torch.cat([state, bx], dim=1)                     # [B, W - 1 + T, D]
    conv = full[:, 0:t] * taps[:, 0]
    for j in range(1, width):
        conv = conv + full[:, j:j + t] * taps[:, j]
    if lengths is None:
        state.copy_(full[:, t:])
    else:              # full's index of input position p is p + W - 1
        idx = lengths[:, None] + torch.arange(width - 1, device=x.device)
        state.copy_(full.gather(1, idx[..., None].expand(b, width - 1, d)))
    y = (cg.to(torch.float32) * conv).to(torch.bfloat16)
    return linear(y, layer["out_proj"], h, method, quantized)
