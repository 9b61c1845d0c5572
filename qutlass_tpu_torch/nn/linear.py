"""Quantized MXFP4 W4A4 linear (counterpart of ``qutlass_tpu.nn.linear``,
inference part).

A weight [N, K] is quantized once, K-major, and stored either as the
int8 evaluator's operand (``wi8`` int8 [N, K], ``wsb`` f32 [N]) or, when
its row-exponent spread exceeds the int8 budget, as packed fp4 (``wqt``
u8 [K/2, N], ``wst`` u8 [K/32, N]).  Each call quantizes the activation
and runs the matching GEMM:

  int8 weight:  fusedQuantizeMxInt8 (kernel K2) -> int8 GEMM + rank-1
                epilogue (kernel K3)
  fp4 weight:   fusedQuantizeMx(layout="kmajor") (kernel K1) -> decode
                GEMM (kernel K4)
"""
from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn

import qutlass_tpu_torch as q
from ..ops import int8path as I8

_STORED = ("wi8", "wsb", "wqt", "wst")


def quantize_weight(w: torch.Tensor, *, h: torch.Tensor, method: str = "quest",
                    weight_format: str = "int8") -> dict:
    """Quantize one [N, K] weight to its stored evaluator dict.

    ``weight_format="int8"`` stores the int8 operand when the weight's
    max deficit is <= 3 (then the int8 evaluation is bit-exact) and keeps
    packed fp4 otherwise; ``"fp4"`` always stores packed fp4 (half the
    bytes).  abs-max weights carry an ``"am"`` marker: their stored codes
    are 3x-scaled, which the linear folds back out.
    """
    if weight_format not in ("int8", "fp4"):
        raise ValueError(f"invalid weight_format {weight_format!r}")
    wqt, wst = q.fusedQuantizeMx(w, h, method=method, layout="kmajor")
    mark = ({"am": torch.ones((), dtype=torch.int8, device=w.device)}
            if method == "abs_max" else {})
    if weight_format == "int8":
        wi8, wsb, dmax = I8.prepare_weight_int8(wqt, wst)
        if int(dmax) <= 3:
            return {"wi8": wi8, "wsb": wsb, **mark}
    return {"wqt": wqt, "wst": wst, **mark}


def mx_linear(x: torch.Tensor, w: Mapping, h: torch.Tensor,
              method: str = "quest") -> torch.Tensor:
    """Apply a stored quantized weight to x [..., K] (bf16) -> [..., N].

    The dequant constants fold into alpha: 1/3 for an abs-max activation
    (runtime ``method``) and 1/3 for an abs-max weight (stored marker).
    """
    a_mx = ((1.0 if method == "quest" else 1 / 3)
            * (1 / 3 if "am" in w else 1.0))
    if "wi8" in w:
        n, k = w["wi8"].shape
        ai, sa, _ = q.fusedQuantizeMxInt8(x.reshape(-1, k), h, method=method)
        y = I8.matmul_mxf4_bf16_int8_kmajor(ai, w["wi8"], sa, w["wsb"], a_mx)
    else:
        wqt, wst = w["wqt"], w["wst"]
        k, n = wqt.shape[0] * 2, wqt.shape[1]
        xqt, xst = q.fusedQuantizeMx(x.reshape(-1, k), h, method=method,
                                     layout="kmajor")
        y = q.matmul_mxf4_bf16_kmajor(xqt, wqt, xst, wst, a_mx)
    return y.reshape(*x.shape[:-1], n)


class QuantizedLinear(nn.Module):
    """MXFP4 W4A4 linear holding its quantized weight as buffers.

    Usage::

        lin = QuantizedLinear.create(w, h)        # quantize once
        y = lin(x)                                # prefill / decode

    Buffers are ``wi8``/``wsb`` (int8 evaluator) or ``wqt``/``wst``
    (packed fp4), plus the rotation ``h``.
    """

    def __init__(self, stored: Mapping, h: torch.Tensor, method: str = "quest"):
        super().__init__()
        for name in _STORED:
            if name in stored:
                self.register_buffer(name, stored[name])
        self.register_buffer("h", h)
        self.abs_max_weight = "am" in stored
        self.method = method

    @classmethod
    def create(cls, w: torch.Tensor, h: torch.Tensor, method: str = "quest",
               weight_format: str = "int8") -> "QuantizedLinear":
        return cls(quantize_weight(w, h=h, method=method,
                                   weight_format=weight_format), h, method)

    def stored(self) -> dict:
        d = {name: getattr(self, name) for name in _STORED if hasattr(self, name)}
        if self.abs_max_weight:
            d["am"] = True
        return d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mx_linear(x, self.stored(), self.h, self.method)
