"""Quantized W4A4 linears, MXFP4 and NVFP4 (counterpart of
``qutlass_tpu.nn.linear`` and of the quantized branches of
``qutlass_tpu.models.transformer._linear``, inference part).

A weight [N, K] is quantized once, K-major, and stored as a dict whose
leaves say which evaluator runs it.  MXFP4 (group 32, e8m0): the int8
operand (``wi8`` int8 [N, K], ``wsb`` f32 [N]) or, when its
row-exponent spread exceeds the int8 budget, packed fp4 (``wqt`` u8
[K/2, N], ``wst`` u8 [K/32, N]).  NVFP4 (group 16, e4m3, two-level
scales): ``gs`` (the weight's global scale) beside the int8 operand
(``nvi8`` int8 [K, N], ``nvsb`` f32 [N]) or packed fp4 (``wqt``, ``wst``
u8 [K/16, N]), and optionally ``gsx``, a calibrated activation global
scale.  Each call quantizes the activation and runs the matching GEMM:

  MX int8 weight:  fusedQuantizeMxInt8 (K2) -> int8 GEMM (K3)
  MX fp4 weight:   fusedQuantizeMx(kmajor) (K1) -> decode GEMM (K4)
  NV int8 weight:  fusedQuantizeNvInt8 (K6) -> int8 GEMM, K-major x
                   K-major (K3)
  NV fp4 weight:   fusedQuantizeNv(kmajor) (K5) -> NV decode GEMM (K7)
"""
from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn

import qutlass_tpu_torch as q
from ..ops import int8path as I8
from ..ops.emulation import rotate

_STORED = ("wi8", "wsb", "wqt", "wst", "nvi8", "nvsb", "gs", "gsx")
# vLLM's NVFP4 global-scale convention: gs = 448 * 6 / amax puts the
# largest group's e4m3 scale at the e4m3 maximum
_NV_GS_NUM = 448.0 * 6.0

# Calibration recorder of ``transformer.calibrate_nv_gsx``: while it is
# a dict, each NV linear on the exact-gsx path records
# {id(weight dict): largest rotated activation amax seen}.
_NV_CALIB: dict | None = None


def rotated_amax(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """max |x H| over the per-``rot``-chunk rotation (a plain fp32
    product, which the JAX package leaves to XLA), on x's device."""
    return rotate(x, h, h.shape[-1]).abs().amax()


def nv_global_scale(amax: torch.Tensor) -> torch.Tensor:
    """``448*6 / max(amax, 1e-6)`` in fp32, on amax's device."""
    a = amax.to(torch.float32)
    # a true division: ``number / tensor`` would multiply by a reciprocal
    return torch.full_like(a, _NV_GS_NUM) / torch.maximum(a, torch.full_like(a, 1e-6))


def quantize_weight(w: torch.Tensor, *, h: torch.Tensor, method: str = "quest",
                    fmt: str = "mx", weight_format: str = "int8") -> dict:
    """Quantize one [N, K] weight to its stored evaluator dict.

    MX: ``weight_format="int8"`` stores the int8 operand when the
    weight's max deficit is <= 3 (then the int8 evaluation is bit-exact)
    and keeps packed fp4 otherwise; ``"fp4"`` always stores packed fp4
    (half the bytes).  abs-max weights carry an ``"am"`` marker: their
    stored codes are 3x-scaled, which the linear folds back out.

    NV (``fmt="nv"``): abs-max scales under the weight's global scale
    ``gs = 448*6 / max|w H|`` (a QuEST ``method`` maps to abs-max, as in
    the JAX package); ``"int8"`` stores the natural-K-order int8 operand
    (bounded rounding, no exactness regime), ``"fp4"`` packed fp4.
    """
    if weight_format not in ("int8", "fp4"):
        raise ValueError(f"invalid weight_format {weight_format!r}")
    if fmt not in ("mx", "nv"):
        raise ValueError(f"invalid fmt {fmt!r}")
    if fmt == "nv":
        m = "abs_max" if method == "quest" else method
        gsw = nv_global_scale(rotated_amax(w, h))
        wqt, wst = q.fusedQuantizeNv(w, h, gsw, method=m, layout="kmajor")
        if weight_format == "int8":
            nvi8, nvsb = I8.prepare_weight_nv_int8(wqt, wst)
            return {"nvi8": nvi8, "nvsb": nvsb, "gs": gsw}
        return {"wqt": wqt, "wst": wst, "gs": gsw}
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


def nv_linear(x: torch.Tensor, w: Mapping, h: torch.Tensor) -> torch.Tensor:
    """Apply a stored NVFP4 weight (``gs`` leaf) to x [..., K] (bf16).

    The activation's global scale is the stored ``gsx`` when calibrated,
    else computed per call from the rotated activation's exact amax (a
    second rotation of x, on the card).  Activations are always abs-max
    quantized; ``alpha = 1/(gsx*gs)`` folds both global scales out.
    Every scale stays on the activation's device.
    """
    if "nvi8" in w:
        k, n = w["nvi8"].shape
    else:
        k, n = w["wqt"].shape[0] * 2, w["wqt"].shape[1]
    x2 = x.reshape(-1, k)
    if "gsx" in w:
        gsx = torch.as_tensor(w["gsx"], dtype=torch.float32,
                              device=x.device).reshape(())
    else:
        amax = rotated_amax(x2, h)
        if _NV_CALIB is not None:
            _NV_CALIB[id(w)] = max(float(amax), _NV_CALIB.get(id(w), 0.0))
        gsx = nv_global_scale(amax)
    alpha = 1.0 / (gsx * w["gs"])
    if "nvi8" in w:
        xi, sx, _ = q.fusedQuantizeNvInt8(x2, h, gsx, method="abs_max")
        y = I8.matmul_mxf4_bf16_int8_kk(xi, w["nvi8"], sx, w["nvsb"], alpha)
    else:
        xqt, xst = q.fusedQuantizeNv(x2, h, gsx, method="abs_max",
                                     layout="kmajor")
        y = q.matmul_nvf4_bf16_kmajor(xqt, w["wqt"], xst, w["wst"], alpha)
    return y.reshape(*x.shape[:-1], n)


def quantized_linear(x: torch.Tensor, w: Mapping, h: torch.Tensor,
                     method: str = "quest") -> torch.Tensor:
    """Apply a stored quantized weight, NVFP4 (``gs`` leaf) or MXFP4."""
    return nv_linear(x, w, h) if "gs" in w else mx_linear(x, w, h, method)


class QuantizedLinear(nn.Module):
    """W4A4 linear (MXFP4 or NVFP4) holding its quantized weight as
    buffers.

    Usage::

        lin = QuantizedLinear.create(w, h)              # quantize once
        nv = QuantizedLinear.create(w, h, fmt="nv")
        y = lin(x)                                      # prefill / decode

    Buffers are the stored leaves of :func:`quantize_weight`: MX
    ``wi8``/``wsb`` or ``wqt``/``wst``; NV ``nvi8``/``nvsb`` or
    ``wqt``/``wst``, with ``gs`` (and ``gsx`` once calibrated); plus the
    rotation ``h``.
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
               weight_format: str = "int8", fmt: str = "mx") -> "QuantizedLinear":
        return cls(quantize_weight(w, h=h, method=method, fmt=fmt,
                                   weight_format=weight_format), h, method)

    def stored(self) -> dict:
        d = {name: getattr(self, name) for name in _STORED if hasattr(self, name)}
        if self.abs_max_weight:
            d["am"] = True
        return d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quantized_linear(x, self.stored(), self.h, self.method)
