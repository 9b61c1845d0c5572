"""Quantized W4A4 linears, MXFP4 and NVFP4 (counterpart of
``qutlass_tpu.nn.linear`` and of the quantized branches of
``qutlass_tpu.models.transformer._linear``), and the Quartet QAT
training linear (``quartet_linear``, ``QuartetLinear``; end of file).

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
from ..kernels.gemm import gemm_int8_rank1
from ..ops import int8path as I8
from ..ops.dispatch import span
from ..ops.emulation import rotate
from ..utils import h128, pad_to_block, resolve_device

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


def mx_alpha(w: Mapping, method: str) -> float:
    """The GEMM alpha of a stored MX weight (a dense one or an expert
    stack): the dequant constants fold into it, 1/3 for an abs-max
    activation (runtime ``method``) and 1/3 for an abs-max weight (the
    stored ``am`` marker)."""
    return (1.0 if method == "quest" else 1 / 3) * (1 / 3 if "am" in w else 1.0)


def mx_linear(x: torch.Tensor, w: Mapping, h: torch.Tensor,
              method: str = "quest") -> torch.Tensor:
    """Apply a stored quantized weight to x [..., K] (bf16) -> [..., N],
    alpha :func:`mx_alpha`."""
    a_mx = mx_alpha(w, method)
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


@span("qt.linear")
def quantized_linear(x: torch.Tensor, w: Mapping, h: torch.Tensor,
                     method: str = "quest") -> torch.Tensor:
    """Apply a stored quantized weight, NVFP4 (``gs`` leaf) or MXFP4."""
    return nv_linear(x, w, h) if "gs" in w else mx_linear(x, w, h, method)


def linear(x: torch.Tensor, w, h: torch.Tensor, method: str,
           quantized: bool) -> torch.Tensor:
    """Apply a stored quantized weight (``quantized``) or a bf16 weight
    [N, K] (an fp32 product) to x [..., K]."""
    if not quantized:
        return (x.to(torch.float32) @ w.to(torch.float32).T).to(x.dtype)
    return quantized_linear(x, w, h, method)


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

    Differences from the JAX package's class: the constructor takes the
    stored dict, ``(stored, h, method)``; JAX's positional form
    ``QuantizedLinear(wqt, wst, h, n, k, method)`` is
    :meth:`from_kmajor`.  ``create`` stores the int8 operand by default
    (``weight_format="fp4"`` keeps JAX's packed fp4) and takes NVFP4.  An
    abs-max weight folds the 1/3 of both operands' 3x-scaled codes into
    alpha; the JAX class multiplies by 1, so its abs-max output is ~9x
    the true one (its QuEST output is the port's).
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

    @classmethod
    def from_kmajor(cls, wqt: torch.Tensor, wst: torch.Tensor, h: torch.Tensor, n: int,
                    k: int, method: str = "quest") -> "QuantizedLinear":
        """The JAX constructor's arguments: a K-major MXFP4 weight from
        ``fusedQuantizeMx(w, h, method=method, layout="kmajor")`` (wqt u8
        [K/2, N], wst u8 [K/32, N]) for w [N, K], stored as packed fp4."""
        wqt, wst = q._as_bytes(wqt), q._as_bytes(wst)
        if tuple(wqt.shape) != (k // 2, n) or tuple(wst.shape) != (k // 32, n):
            raise ValueError(f"wqt {tuple(wqt.shape)} / wst {tuple(wst.shape)} do not match "
                             f"n={n}, k={k}: expected ({k // 2}, {n}) / ({k // 32}, {n})")
        mark = ({"am": torch.ones((), dtype=torch.int8, device=wqt.device)}
                if method == "abs_max" else {})
        return cls({"wqt": wqt, "wst": wst, **mark}, h, method)

    def stored(self) -> dict:
        d = {name: getattr(self, name) for name in _STORED if hasattr(self, name)}
        if self.abs_max_weight:
            d["am"] = True
        return d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quantized_linear(x, self.stored(), self.h, self.method)


# ---------------------------------------------------------------------------
# Quartet QAT training (counterpart of qutlass_tpu.nn.linear.quartet_linear
# and of qutlass_tpu.nn.flax_layers.QuartetDense)
# ---------------------------------------------------------------------------

GRAD_MODES = ("int8", "mxfp8", "bf16")


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for bf16 operands: exact products, fp32 accumulation, one
    rounding of the result to bf16 (the JAX package's bf16 dot into fp32,
    cast to bf16 right after).  On the card one cuBLAS call with an fp32
    output, so split-K partial sums stay fp32 whatever
    ``allow_bf16_reduced_precision_reduction`` says; on the CPU the fp32
    product of the widened operands (bf16 products are exact in fp32)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32).to(torch.bfloat16)
    return (a.to(torch.float32) @ b.to(torch.float32)).to(torch.bfloat16)


def _unrotate(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The inverse (transpose) rotation per contiguous rot-chunk of the
    last axis, fp32 out.  When K is a multiple of 128 the operand is the
    bf16 128-wide block-diagonal kron(I, H^T) and g is read in bf16, as
    in the JAX package; else an fp32 product per chunk."""
    rot, k = h.shape[-1], g.shape[-1]
    if k % 128 == 0:
        ht = h128(h, rot).T.to(torch.float32)
        gr = g.reshape(-1, 128).to(torch.bfloat16).to(torch.float32)
        return (gr @ ht).reshape(g.shape)
    gr = g.reshape(-1, rot).to(torch.float32)
    return (gr @ h.reshape(rot, rot).to(torch.float32).T).reshape(g.shape)


def _unpack_mask_bits(mask: torch.Tensor, k: int) -> torch.Tensor:
    """u8 [..., K/8] -> fp32 0/1 [..., K] (bit i of byte j = element 8j+i)."""
    m = mask.to(torch.int32)
    bits = torch.stack([(m >> i) & 1 for i in range(8)], dim=-1)
    return bits.reshape(*mask.shape[:-1], k).to(torch.float32)


def _unpack_mask_planes(mask_t: torch.Tensor, k: int) -> torch.Tensor:
    """K-major mask bytes [K/8, M] -> 0/1 bf16 [M, K] in plane-major
    column order (``int8path.encode_int8_planes``): column p is natural
    element 2p, column K/2 + p element 2p+1.  Bits {0,2,4,6} of byte j
    are natural elements 8j, 8j+2, ... (plane columns 4j..4j+3); bits
    {1,3,5,7} feed the odd half."""
    bits = _unpack_mask_bits(mask_t.T, k)            # [M, K], natural order
    return torch.cat([bits[:, 0::2], bits[:, 1::2]], dim=-1).to(torch.bfloat16)


def _unrotate_planes(v_p: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Unrotate v_p [R, K] whose K axis is plane-major (column p =
    natural element 2p, column K/2 + p = 2p+1) into natural order, fp32
    out.  Natural 128-block b takes its even elements from plane columns
    [64b, 64b+64) and its odd ones from the same range of the second
    half, so with H^T split into its even and odd rows

        dX_b = v_even_b @ H^T[0::2, :] + v_odd_b @ H^T[1::2, :]

    (two fp32 products of bf16 operands, as the JAX package's dots)."""
    rot = h.shape[-1]
    r, k = v_p.shape
    if k % 128 == 0:
        ht = h128(h, rot).T.to(torch.float32)
        ve = v_p[:, :k // 2].reshape(-1, 64).to(torch.bfloat16).to(torch.float32)
        vo = v_p[:, k // 2:].reshape(-1, 64).to(torch.bfloat16).to(torch.float32)
        return (ve @ ht[0::2] + vo @ ht[1::2]).reshape(r, k)
    v = torch.stack([v_p[:, :k // 2], v_p[:, k // 2:]], dim=-1).reshape(r, k)
    return _unrotate(v, h)


def _int8_quantize_rows(v: torch.Tensor, axis: int):
    """Symmetric int8 quantization of fp32 v per slice along the other
    axis: (int8 codes, fp32 scale amax/127 per slice).  The JAX
    package's ``/ 127.0`` compiles to a multiply by float32(1/127), which
    is what is computed here."""
    s = v.abs().amax(dim=axis) * I8.INV_127
    inv = torch.where(s > 0, 1.0 / s, torch.zeros_like(s))
    return torch.round(v * inv.unsqueeze(axis)).to(torch.int8), s


def quantize_weights_mx(w: torch.Tensor, h: torch.Tensor, method: str = "quest"):
    """Quantize a weight [N, K] once: (e2m1 u8 [N, K/2], e8m0 padded)."""
    return q.fusedQuantizeMx(w, h, method=method)


def quartet_linear_reference_flow(x, w, h, method: str = "quest") -> torch.Tensor:
    """Non-differentiable forward on the row-major reference ops (K1, K4)."""
    xq, xs = q.fusedQuantizeMx(x, h, method=method)
    wq, ws = q.fusedQuantizeMx(w, h, method=method)
    return q.matmul_mxf4_bf16_tn(xq, wq, xs, ws, 1.0)


def _alpha(method: str) -> float:
    """The forward's dequant constant: 1/9 folds the 3x scaling of both
    abs-max operands."""
    return 1.0 if method == "quest" else 1.0 / 9.0


def quartet_forward(x: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                    method: str = "quest"):
    """The Quartet forward: K1 (K-major, with the clip mask for QuEST) on
    x [M, K] and w [N, K], the plane-major int8 encode of both, and K3
    in the K-major x K-major order.  Returns (y bf16 [M, N], residuals
    (xi int8 [K, M], sx f32 [M], wi int8 [K, N], sw f32 [N], mask_t u8
    [K/8, M] or None)); the residuals dequantize exactly
    (``plane * row scale``), so the backward needs no re-decode."""
    if method == "quest":
        xqt, xst, mask_t = q.fusedQuantizeMx(x, h, method=method, return_mask=True,
                                             layout="kmajor")
    else:
        xqt, xst = q.fusedQuantizeMx(x, h, method=method, layout="kmajor")
        mask_t = None
    wqt, wst = q.fusedQuantizeMx(w, h, method=method, layout="kmajor")
    xi, sx, _ = I8.encode_int8_planes(xqt, xst)
    wi, sw, _ = I8.encode_int8_planes(wqt, wst)
    y = I8.matmul_mxf4_bf16_int8_kk(xi, wi, sx, sw, _alpha(method))
    return y, (xi, sx, wi, sw, mask_t)


def quartet_grads_planes(res, gy: torch.Tensor, method: str, grad_mode: str):
    """The backward's two contractions, before the clip mask and the
    unrotation: (dxh bf16 [M, K], dwh bf16 [N, K]), K plane-major.

    ``grad_mode``: "int8" quantizes dY*sw*alpha per row and dY*sx*alpha
    per column to int8 and runs both contractions on K3 (sb = 1, alpha =
    1, so its epilogue is ``float(acc) * scale``); "mxfp8" quantizes dY
    square-double to MXFP8 with K8, then bf16 GEMMs; "bf16" takes dY as
    it is (the exact STE).
    """
    xi, sx, wi, sw, _ = res
    m = gy.shape[0]
    al = _alpha(method)
    if grad_mode == "int8":
        gy32 = gy.to(torch.float32)
        ones_k = torch.ones(wi.shape[0], dtype=torch.float32, device=gy.device)
        gq_d, sg_d = _int8_quantize_rows(gy32 * (sw[None, :] * al), 1)     # [M, N], [M]
        dxh = gemm_int8_rank1(gq_d, wi, sg_d, ones_k, 1.0, a_kmajor=False,
                              b_kmajor=False)
        # the per-column quantization of dY*sx, held transposed ([N, M]) so
        # that both K3 operands run along tokens; the contraction over the
        # M tokens is zero-padded to K3's 16-byte rows (zeros add nothing)
        gq_wt, sg_w = _int8_quantize_rows((gy32 * (sx[:m, None] * al)).T.contiguous(), 1)
        dwh = gemm_int8_rank1(pad_to_block(gq_wt, [1], 16), pad_to_block(xi[:, :m], [1], 16),
                              sg_w, ones_k, 1.0, a_kmajor=False, b_kmajor=False)
        return dxh, dwh
    if grad_mode == "mxfp8":
        g = q.backward_square_double_scaled(gy.to(torch.bfloat16))[:m].to(torch.float32)
    elif grad_mode == "bf16":
        g = gy.to(torch.float32)
    else:
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    # the pow2 row scales of the dequantized operands fold into the
    # gradient side (exact for QuEST, one rounding with alpha = 1/9)
    gyw = (g * (sw[None, :] * al)).to(torch.bfloat16)
    gyx = (g * (sx[:m, None] * al)).to(torch.bfloat16)
    dxh = _bf16_matmul(gyw, wi.to(torch.bfloat16).T)
    dwh = _bf16_matmul(gyx.T, xi[:, :m].to(torch.bfloat16).T)
    return dxh, dwh


def quartet_backward(res, h: torch.Tensor, gy: torch.Tensor, method: str,
                     grad_mode: str):
    """(dx bf16 [M, K], dw bf16 [N, K], dh zeros): the contractions of
    :func:`quartet_grads_planes`, the clip-mask STE (QuEST), and the
    unrotation from plane-major order."""
    mask_t = res[4]
    dxh, dwh = quartet_grads_planes(res, gy, method, grad_mode)
    if method == "quest":
        dxh = dxh * _unpack_mask_planes(mask_t, dxh.shape[1])
    dx = _unrotate_planes(dxh, h).to(torch.bfloat16)
    dw = _unrotate_planes(dwh, h).to(torch.bfloat16)
    return dx, dw, torch.zeros_like(h)


class _QuartetLinearFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, h, method, grad_mode):
        y, res = quartet_forward(x, w, h, method)
        ctx.save_for_backward(*res, h)
        ctx.method, ctx.grad_mode = method, grad_mode
        return y

    @staticmethod
    def backward(ctx, gy):
        *res, h = ctx.saved_tensors
        dx, dw, dh = quartet_backward(res, h, gy, ctx.method, ctx.grad_mode)
        return dx, dw, dh, None, None


def quartet_linear(x: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
                   method: str = "quest", grad_mode: str = "int8") -> torch.Tensor:
    """y = q(x H) @ q(w H)^T with Quartet MXFP4 W4A4 quantization,
    differentiable in x [M, K] and w [N, K] (bf16) through the clip-mask
    STE (QuEST); h [rot, rot] gets a zero gradient.  ``grad_mode`` picks
    the backward arithmetic, all three from the same dequantized forward
    operands: "int8" (default, every contraction on the int8 GEMM),
    "mxfp8" (dY square-double quantized to MXFP8, the reference's
    scheme), "bf16" (the exact STE)."""
    if method not in ("quest", "abs_max"):
        raise ValueError(f"invalid method {method!r}, must be 'quest' or 'abs_max'")
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"unknown grad_mode {grad_mode!r}, must be one of {GRAD_MODES}")
    return _QuartetLinearFn.apply(x, w, h, method, grad_mode)


class QuartetLinear(nn.Module):
    """W4A4 MXFP4 linear for quantization-aware training (counterpart of
    the JAX package's ``QuartetDense``): a bf16 weight [N, K] parameter
    and a ``rot_size`` Hadamard rotation.  In training mode it runs
    :func:`quartet_linear`; in eval mode, as ``QuartetDense``, the weight
    quantized K-major by K1 on every call and ``fused_linear_mxf4`` (K1 +
    K4, or the single kernel K16 under ``QUTLASS_TPU_FUSED_LINEAR``; alpha
    1/9 for abs-max).  The weight starts normal with std K^-0.5, drawn
    from ``generator``; it lives on the card unless ``device`` says
    otherwise."""

    def __init__(self, in_features: int, out_features: int, *, rot_size: int = 32,
                 method: str = "quest", grad_mode: str = "int8", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.empty((out_features, in_features),
                                               dtype=torch.bfloat16, device=dev))
        self.register_buffer("h", q.hadamard_matrix(rot_size, device=dev))
        self.method, self.grad_mode = method, grad_mode
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        n, k = self.weight.shape
        w = torch.randn((n, k), generator=generator, device=self.weight.device) * k ** -0.5
        with torch.no_grad():
            self.weight.copy_(w.to(torch.bfloat16))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, k = self.weight.shape
        x2 = x.reshape(-1, k).to(torch.bfloat16)
        if self.training:
            y = quartet_linear(x2, self.weight, self.h, self.method, self.grad_mode)
        else:
            w = self.weight.detach()
            wqt, wst = q.fusedQuantizeMx(w, self.h, method=self.method, layout="kmajor")
            y = q.fused_linear_mxf4(x2.detach(), wqt, wst, self.h, method=self.method)
        return y.reshape(*x.shape[:-1], n)


class QuartetMLP(nn.Module):
    """The QAT example's model: QuartetLinear(d_in -> d_hidden), SiLU in
    fp32, QuartetLinear(d_hidden -> d_out); keyword arguments go to both
    layers."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, **kwargs):
        super().__init__()
        self.fc1 = QuartetLinear(d_in, d_hidden, **kwargs)
        self.fc2 = QuartetLinear(d_hidden, d_out, **kwargs)

    def set_grad_mode(self, grad_mode: str) -> None:
        self.fc1.grad_mode = self.fc2.grad_mode = grad_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.nn.functional.silu(self.fc1(x).to(torch.float32)).to(torch.bfloat16)
        return self.fc2(y)
