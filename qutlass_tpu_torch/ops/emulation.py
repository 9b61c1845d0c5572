"""Plain PyTorch versions of the MX, NV and MXFP8 ops (counterpart of
``qutlass_tpu.ops.emulation``: the serving parts and the QAT backward
ops).

Each function here is the plain version of one hand-written kernel in
``qutlass_tpu_torch/csrc``: the kernel wrappers call it for tensors on
the CPU, the CPU tests hold it against the JAX package, and
``chip_smoke.py`` holds each kernel against it on the card.  It runs on
any device and uses the shared codecs, so its arithmetic is the spec
the kernels follow.
"""
from __future__ import annotations

import torch

from ..formats import codecs as C
from ..utils import round_up


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def rotate(x: torch.Tensor, h: torch.Tensor, rot_size: int) -> torch.Tensor:
    """Apply the per-``rot_size``-chunk rotation in fp32: [..., G, r] @ h."""
    xr = x.reshape(-1, rot_size).to(torch.float32)
    hh = h.reshape(rot_size, rot_size).to(x.dtype).to(torch.float32)
    return (xr @ hh).reshape(x.shape)


def rotate_ordered(x: torch.Tensor, h: torch.Tensor, rot_size: int) -> torch.Tensor:
    """:func:`rotate` with each output summed over i = 0 .. rot_size-1 in
    order, ``v = float32(v + x[i] * h[i][c])`` from v = 0: the order of
    the kernels' fp32 ``fmaf`` chain.  The two agree bit for bit because a
    product of two bf16 values is exact in fp32 (8 + 8 significand bits)
    wherever it is a normal fp32 number, so the FMA's one rounding is the
    add's."""
    xr = x.reshape(-1, rot_size).to(torch.float32)
    hh = h.reshape(rot_size, rot_size).to(x.dtype).to(torch.float32)
    v = torch.zeros_like(xr)
    for i in range(rot_size):
        v = v + xr[:, i:i + 1] * hh[i]
    return v.reshape(x.shape)


def butterfly_sum(g: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two wide) in the kernels' xor
    butterfly order: offsets n/2, n/4, ..., 1, each step
    ``v = v + v[..., idx ^ o]``; every position ends with the same sum."""
    n = g.shape[-1]
    idx = torch.arange(n, device=g.device)
    o = n // 2
    while o:
        g = g + g[..., idx ^ o]
        o //= 2
    return g[..., 0]


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """int e2m1 codes [..., K] -> packed uint8 [..., K/2] (2i low nibble)."""
    c = codes.to(torch.int32)
    return (c[..., 0::2] | (c[..., 1::2] << 4)).to(torch.uint8)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """packed uint8 [..., K/2] -> int32 codes [..., K]."""
    p = packed.to(torch.int32)
    return torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(
        *p.shape[:-1], -1)


def pack_mask(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., K] -> uint8 [..., K/8] (bit i of byte j = element 8j+i)."""
    b = bits.to(torch.int32).reshape(*bits.shape[:-1], -1, 8)
    w = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b * w).sum(-1).to(torch.uint8)


def padded_scales(bytes2d: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Place [rows, cols] scale bytes into the x128/x4 padded buffer."""
    pr, pc = round_up(rows, 128), round_up(cols, 4)
    if (pr, pc) == (rows, cols):
        return bytes2d
    out = torch.zeros((pr, pc), dtype=bytes2d.dtype, device=bytes2d.device)
    out[:rows, :cols] = bytes2d
    return out


def as_alpha(alpha, device) -> torch.Tensor:
    """alpha (python float or a 1-element tensor) -> 0-dim fp32 tensor."""
    return torch.as_tensor(alpha, dtype=torch.float32, device=device).reshape(())


def check_out_dtype(out_dtype) -> torch.dtype:
    """A GEMM's output type: bf16 (rounded to nearest even from the fp32
    result) or fp32 (the result itself, as tensor-parallel partial sums
    take it)."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be torch.bfloat16 or torch.float32, got {out_dtype!r}")
    return out_dtype


# ---------------------------------------------------------------------------
# fused quantize (plain versions of kernels K1, K2, K5, K6)
# ---------------------------------------------------------------------------

def fused_quantize_mx(a: torch.Tensor, h: torch.Tensor, *, rot_size: int,
                      method: str = "quest", return_mask: bool = False,
                      layout: str = "rowmajor"):
    """Rotate + quantize to MXFP4 (group 32, e8m0 scales).

    ``layout="rowmajor"``: (packed u8 [..., K/2], scale bytes u8 padded
    [round_up(rows, 128), round_up(K/32, 4)][, mask u8 [..., K/8]]).
    ``layout="kmajor"``: (packed u8 [K/2, rows], scales u8 [K/32, rows]
    [, mask u8 [K/8, rows]]).  ``layout="kmajor_codes"``: unpacked codes
    u8 [K, rows] instead of packed nibbles.
    """
    return _quantize_mx(a, h, rot_size, method, return_mask, layout, rotate,
                        lambda t: t.sum(-1))


def fused_quantize_mx_ordered_plain(a: torch.Tensor, h: torch.Tensor, *, rot_size: int,
                                    method: str = "quest", return_mask: bool = False,
                                    layout: str = "rowmajor"):
    """:func:`fused_quantize_mx` with the kernels' orders of sums: the
    rotation by :func:`rotate_ordered` (one fp32 chain in ascending i) and
    the QuEST sums of each 32-group by :func:`butterfly_sum` (offsets 16,
    8, 4, 2, 1).  The tests and ``chip_smoke.py`` hold kernel K1 to it
    bit for bit; K16 quantizes its activation in the same orders.  The public CPU route
    stays :func:`fused_quantize_mx`, whose sums are cuBLAS's and XLA's."""
    return _quantize_mx(a, h, rot_size, method, return_mask, layout, rotate_ordered,
                        butterfly_sum)


def _quantize_mx(a, h, rot_size, method, return_mask, layout, rot_fn, sum_fn):
    k = a.shape[-1]
    rows = a.numel() // k
    xh = rot_fn(a, h, rot_size)
    g = xh.reshape(-1, k // 32, 32)
    if method == "quest":
        scale = C.mx_scale_quest(sum_fn(g), sum_fn(g * g), 32.0)
    else:
        scale = C.mx_scale_absmax(g.abs().amax(-1))
    scale_f, byte = C.pow2_floor_e8m0(scale)
    q = g / scale_f[..., None]
    if method != "quest":
        q = q * 3.0
    q = q.reshape(xh.shape)

    codes = C.e2m1_rtne_codes(q)
    sbytes = byte.reshape(rows, k // 32).to(torch.uint8)
    mask = pack_mask(q.abs() < 6.0) if return_mask else None
    if layout in ("kmajor", "kmajor_codes"):
        c2 = codes.reshape(rows, k)
        out = (c2.T.to(torch.uint8).contiguous() if layout == "kmajor_codes"
               else pack_codes(c2).T.contiguous())
        res = (out, sbytes.T.contiguous())
        if return_mask:
            res += (mask.reshape(rows, k // 8).T.contiguous(),)
        return res
    res = (pack_codes(codes), padded_scales(sbytes, rows, k // 32))
    return res + (mask,) if return_mask else res


def fused_quantize_mx_int8(a: torch.Tensor, h: torch.Tensor, *,
                           rot_size: int, method: str = "quest"):
    """Plain version of kernel K2: the kmajor-codes quantize composed with
    ``int8path.encode_int8``.  Returns (a' int8 [K, rows], row scale f32
    [rows], scale bytes u8 [K/32, rows])."""
    from . import int8path as I8
    cq, cs = fused_quantize_mx(a, h, rot_size=rot_size, method=method,
                               layout="kmajor_codes")
    ai, sa, _ = I8.encode_int8(cq, cs, kmajor=True)
    return ai, sa, cs


def fused_quantize_nv(a: torch.Tensor, h: torch.Tensor, global_scale, *,
                      rot_size: int, method: str = "abs_max",
                      layout: str = "rowmajor"):
    """Plain version of kernel K5: rotate + quantize to NVFP4 (group 16,
    e4m3 scale bytes; abs-max scales through ``global_scale``).

    ``layout="rowmajor"``: (packed u8 [..., K/2], scale bytes u8 padded
    [round_up(rows, 128), round_up(K/16, 4)]).  ``layout="kmajor"``:
    (packed u8 [K/2, rows], scale bytes u8 [K/16, rows]).
    """
    return _quantize_nv(a, h, global_scale, rot_size, method, layout, rotate,
                        lambda t: t.sum(-1))


def fused_quantize_nv_ordered_plain(a: torch.Tensor, h: torch.Tensor, global_scale, *,
                                    rot_size: int, method: str = "abs_max",
                                    layout: str = "rowmajor"):
    """:func:`fused_quantize_nv` with the kernels' orders of sums: the
    rotation by :func:`rotate_ordered` and the QuEST sums of each 16-group
    by :func:`butterfly_sum` (offsets 8, 4, 2, 1).  The tests and
    ``chip_smoke.py`` hold kernel K5 to it bit for bit; K17 quantizes its
    activation in the same orders.  The public CPU route stays
    :func:`fused_quantize_nv`."""
    return _quantize_nv(a, h, global_scale, rot_size, method, layout, rotate_ordered,
                        butterfly_sum)


def _quantize_nv(a, h, global_scale, rot_size, method, layout, rot_fn, sum_fn):
    k = a.shape[-1]
    rows = a.numel() // k
    xh = rot_fn(a, h, rot_size)
    g = xh.reshape(-1, k // 16, 16)
    if method == "abs_max":
        byte, mul = C.nv_absmax_scale_bytes(g.abs().amax(-1),
                                            as_alpha(global_scale, a.device))
    else:
        byte, mul = C.nv_quest_scale_bytes(sum_fn(g), sum_fn(g * g))
    codes = C.e2m1_rtne_codes((g * mul[..., None]).reshape(xh.shape))
    sbytes = byte.reshape(rows, k // 16).to(torch.uint8)
    if layout == "kmajor":
        return (pack_codes(codes.reshape(rows, k)).T.contiguous(),
                sbytes.T.contiguous())
    return pack_codes(codes), padded_scales(sbytes, rows, k // 16)


def fused_quantize_nv_int8(a: torch.Tensor, h: torch.Tensor, global_scale, *,
                           rot_size: int, method: str = "abs_max"):
    """Plain version of kernel K6: the kmajor NV quantize composed with
    ``int8path.encode_nv_int8``.  Returns (a' int8 [K, rows], sigma f32
    [rows], e4m3 scale bytes u8 [K/16, rows])."""
    from . import int8path as I8
    qk, sk = fused_quantize_nv(a, h, global_scale, rot_size=rot_size,
                               method=method, layout="kmajor")
    ai, sigma = I8.encode_nv_int8(qk, sk)
    return ai, sigma, sk


# ---------------------------------------------------------------------------
# block-scaled GEMM (plain version of kernel K4)
# ---------------------------------------------------------------------------

def dequant_fp4(codes: torch.Tensor, scale_bytes: torch.Tensor) -> torch.Tensor:
    """e2m1 codes [R, K] + e8m0 bytes [R, K/32] -> exact bf16 [R, K]."""
    sexp = scale_bytes.to(torch.int32).repeat_interleave(32, dim=-1)
    return C.e2m1_decode_scaled_bf16(codes, sexp)


def matmul_mxf4_codes(a_codes: torch.Tensor, b_codes: torch.Tensor,
                      a_sf: torch.Tensor, b_sf: torch.Tensor,
                      alpha, out_dtype=torch.bfloat16) -> torch.Tensor:
    """out[M, N] = out_dtype((dq(a) @ dq(b)^T) * alpha) from codes [M, K]
    / [N, K] and scale bytes [M, K/32] / [N, K/32].

    The dequantized operands are exact in bf16 and their products exact
    in fp32; the sum is taken in fp64 (exact for any real operand) and
    rounded once to fp32, which is what an fp32 accumulation gives
    whenever its partial sums are exact, then scaled by alpha in fp32.
    """
    av = dequant_fp4(a_codes, a_sf).to(torch.float64)
    bv = dequant_fp4(b_codes, b_sf).to(torch.float64)
    acc = (av @ bv.T).to(torch.float32)
    return (acc * as_alpha(alpha, acc.device)).to(check_out_dtype(out_dtype))


def matmul_mxf4_bf16_tn(a, b, a_sf, b_sf, alpha, out_dtype=torch.bfloat16):
    """W4A4 block-scaled GEMM: a/b packed u8 [M, K/2] / [N, K/2],
    scale bytes [M, K/32] / [N, K/32] (row-major)."""
    return matmul_mxf4_codes(unpack_codes(a), unpack_codes(b), a_sf, b_sf,
                             alpha, out_dtype)


def matmul_mxf4_bf16_kmajor(at, bt, a_sft, b_sft, alpha, out_dtype=torch.bfloat16):
    """K-major variant: at/bt packed u8 [K/2, M] / [K/2, N], scales
    [K/32, M] / [K/32, N]."""
    return matmul_mxf4_bf16_tn(at.T, bt.T, a_sft.T, b_sft.T, alpha, out_dtype)


def matmul_mxf4_bf16_kmajor_codes(at, bt, a_sft, b_sft, alpha, out_dtype=torch.bfloat16):
    """Unpacked-activation-codes variant: at codes u8 [K, M]."""
    return matmul_mxf4_codes(at.T, unpack_codes(bt.T), a_sft.T, b_sft.T,
                             alpha, out_dtype)


def gemm_fp4_experts_plain(a, a_sf, b, b_sf, offsets, alpha, *, rows=None, counts=None,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of K18, the grouped expert GEMM: output rows
    [offsets[e], offsets[e + 1]) are ``matmul_mxf4_bf16_kmajor`` of the
    activation columns ``rows[r]`` (r itself where ``rows`` is None) of a
    [K/2, Ma] / a_sf [K/32, Ma] against expert e's b[e] [K/2, N] / b_sf[e]
    [K/32, N]; rows no expert owns are zero.  ``counts`` [2, E] int64
    gains each expert's row count and whether it has any."""
    r = a.shape[1] if rows is None else rows.shape[0]
    cols = torch.arange(r, device=a.device) if rows is None else rows.to(torch.int64)
    out = torch.zeros((r, b.shape[2]), dtype=check_out_dtype(out_dtype), device=a.device)
    off = offsets.tolist()
    if counts is not None:
        n = offsets.diff().to(torch.int64)
        counts += torch.stack([n, (n > 0).to(torch.int64)])
    for e in range(b.shape[0]):
        s, t = off[e], off[e + 1]
        if t > s:
            out[s:t] = matmul_mxf4_bf16_kmajor(a[:, cols[s:t]], b[e], a_sf[:, cols[s:t]],
                                               b_sf[e], alpha, out_dtype)
    return out


def gemm_fp4_mx_groupfold_plain(a, b, a_sf, b_sf, alpha, *, layout: str,
                                out_dtype=torch.bfloat16) -> torch.Tensor:
    """The arithmetic of K4 and K16, operands as for ``matmul_mxf4_bf16_tn``
    (``layout="tn"``), ``_kmajor`` or ``_kmajor_codes``: per 32-group the
    integer sum s = 4p of the doubled e2m1 values' products, the exact term
    p * sa * sb in fp64 (sa, sb = 2^(byte - 127), NaN at byte 255), added
    into one fp64 accumulator an output in ascending k (one rounding a
    group); then one rounding to fp32, times alpha in fp32.

    Equal to the fp64 product (``matmul_mxf4_*``) while a row pair's group
    terms span fewer than ~40 binades and no scale byte is 253 or 254: at
    those bytes the plain versions' bf16 dequant saturates to inf
    (``codecs.e2m1_decode_scaled_bf16``) while the fold keeps the exact
    term.  Beyond that it is the order of K4's prefill kernel and K16,
    which the plain versions do not fix.  Used by the tests, not by the
    main path."""
    if layout in ("kmajor", "kmajor_codes"):
        a, b, a_sf, b_sf = a.T, b.T, a_sf.T, b_sf.T
    elif layout != "tn":
        raise ValueError(f"invalid layout {layout!r}")
    ca = a.to(torch.int32) if layout == "kmajor_codes" else unpack_codes(a)
    m2a = C.e2m1_decode_f32(ca).to(torch.float64) * 2                # exact integers
    m2b = C.e2m1_decode_f32(unpack_codes(b)).to(torch.float64) * 2
    sa = C.e8m0_decode_f32(a_sf).to(torch.float64) / 4                # exact powers of two
    sb = C.e8m0_decode_f32(b_sf).to(torch.float64)
    acc = torch.zeros((m2a.shape[0], m2b.shape[0]), dtype=torch.float64, device=m2a.device)
    for g in range(m2a.shape[1] // 32):
        ks = slice(32 * g, 32 * g + 32)
        s = m2a[:, ks] @ m2b[:, ks].T                   # integers below 2^13: exact
        acc = acc + (s * sa[:, g, None]) * sb[None, :, g]  # the term is exact
    return (acc.to(torch.float32) * as_alpha(alpha, acc.device)).to(check_out_dtype(out_dtype))


# ---------------------------------------------------------------------------
# NVFP4 GEMM (plain version of kernel K7)
# ---------------------------------------------------------------------------

def dequant_nvfp4(codes: torch.Tensor, scale_bytes: torch.Tensor) -> torch.Tensor:
    """e2m1 codes [R, K] + e4m3 bytes [R, K/16] -> exact fp32 [R, K]
    (a 2-bit times a 4-bit significand; a NaN byte gives NaN)."""
    r, k = codes.shape
    v = C.e2m1_decode_f32(codes).reshape(r, k // 16, 16)
    return (v * C.e4m3_decode_f32(scale_bytes)[..., None]).reshape(r, k)


def matmul_nvf4_codes(a_codes, b_codes, a_sf, b_sf, alpha,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """out[M, N] = out_dtype((dq(a) @ dq(b)^T) * alpha) from codes [M, K] /
    [N, K] and e4m3 bytes [M, K/16] / [N, K/16].

    The products are exact in fp32 and the sum is taken in fp64, exact
    whenever the products of a row pair span fewer than ~40 binades;
    it is rounded once to fp32, then scaled by alpha in fp32.
    """
    av = dequant_nvfp4(a_codes, a_sf).to(torch.float64)
    bv = dequant_nvfp4(b_codes, b_sf).to(torch.float64)
    acc = (av @ bv.T).to(torch.float32)
    return (acc * as_alpha(alpha, acc.device)).to(check_out_dtype(out_dtype))


def matmul_nvf4_bf16_tn(a, b, a_sf, b_sf, alpha, out_dtype=torch.bfloat16):
    """NVFP4 GEMM: a/b packed u8 [M, K/2] / [N, K/2], e4m3 bytes
    [M, K/16] / [N, K/16] (row-major)."""
    return matmul_nvf4_codes(unpack_codes(a), unpack_codes(b), a_sf, b_sf,
                             alpha, out_dtype)


def matmul_nvf4_bf16_kmajor(at, bt, a_sft, b_sft, alpha, out_dtype=torch.bfloat16):
    """K-major variant: at/bt packed u8 [K/2, M] / [K/2, N], e4m3 bytes
    [K/16, M] / [K/16, N]."""
    return matmul_nvf4_bf16_tn(at.T, bt.T, a_sft.T, b_sft.T, alpha, out_dtype)


def gemm_fp4_nv_groupfold_plain(a, b, a_sf, b_sf, alpha, *, layout: str,
                                out_dtype=torch.bfloat16) -> torch.Tensor:
    """The arithmetic of K7's prefill kernel, operands as for
    ``matmul_nvf4_bf16_tn`` (``layout="tn"``) or ``_kmajor``: per 16-group
    the integer sum s = 4p of the doubled e2m1 values' products, the exact
    term p * sa * sb, added into one fp64 accumulator an output in
    ascending k (one rounding a group); then one rounding to fp32, times
    alpha in fp32.  Equal to the fp64 product (``matmul_nvf4_*``) while a
    row pair's group terms span fewer than ~40 binades; beyond that it is
    the kernel's order, which the plain versions do not fix.  Used by the
    tests, not by the main path."""
    if layout == "kmajor":
        a, b, a_sf, b_sf = a.T, b.T, a_sf.T, b_sf.T
    elif layout != "tn":
        raise ValueError(f"invalid layout {layout!r}")
    m2a = C.e2m1_decode_f32(unpack_codes(a)).to(torch.float64) * 2   # exact integers
    m2b = C.e2m1_decode_f32(unpack_codes(b)).to(torch.float64) * 2
    sa = C.e4m3_decode_f32(a_sf).to(torch.float64) / 4
    sb = C.e4m3_decode_f32(b_sf).to(torch.float64)
    acc = torch.zeros((m2a.shape[0], m2b.shape[0]), dtype=torch.float64, device=m2a.device)
    for g in range(m2a.shape[1] // 16):
        ks = slice(16 * g, 16 * g + 16)
        s = m2a[:, ks] @ m2b[:, ks].T                   # integers below 2^12: exact
        acc = acc + (s * sa[:, g, None]) * sb[None, :, g]  # the term is exact
    return (acc.to(torch.float32) * as_alpha(alpha, acc.device)).to(check_out_dtype(out_dtype))


# ---------------------------------------------------------------------------
# the single-kernel quantized linear (plain versions of kernels K16, K17)
# ---------------------------------------------------------------------------

def rtne_e2m1_values(q: torch.Tensor) -> torch.Tensor:
    """RTNE of fp32 ``q`` onto the e2m1 grid, returned as grid values
    (saturating to +-6, ties to even); NaN gives +0, as its code does."""
    nan = torch.isnan(q)
    s = torch.where(nan, 0.0, torch.sign(q))
    a = torch.where(nan, 0.0, torch.clamp(q.abs(), max=6.0))
    v1 = torch.round(a * 2.0) * 0.5
    v2 = torch.round(a)
    v3 = torch.round(a * 0.5) * 2.0
    return s * torch.where(a <= 2.0, v1, torch.where(a <= 4.0, v2, v3))


def quantize_dequant_mx(x: torch.Tensor, h: torch.Tensor, rot_size: int,
                        method: str) -> torch.Tensor:
    """bf16 [M, K] -> the MXFP4-quantized-then-dequantized activation,
    bf16 [M, K]: rotate, scale each 32-group, round onto the e2m1 grid
    and rebuild ``grid value x scale`` (exact in bf16).  For abs-max the
    3x stays in (alpha carries 1/9)."""
    m, k = x.shape
    g = rotate(x, h, rot_size).reshape(m, k // 32, 32)
    if method == "quest":
        scale = C.mx_scale_quest(g.sum(-1), (g * g).sum(-1), 32.0)
    else:
        scale = C.mx_scale_absmax(g.abs().amax(-1))
    scale_f, byte = C.pow2_floor_e8m0(scale)
    q = g * C.e8m0_recip_f32(byte)[..., None]
    if method != "quest":
        q = q * 3.0
    return (rtne_e2m1_values(q) * scale_f[..., None]).to(torch.bfloat16).reshape(m, k)


def quantize_dequant_nv(x: torch.Tensor, h: torch.Tensor, global_scale,
                        rot_size: int, method: str) -> torch.Tensor:
    """bf16 [M, K] -> the NVFP4-quantized activation as ``grid value x
    e4m3 scale``, bf16 [M, K] (exact: a 2-bit times a 4-bit
    significand); the global scale stays in alpha."""
    m, k = x.shape
    g = rotate(x, h, rot_size).reshape(m, k // 16, 16)
    if method == "abs_max":
        byte, mul = C.nv_absmax_scale_bytes(g.abs().amax(-1), as_alpha(global_scale, x.device))
    else:
        byte, mul = C.nv_quest_scale_bytes(g.sum(-1), (g * g).sum(-1))
    vals = rtne_e2m1_values(g * mul[..., None])
    return (vals * C.e4m3_decode_f32(byte)[..., None]).to(torch.bfloat16).reshape(m, k)


def _linear_out(xdq: torch.Tensor, wdq: torch.Tensor, alpha) -> torch.Tensor:
    """bf16(fp32(fp64 sum of the exact products) * alpha), as K4 and K7's
    plain versions round."""
    acc = (xdq.to(torch.float64) @ wdq.to(torch.float64).T).to(torch.float32)
    return (acc * as_alpha(alpha, acc.device)).to(torch.bfloat16)


def fused_linear_mxf4_plain(x, wqt, wst, h, alpha, *, rot_size: int, method: str):
    """Plain version of kernel K16: y [M, N] = bf16(dq(q(x H)) @ dq(w)^T
    * alpha) for x bf16 [M, K] and a K-major MXFP4 weight (packed [K/2,
    N], e8m0 [K/32, N]).  ``alpha`` is applied as given: the caller folds
    the abs-max 1/9 into it."""
    wdq = dequant_fp4(unpack_codes(wqt.T), wst.T)
    return _linear_out(quantize_dequant_mx(x, h, rot_size, method), wdq, alpha)


def fused_linear_nvf4_plain(x, wqt, wst, h, global_scale, alpha, *, rot_size: int,
                            method: str):
    """Plain version of kernel K17: the NVFP4 twin of
    :func:`fused_linear_mxf4_plain` (e4m3 [K/16, N] weight scales; the
    activation quantized under ``global_scale``)."""
    wdq = dequant_nvfp4(unpack_codes(wqt.T), wst.T)
    return _linear_out(quantize_dequant_nv(x, h, global_scale, rot_size, method), wdq, alpha)


# ---------------------------------------------------------------------------
# int8 GEMM + rank-1 epilogue (plain version of kernel K3)
# ---------------------------------------------------------------------------

def matmul_int8_rank1_plain(a_mk: torch.Tensor, b_nk: torch.Tensor,
                            sa: torch.Tensor, sb: torch.Tensor,
                            alpha, out_dtype=torch.bfloat16) -> torch.Tensor:
    """C[M, N] = out_dtype(float(a' @ b'^T) * (sa[m] * alpha) * sb[n])
    from logical int8 views a_mk [M, K] and b_nk [N, K] (any strides).

    The contraction runs in fp64, which is exact for |acc| <= 16129*K
    < 2^53 and has a matmul on every device (CUDA has no integer one);
    the epilogue multiplies in exactly the order of the JAX op.
    """
    acc = (a_mk.to(torch.float64) @ b_nk.to(torch.float64).T).to(torch.float32)
    al = as_alpha(alpha, acc.device)
    return (acc * (sa[:, None] * al) * sb[None, :]).to(check_out_dtype(out_dtype))


# ---------------------------------------------------------------------------
# MXFP8 GEMM (plain version of kernel K11)
# ---------------------------------------------------------------------------

def dequant_fp8(data: torch.Tensor, scale_bytes: torch.Tensor) -> torch.Tensor:
    """e4m3 bytes [R, K] + e8m0 bytes [R, K/32] -> exact bf16 [R, K]."""
    sexp = scale_bytes.to(torch.int32).repeat_interleave(32, dim=-1)
    return C.e4m3_decode_scaled_bf16(data, sexp)


def matmul_mxf8_bf16_tn(a, b, a_sf, b_sf, alpha):
    """out[M, N] = bf16((dq(a) @ dq(b)^T) * alpha): a/b e4m3 bytes
    [M, K] / [N, K], e8m0 bytes [M, K/32] / [N, K/32] (any strides).

    The bf16 operands' products are exact in fp64 and so is their sum
    for any operands the quantizers emit; it is rounded once to fp32,
    then scaled by alpha in fp32.
    """
    av = dequant_fp8(a, a_sf).to(torch.float64)
    bv = dequant_fp8(b, b_sf).to(torch.float64)
    acc = (av @ bv.T).to(torch.float32)
    return (acc * as_alpha(alpha, acc.device)).to(torch.bfloat16)


def matmul_mxf8_bf16_nn(a, b, a_sf, b_sf, alpha):
    """NN order: a stored [K, M] (the logical A^T), a_sf [M, K/32] for
    the logical A; b [N, K], b_sf [N, K/32]."""
    return matmul_mxf8_bf16_tn(a.T, b, a_sf, b_sf, alpha)


# ---------------------------------------------------------------------------
# QAT backward ops (plain versions of kernels K8, K9 and K10)
# ---------------------------------------------------------------------------

def _bf16_round(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> nearest bf16 value as fp32, a NaN as the positive NaN
    (the kernels' and the JAX package's; PyTorch's CPU cast of a NaN to
    bf16 sets the sign bit)."""
    r = v.to(torch.bfloat16).to(torch.float32)
    return torch.where(torch.isnan(r), torch.full_like(r, float("nan")), r)


def square_double_tiles(x: torch.Tensor):
    """Square-double MXFP8 quantization of bf16 x [M, N] (M, N multiples
    of 32): one shared exponent per 32x32 tile,
    ``mxfp8_shared_exp_bytes(tile amax)``; each value divided by the
    tile's scale 2^(e-127), rounded to bf16, then to e4m3 (RTNE,
    saturating; a NaN gives 0x7F).  Returns (e4m3 bytes u8 [M, N],
    exponent bytes u8 [M/32, N/32]).  Plain version of kernel K9.
    """
    m, n = x.shape
    t = x.to(torch.float32).reshape(m // 32, 32, n // 32, 32)
    ebyte = C.mxfp8_shared_exp_bytes(t.abs().amax(dim=(1, 3)))
    q = _bf16_round(t / C.e8m0_decode_f32(ebyte)[:, None, :, None])
    fp8 = C.e4m3_rtne_bytes(q).to(torch.uint8).reshape(m, n)
    return fp8, ebyte.to(torch.uint8)


def tile_scales(eb: torch.Tensor):
    """The tiles' exponent matrix [M/32, N/32] expanded along each axis:
    (row scales [M, N/32], col scales [N, M/32])."""
    return eb.repeat_interleave(32, dim=0), eb.T.repeat_interleave(32, dim=0)


def backward_bf16_square_double_mxfp8(x: torch.Tensor):
    """(fp8 bytes [M, N], row scales [M, N/32], col scales [N, M/32])."""
    fp8, eb = square_double_tiles(x)
    return (fp8, *tile_scales(eb))


def backward_square_double_scaled(x: torch.Tensor) -> torch.Tensor:
    """``e4m3_value * 2^(e-127)`` in bf16 [M, N], the decode of
    :func:`square_double_tiles` (the fp32 product rounded once to bf16).
    Plain version of kernel K8."""
    fp8, eb = square_double_tiles(x)
    sc = C.e8m0_decode_f32(eb).repeat_interleave(32, 0).repeat_interleave(32, 1)
    return (C.e4m3_decode_f32(fp8) * sc).to(torch.bfloat16)


def mxfp4_transpose_mxfp8(x_fp4: torch.Tensor, scales: torch.Tensor):
    """Dequantize MXFP4 (packed u8 [M, N/2], e8m0 bytes [M, N/32]; M a
    multiple of 32), transpose, and requantize in 32-groups along M to
    MXFP8 with the square-double rule: returns (e4m3 bytes u8 [N, M],
    exponent bytes u8 [N, M/32]).  Plain version of kernel K10."""
    m, n = x_fp4.shape[0], x_fp4.shape[1] * 2
    xt = dequant_fp4(unpack_codes(x_fp4), scales).to(torch.float32).T
    g = xt.reshape(n, m // 32, 32)
    ebyte = C.mxfp8_shared_exp_bytes(g.abs().amax(dim=-1))
    q = _bf16_round(g / C.e8m0_decode_f32(ebyte)[..., None])
    return (C.e4m3_rtne_bytes(q).to(torch.uint8).reshape(n, m),
            ebyte.to(torch.uint8))


# ---------------------------------------------------------------------------
# Quartet backward-operand ops (plain versions of kernels K12-K15)
# ---------------------------------------------------------------------------

def _backward_quantize_g32(xh: torch.Tensor, alpha=None):
    """The backward ops' abs-max 32-group MXFP4 quantizer (no +1e-8) on
    the last axis of fp32 ``xh``: (int32 codes, int32 e8m0 bytes).

    Without ``alpha`` (K12): byte = pow2floor(amax), q = (g * 2^(127-byte))
    * 3, as the JAX emulation's ``g / scale * 3``.  With ``alpha`` (K13):
    byte = pow2floor(amax / alpha) (a true division), q = g * (3 /
    (scale * alpha)), the emulation's arithmetic.  A zero or subnormal
    group (byte 0) takes the fp64 golden's scale 2^-127 where the
    emulation divides by 0; there K13 doubles g and forms the multiplier
    at 2^-126, the same product without the overflow of 3 / (2^-127 *
    alpha) for alpha < 1.5.  Byte 255 (an inf or NaN in the group) has
    the multiplier 0, as the emulation's division by inf.
    """
    g = xh.reshape(*xh.shape[:-1], -1, 32)
    amax = g.abs().amax(-1)
    if alpha is None:
        byte = C.pow2_floor_e8m0(amax)[1]
        q = g * C.backward_recip_f32(byte)[..., None] * 3.0
    else:
        al = as_alpha(alpha, g.device).expand_as(amax)
        byte = C.pow2_floor_e8m0(amax / al)[1]
        zero = byte == 0
        sc = torch.where(zero, C.e8m0_decode_f32(torch.ones_like(byte)),
                         C.backward_scale_f32(byte))
        mul = torch.full_like(amax, 3.0) / (sc * al)      # a true division
        q = torch.where(zero[..., None], g * 2.0, g) * mul[..., None]
    return C.e2m1_rtne_codes(q.reshape(xh.shape)), byte


def backward_t_bf16(x: torch.Tensor, h: torch.Tensor, *, rot_size: int):
    """Transpose, rotate along N in ``rot_size`` chunks and quantize to
    MXFP4 in 32-groups along N (the QAT wgrad operand): x bf16 [..., N,
    K] -> (packed u8 [..., K, N/2], e8m0 u8 [..., K, N/32]).  Plain
    version of kernel K12."""
    codes, byte = _backward_quantize_g32(rotate(x.transpose(-2, -1), h, rot_size))
    return pack_codes(codes), byte.to(torch.uint8)


def backward_qt_bf16(x_e2m1: torch.Tensor, x_e8m0: torch.Tensor, h: torch.Tensor,
                     alpha, *, rot_size: int):
    """Dequantize MXFP4 [..., M, N] (packed u8 [..., M, N/2], e8m0 bytes
    [..., M, N/32]) without alpha, transpose, rotate along M and
    requantize in 32-groups along M with alpha: (packed u8 [..., N,
    M/2], e8m0 u8 [..., N, M/32]).  Plain version of kernel K13."""
    codes = unpack_codes(x_e2m1)
    xdq = C.e2m1_decode_scaled_bf16(
        codes, x_e8m0.to(torch.int32).repeat_interleave(32, dim=-1))
    codes, byte = _backward_quantize_g32(rotate(xdq.transpose(-2, -1), h, rot_size),
                                         alpha)
    return pack_codes(codes), byte.to(torch.uint8)


def mxfp4_transpose_scaled(x_fp4: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``e4m3_value * 2^(e-127)`` in bf16 [N, M], the decode of
    :func:`mxfp4_transpose_mxfp8` (the fp32 product rounded once to
    bf16).  Plain version of kernel K14."""
    fp8, eb = mxfp4_transpose_mxfp8(x_fp4, scales)
    sc = C.e8m0_decode_f32(eb).repeat_interleave(32, dim=1)
    return (C.e4m3_decode_f32(fp8) * sc).to(torch.bfloat16)


def mxfp4_transpose_scaled_kmajor(qt: torch.Tensor, st: torch.Tensor) -> torch.Tensor:
    """The same from the K-major operand of ``fusedQuantizeMx(...,
    layout="kmajor")``: packed u8 [K/2, rows] (element 2k of a row in the
    low nibble), e8m0 u8 [K/32, rows] -> bf16 [K, rows], requantized in
    32-groups along the rows.  Repacked row-major (the transpose of the
    bytes), rows padded to 256 with zero codes under byte 127, as the JAX
    op does.  Plain version of kernel K15."""
    rows = qt.shape[1]
    rp = round_up(rows, 256)
    packed = torch.zeros((rp, qt.shape[0]), dtype=torch.uint8, device=qt.device)
    packed[:rows] = qt.T
    scales = torch.full((rp, st.shape[0]), 127, dtype=torch.uint8, device=st.device)
    scales[:rows] = st.T
    return mxfp4_transpose_scaled(packed, scales)[:, :rows]
