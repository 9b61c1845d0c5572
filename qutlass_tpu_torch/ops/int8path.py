"""Int8 evaluator for MXFP4 and NVFP4 GEMMs (counterpart of
``qutlass_tpu.ops.int8path``).

Each e2m1 value is ``v = m * 2^(se_g - 1)`` with integer
``m = 2*value`` in {0, .., +-12}.  Per row take ``E = max_g se_g`` and
the deficit ``d_g = E - se_g``; then

    a'[k] = rtne(m * 2^(3 - d_g))     (exact while d_g <= 3)
    v     = a' * 2^(E - 4)

so one whole-K int8 contraction plus a rank-1 fp32 fixup evaluates the
GEMM:

    C = (a' @ b'^T)_int32 * 2^(Ea-4)[m] * 2^(Eb-4)[n] * alpha

bit-identical to the decode GEMM whenever every row's deficit is <= 3.
|a'| <= 96, so |sum| <= 9216*K is int32-safe to K = 233k.

NVFP4 (group 16, e4m3 scales) has no power-of-two structure, so its
encode is a bounded rounding instead: the dequantized value
``v = (m/2) * s_g`` is exact in fp32, and each row is quantized
symmetrically, ``a' = rtne(v * (1/sigma))`` with
``sigma = rowmax|v| / 127`` (error <= sigma/2 per element).  The same
GEMM evaluates it with alpha = 1/(gs_a * gs_b).

On the H100 the contraction and the epilogue are one hand-written
kernel (``csrc/gemm_int8_rank1.cu``, wrapper ``kernels.gemm``); its
plain version is ``emulation.matmul_int8_rank1_plain``.
"""
from __future__ import annotations

import torch

from ..formats import codecs as C
from ..kernels.gemm import gemm_int8_rank1
from .emulation import unpack_codes


def _unpack_rows(packed: torch.Tensor) -> torch.Tensor:
    """packed u8 [K/2, R] -> codes int32 [K, R], interleaving on dim 0."""
    p = packed.to(torch.int32)
    k2, r = p.shape
    return torch.stack([p & 0xF, (p >> 4) & 0xF], dim=1).reshape(k2 * 2, r)


def encode_int8(codes_or_packed: torch.Tensor, scale_bytes: torch.Tensor, *,
                kmajor: bool = False):
    """MXFP4 -> per-row-exponent int8 operand.

    Row-major: codes/packed [R, K or K/2], scales [R, K/32] ->
    (a' int8 [R, K], row_scale f32 [R] = 2^(E-4), max_deficit int32 []).
    ``kmajor=True`` takes the K-major layout (codes [K, R] or packed
    [K/2, R], scales [K/32, R]) and returns a' [K, R].
    """
    if kmajor:
        packed_k, rows = codes_or_packed.shape
        k = scale_bytes.shape[0] * 32
        codes = (codes_or_packed if packed_k == k
                 else _unpack_rows(codes_or_packed))
        m = C.e2m1_codes_to_m2(codes).to(torch.float32)   # [K, R], exact
        se = scale_bytes.to(torch.int32) - 127             # [K/32, R]
        e = se.amax(0)                                     # [R]
        d = e[None, :] - se
        mult = C.pow2_f32(3 - d)
        q = m.reshape(k // 32, 32, rows) * mult[:, None, :]
        a = torch.round(q).to(torch.int8).reshape(k, rows)
    else:
        k = scale_bytes.shape[-1] * 32
        codes = (codes_or_packed if codes_or_packed.shape[-1] == k
                 else unpack_codes(codes_or_packed))
        m = C.e2m1_codes_to_m2(codes).to(torch.float32)
        se = scale_bytes.to(torch.int32) - 127
        e = se.amax(-1)
        d = e[..., None] - se
        mult = C.pow2_f32(3 - d)
        q = m.reshape(*m.shape[:-1], k // 32, 32) * mult[..., None]
        a = torch.round(q).to(torch.int8).reshape(m.shape)
    return a, C.pow2_f32(e - 4), d.max()


def encode_int8_planes(packed: torch.Tensor, scale_bytes: torch.Tensor):
    """Packed K-major MXFP4 -> plane-major int8 operand: row p holds
    element 2p, row K/2 + p holds element 2p+1.  Dot two operands in this
    same layout and the int32 result equals the natural-order dot.

    packed u8 [K/2, R], scales u8 [K/32, R] ->
    (a' int8 [K, R] plane-major, row_scale f32 [R], max_deficit).
    """
    k2, rows = packed.shape
    g = scale_bytes.shape[0]
    se = scale_bytes.to(torch.int32) - 127
    e = se.amax(0)
    d = e[None, :] - se
    mult = C.pow2_f32(3 - d)
    p = packed.to(torch.int32)

    def enc(nib):
        m = C.e2m1_codes_to_m2(nib).to(torch.float32)
        return torch.round(m.reshape(g, 16, rows) * mult[:, None, :]
                           ).to(torch.int8).reshape(k2, rows)

    a = torch.cat([enc(p & 0xF), enc((p >> 4) & 0xF)], dim=0)
    return a, C.pow2_f32(e - 4), d.max()


INV_127 = 1.0 / 127.0     # applied to fp32 tensors: float32(1/127)


def _nv_dequant_halves(scale_bytes: torch.Tensor) -> torch.Tensor:
    """e4m3 bytes -> 0.5 * scale in fp32, 0 for a NaN byte (a dead
    group)."""
    s = C.e4m3_decode_f32(scale_bytes)
    return 0.5 * torch.where(torch.isnan(s), torch.zeros_like(s), s)


def _nv_row_quantize(v: torch.Tensor):
    """Exact dequant values v [K, R] -> (a' int8 [K, R], sigma f32 [R]):
    ``sigma = rowmax|v| / 127``, ``a' = rtne(v * (1/sigma))``.  The
    JAX package's ``/ 127.0`` compiles (XLA folds a division by a
    constant) to a multiply by the fp32 reciprocal, so that is what is
    computed here."""
    sigma = v.abs().amax(0) * INV_127
    inv = torch.where(sigma > 0, 1.0 / sigma, torch.zeros_like(sigma))
    return torch.round(v * inv[None, :]).to(torch.int8), sigma


def encode_nv_int8(packed: torch.Tensor, scale_bytes: torch.Tensor):
    """Packed K-major NVFP4 -> natural-K-order int8 operand + f32 row
    scale: packed u8 [K/2, R], e4m3 bytes u8 [K/16, R] -> (a' int8
    [K, R], sigma f32 [R]).  The plain version of kernel K6's encode and
    the one-time NV weight prep."""
    codes = _unpack_rows(packed)
    k, rows = codes.shape
    m = C.e2m1_codes_to_m2(codes).to(torch.float32)
    v = (m.reshape(k // 16, 16, rows)
         * _nv_dequant_halves(scale_bytes)[:, None, :]).reshape(k, rows)
    return _nv_row_quantize(v)


def encode_nv_int8_planes(packed: torch.Tensor, scale_bytes: torch.Tensor):
    """Packed K-major NVFP4 -> plane-major int8 operand (row p holds
    element 2p, row K/2 + p element 2p+1) + f32 row scale; the same math
    as :func:`encode_nv_int8`.  Dot two operands in this layout with
    :func:`matmul_mxf4_bf16_int8_kk`."""
    k2, rows = packed.shape
    hs = _nv_dequant_halves(scale_bytes)
    p = packed.to(torch.int32)

    def dq(nib):
        m = C.e2m1_codes_to_m2(nib).to(torch.float32)
        return (m.reshape(k2 // 8, 8, rows) * hs[:, None, :]).reshape(k2, rows)

    return _nv_row_quantize(torch.cat([dq(p & 0xF), dq((p >> 4) & 0xF)], dim=0))


def prepare_weight_nv_int8(wqt: torch.Tensor, wst: torch.Tensor):
    """One-time NVFP4 weight prep: K-major packed (wqt u8 [K/2, N], wst
    e4m3 u8 [K/16, N]) -> (w_i8 [K, N] natural-K-order int8, sb [N] f32),
    for :func:`matmul_mxf4_bf16_int8_kk`."""
    return encode_nv_int8(wqt, wst)


def prepare_weight_int8(wqt: torch.Tensor, wst: torch.Tensor):
    """One-time weight prep: K-major packed fp4 weight (wqt u8 [K/2, N],
    wst u8 [K/32, N]) -> (w_i8 [N, K] int8 contiguous, sb [N] f32,
    max_deficit).  ``max_deficit <= 3`` certifies that the int8
    evaluation of this weight is bit-exact."""
    w_k, sb_row, dmax = encode_int8(wqt, wst, kmajor=True)
    return w_k.T.contiguous(), sb_row, dmax


# ---------------------------------------------------------------------------
# int8 GEMM + rank-1 epilogue (kernel K3)
# ---------------------------------------------------------------------------

def matmul_mxf4_bf16_int8(a_i8, b_i8, sa, sb, alpha, out_dtype=torch.bfloat16):
    """a_i8 [M, K], b_i8 [N, K] (both from :func:`encode_int8`);
    ``out_dtype`` bf16 or fp32 (no bf16 rounding), as in the JAX op."""
    return gemm_int8_rank1(a_i8, b_i8, sa, sb, alpha, a_kmajor=False,
                           b_kmajor=False, out_dtype=out_dtype)


def matmul_mxf4_bf16_int8_kmajor(at_i8, b_i8, sa, sb, alpha, out_dtype=torch.bfloat16):
    """K-major activation: at_i8 [K, M] (as the K-major quantizer emits
    it), b_i8 [N, K] weights.  The main path's GEMM."""
    return gemm_int8_rank1(at_i8, b_i8, sa, sb, alpha, a_kmajor=True,
                           b_kmajor=False, out_dtype=out_dtype)


def matmul_mxf4_bf16_int8_kk(at_i8, bt_i8, sa, sb, alpha, out_dtype=torch.bfloat16):
    """Both operands K-major: at_i8 [K, M], bt_i8 [K, N].  The NVFP4
    int8 path's GEMM (weights from :func:`prepare_weight_nv_int8`)."""
    return gemm_int8_rank1(at_i8, bt_i8, sa, sb, alpha, a_kmajor=True,
                           b_kmajor=True, out_dtype=out_dtype)
