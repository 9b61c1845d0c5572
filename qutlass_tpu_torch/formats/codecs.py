"""Shared low-precision codecs (device semantics, fp32/int32 arithmetic).

PyTorch counterpart of ``qutlass_tpu.formats.codecs`` (MX parts).  The
functions are plain tensor code, so they run on any device and serve as
the arithmetic spec that the CUDA kernels in ``qutlass_tpu_torch/csrc``
implement bit for bit.

Numerics contract (reference: IST-DASLab/qutlass):
  * e2m1 RTNE with even-code tie-break, saturating to +-6, NaN -> +0
    (PTX ``cvt.rn.satfinite.e2m1x2.f32``).
  * e8m0 power-of-two floor via fp32 exponent-bit masking
    (``& 0x7f800000``).
  * Powers of two are built from bits, never with ``exp2``/``ldexp``.

Byte values are carried as ``int32`` and converted to ``uint8`` only at
op boundaries.
"""
from __future__ import annotations

import torch

E2M1_MAX = 6.0
QUEST_CONST = 2.92247856 / 6.0
# 2^-127, the value of e8m0 byte 0 (an fp32 subnormal)
_POW2_M127 = 5.877471754111438e-39


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def _bits_f32(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32).contiguous().view(torch.float32)


# ---------------------------------------------------------------------------
# e2m1 (fp4)
# ---------------------------------------------------------------------------

def e2m1_rtne_codes(q: torch.Tensor) -> torch.Tensor:
    """Round fp32 ``q`` to the nearest e2m1 value; return int32 codes 0..15.

    Integer-domain encoder on the fp32 bit pattern: saturation and the
    [0.25, 1) band are integer compares (positive floats order as their
    bit patterns); the [1, 6] band rounds to one mantissa bit with
    ``r = a + 0x1FFFFF + lsb``, after which ``r >> 22 == 2*E + m`` maps
    affinely to the code.  Ties go to the even code; NaN maps to +0.
    """
    b = _f32_bits(q)
    sign = (b >> 28) & 8
    a = b & 0x7FFFFFFF
    a = torch.where(a > 0x7F800000, torch.zeros_like(a),
                    torch.clamp(a, max=0x40C00000))
    cl = (a > 0x3E800000).to(torch.int32) + (a >= 0x3F400000).to(torch.int32)
    r = a + 0x1FFFFF + ((a >> 22) & 1)
    code = torch.where(a < 0x3F800000, cl, (r >> 22) - 252)
    return code | sign


def e2m1_codes_to_m2(codes: torch.Tensor) -> torch.Tensor:
    """e2m1 codes -> signed integer 2*value, int32 (the int8 evaluator's
    mantissa domain).  Magnitude codes 0..4 are the value itself; 5, 6, 7
    map to 6, 8, 12."""
    c = codes.to(torch.int32)
    mag = c & 7
    m = torch.where(mag < 5, mag,
                    torch.where(mag < 7, 2 * mag - 4, torch.full_like(mag, 12)))
    return torch.where(c >= 8, -m, m)


def e2m1_decode_scaled_bf16(codes: torch.Tensor,
                            scale_bytes: torch.Tensor) -> torch.Tensor:
    """Decode e2m1 codes times e8m0 scales to EXACT bf16, integer-only.

    The power-of-two scale is an add on the bf16 exponent field.
    Exponent-field underflow yields the exact bf16 subnormal (RTNE on
    the shifted-out bits); overflow saturates to inf; scale byte 255
    (NaN) decodes every code of its group to NaN.  Exact for every scale
    byte, including 0.
    """
    codes = codes.to(torch.int32)
    sb = scale_bytes.to(torch.int32)
    mag = codes & 7
    e = mag >> 1
    mant = ((codes & 1) & torch.clamp(e, max=1)) << 6
    x = e + sb - 1                                   # bf16 exponent field
    norm = (x << 7) | mant
    s = torch.clamp(1 - x, 1, 15)
    sig = 0x80 | mant
    shifted = sig >> s
    rem = sig & ((1 << s) - 1)
    half = 1 << (s - 1)
    subn = shifted + ((rem > half) | ((rem == half) & ((shifted & 1) == 1))
                      ).to(torch.int32)
    hi = torch.where(x >= 255, torch.full_like(x, 255 << 7), norm)
    bits = torch.where(mag == 0, torch.zeros_like(x),
                       torch.where(x > 0, hi, subn))
    bits = bits | ((codes & 8) << 12)
    bits = torch.where(sb == 255, torch.full_like(bits, 0x7FC0), bits)
    # int16 view of the 16-bit pattern (values >= 0x8000 wrap to negative)
    b16 = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16)
    return b16.view(torch.bfloat16)


# ---------------------------------------------------------------------------
# e8m0 (power-of-two block scales)
# ---------------------------------------------------------------------------

def pow2_floor_e8m0(scale: torch.Tensor):
    """fp32 scale -> (pow2-floored fp32 scale, int32 e8m0 byte).

    Masks the fp32 mantissa bits (``& 0x7f800000``); subnormal inputs
    floor to byte 0.
    """
    bits = _f32_bits(scale) & 0x7F800000
    return _bits_f32(bits), bits >> 23


def e8m0_decode_f32(byte: torch.Tensor) -> torch.Tensor:
    """int e8m0 byte -> fp32 2^(byte-127).  Byte 0 -> 2^-127, 255 -> NaN."""
    byte = byte.to(torch.int32)
    f = _bits_f32(byte << 23)
    f = torch.where(byte == 0, torch.full_like(f, _POW2_M127), f)
    return torch.where(byte == 255, torch.full_like(f, float("nan")), f)


def pow2_f32(n: torch.Tensor) -> torch.Tensor:
    """EXACT fp32 2^n for integer ``n`` (clamped to [-127, 127])."""
    return e8m0_decode_f32(torch.clamp(n.to(torch.int32) + 127, 0, 254))


def e8m0_recip_f32(byte: torch.Tensor) -> torch.Tensor:
    """int e8m0 byte -> exact fp32 reciprocal 2^(127-byte)."""
    return e8m0_decode_f32(254 - byte.to(torch.int32))


# ---------------------------------------------------------------------------
# block-scale computation (the quantizer cores)
# ---------------------------------------------------------------------------

def mx_scale_quest(s1: torch.Tensor, s2: torch.Tensor, n: float) -> torch.Tensor:
    """QuEST scale from group moments (pre pow2-floor): population
    variance guarded against negative round-off,
    ``sqrt(var) * (2.92247856/6) + 1e-8``; 1.0 where var < 0."""
    mean = s1 * (1.0 / n)
    var = s2 * (1.0 / n) - mean * mean
    # fp32 sqrt correctly rounded (as __fsqrt_rn and XLA give it): the
    # fp64 root rounded once to fp32.  PyTorch's vectorized fp32 sqrt on
    # the CPU is off by an ulp for some inputs, enough to flip a byte.
    root = torch.sqrt(torch.clamp(var, min=0.0).to(torch.float64)).to(torch.float32)
    scale = root * QUEST_CONST + 1e-8
    return torch.where(var >= 0.0, scale, torch.ones_like(scale))


def mx_scale_absmax(amax: torch.Tensor) -> torch.Tensor:
    """Abs-max scale (pre pow2-floor): amax + 1e-8."""
    return amax + 1e-8
