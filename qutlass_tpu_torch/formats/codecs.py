"""Shared low-precision codecs (device semantics, fp32/int32 arithmetic).

PyTorch counterpart of ``qutlass_tpu.formats.codecs`` (MX, NV and MXFP8
parts).  The functions are plain tensor code, so they run on any device
and serve as the arithmetic spec that the CUDA kernels in
``qutlass_tpu_torch/csrc`` implement bit for bit.

Numerics contract (reference: IST-DASLab/qutlass):
  * e2m1 RTNE with even-code tie-break, saturating to +-6, NaN -> +0
    (PTX ``cvt.rn.satfinite.e2m1x2.f32``).
  * e8m0 power-of-two floor via fp32 exponent-bit masking
    (``& 0x7f800000``).
  * e4m3 saturating RTNE by bit arithmetic (``__nv_fp8_e4m3``), NaN ->
    byte 0x7F with the sign bit of the NaN.  The bit arithmetic, not a
    ``torch.float8_e4m3fn`` cast, is the spec: it is what the kernels
    compute, whatever a cast's saturation does on a given build.
  * Powers of two are built from bits, never with ``exp2``/``ldexp``.

Byte values are carried as ``int32`` and converted to ``uint8`` only at
op boundaries.
"""
from __future__ import annotations

import torch

E2M1_MAX = 6.0
E4M3_MAX = 448.0
QUEST_CONST = 2.92247856 / 6.0
# 2^-127, the value of e8m0 byte 0 (an fp32 subnormal)
_POW2_M127 = 5.877471754111438e-39
# the fp32 NaN that sqrt of a negative number gives on the JAX package's
# CPU and TPU (sign bit set): its e4m3 byte is 0xFF, not 0x7F
_NEG_NAN_BITS = -0x400000


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


def e2m1_decode_f32(codes: torch.Tensor) -> torch.Tensor:
    """int e2m1 codes (0..15) -> exact fp32 values."""
    c = codes.to(torch.int32)
    mag = c & 7
    e, m = mag >> 1, mag & 1
    bits = torch.where(e == 0, m * 0x3F000000, ((126 + e) << 23) | (m << 22))
    return _bits_f32(torch.where(c >= 8, bits | -0x80000000, bits))


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


def backward_recip_f32(byte: torch.Tensor) -> torch.Tensor:
    """The multiplier 1/scale of the backward abs-max quantizer for an
    int e8m0 byte: exact 2^(127-byte), 2^127 at byte 0 (the fp64
    golden's scale 2^-127 for a zero or subnormal group), 0 at byte 255
    (an inf or NaN in the group: the JAX emulation divides by inf)."""
    byte = byte.to(torch.int32)
    return torch.where(byte == 255, torch.zeros((), dtype=torch.float32, device=byte.device),
                       e8m0_recip_f32(byte))


def backward_scale_f32(byte: torch.Tensor) -> torch.Tensor:
    """The backward quantizer's scale for an int e8m0 byte: exact
    2^(byte-127), 2^-127 at byte 0 (the golden's), inf at byte 255 (the
    pow2 floor of an inf or NaN amax, as the JAX emulation holds it)."""
    byte = byte.to(torch.int32)
    return torch.where(byte == 255, torch.full((), float("inf"), device=byte.device),
                       e8m0_decode_f32(byte))


def mxfp8_shared_exp_bytes(amax: torch.Tensor) -> torch.Tensor:
    """MXFP8 double-quant shared exponent byte (int32):
    ``floor(log2(amax)) - 7 + 127``, wrapping mod 256 like a uint8
    store; amax 0 (and NaN) gives byte 127 (scale 1.0).

    A tile with amax in [2^-120, 2^-119) gets byte 0 (scale 2^-127, an
    fp32 subnormal); one with amax in [2^-121, 2^-120) gets byte 255
    (NaN); a smaller amax wraps to a huge scale and quantizes to 0.  The
    pow2 floor of an fp32-subnormal amax is byte 0, hence byte 249.
    """
    _, byte = pow2_floor_e8m0(amax)
    return torch.where(amax > 0.0, torch.remainder(byte - 7, 256),
                       torch.full_like(byte, 127))


# ---------------------------------------------------------------------------
# e4m3 (fp8 block scales)
# ---------------------------------------------------------------------------

def _e4m3_round_mag(a: torch.Tensor) -> torch.Tensor:
    """|x| (fp32, NaN cleared, clamped to 448) -> exact e4m3-rounded
    magnitude: RTNE to 3 mantissa bits on the fp32 bits in the normal
    range, on the fixed 2^-9 grid below 2^-6."""
    bits = _f32_bits(a)
    lsb = (bits >> 20) & 1
    rn = torch.clamp(_bits_f32((bits + lsb + 0x7FFFF) & ~0xFFFFF), max=E4M3_MAX)
    sub = torch.round(a * 512.0) * (1.0 / 512.0)
    return torch.where(a < 2.0 ** -6, sub, rn)


def e4m3_rtne_value_f32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the exact e4m3fn-rounded value (satfinite), as fp32; NaN
    stays NaN."""
    a = torch.where(torch.isnan(x), torch.full_like(x, float("nan")),
                    _e4m3_round_mag(torch.clamp(x.abs(), max=E4M3_MAX)))
    return torch.where(torch.signbit(x), -a, a)


def e4m3_rtne_bytes(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> e4m3fn byte (int32), RTNE with saturation to +-448; NaN ->
    0x7F with the NaN's sign bit."""
    sign = torch.signbit(x).to(torch.int32)
    isnan = torch.isnan(x)
    a = torch.where(isnan, torch.zeros_like(x), torch.clamp(x.abs(), max=E4M3_MAX))
    v = _e4m3_round_mag(a)
    vbits = _f32_bits(v)
    exp32 = (vbits >> 23) & 0xFF
    mant3 = (vbits >> 20) & 7
    sub_mant = torch.round(v * 512.0).to(torch.int32)
    byte = torch.where(v == 0.0, torch.zeros_like(exp32),
                       torch.where(exp32 < 127 - 6, sub_mant,
                                   ((exp32 - 120) << 3) | mant3))
    byte = torch.where(isnan, torch.full_like(byte, 0x7F), byte)
    return byte | (sign << 7)


def e4m3_decode_f32(byte: torch.Tensor) -> torch.Tensor:
    """int e4m3fn byte -> exact fp32.  0x7F / 0xFF decode to NaN."""
    b = byte.to(torch.int32)
    e, m = (b >> 3) & 0xF, b & 7
    norm = _bits_f32(((e + 120) << 23) | (m << 20))
    v = torch.where(e == 0, m.to(torch.float32) * (2.0 ** -9), norm)
    v = torch.where((e == 15) & (m == 7), torch.full_like(v, float("nan")), v)
    return torch.where(b >= 0x80, -v, v)


def e4m3_decode_scaled_bf16(data: torch.Tensor,
                            scale_bytes: torch.Tensor) -> torch.Tensor:
    """Decode e4m3 data bytes times e8m0 scales to EXACT bf16,
    integer-only (an e4m3 value has a 4-bit significand; the scale is an
    add on the bf16 exponent field).

    Subnormal e4m3 values are normalized first; exponent underflow gives
    the exact bf16 subnormal (RTNE on the shifted-out bits), overflow
    saturates to inf; a NaN byte (0x7F / 0xFF) or scale byte 255 decodes
    to NaN (0x7FC0 with the byte's sign).
    """
    b = data.to(torch.int32)
    sb = scale_bytes.to(torch.int32)
    e, m = (b >> 3) & 0xF, b & 7
    t = torch.where(m > 3, 2, torch.where(m > 1, 1, 0))
    mant_sub = (m - (1 << t)) << (7 - t)
    x = torch.where(e == 0, t + sb - 9, e + sb - 7)       # bf16 exponent field
    mant = torch.where(e == 0, mant_sub, m << 4)
    s = torch.clamp(1 - x, 1, 15)
    sig = 0x80 | mant
    shifted = sig >> s
    rem = sig & ((1 << s) - 1)
    half = 1 << (s - 1)
    subn = shifted + ((rem > half) | ((rem == half) & ((shifted & 1) == 1))
                      ).to(torch.int32)
    hi = torch.where(x >= 255, torch.full_like(x, 255 << 7), (x << 7) | mant)
    bits = torch.where((e == 0) & (m == 0), torch.zeros_like(x),
                       torch.where(x > 0, hi, subn))
    bits = torch.where(((e == 15) & (m == 7)) | (sb == 255),
                       torch.full_like(bits, 0x7FC0), bits)
    bits = bits | ((b & 0x80) << 8)
    # int16 view of the 16-bit pattern (values >= 0x8000 wrap to negative)
    b16 = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16)
    return b16.view(torch.bfloat16)


# ---------------------------------------------------------------------------
# block-scale computation (the quantizer cores)
# ---------------------------------------------------------------------------

def _f32_root(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 sqrt of x >= 0: the fp64 root rounded once
    (as ``__fsqrt_rn`` and XLA give it).  PyTorch's vectorized fp32 sqrt
    on the CPU is off by an ulp for some inputs, enough to flip a byte."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def mx_scale_quest(s1: torch.Tensor, s2: torch.Tensor, n: float) -> torch.Tensor:
    """QuEST scale from group moments (pre pow2-floor): population
    variance guarded against negative round-off,
    ``sqrt(var) * (2.92247856/6) + 1e-8``; 1.0 where var < 0."""
    mean = s1 * (1.0 / n)
    var = s2 * (1.0 / n) - mean * mean
    scale = _f32_root(torch.clamp(var, min=0.0)) * QUEST_CONST + 1e-8
    return torch.where(var >= 0.0, scale, torch.ones_like(scale))


def mx_scale_absmax(amax: torch.Tensor) -> torch.Tensor:
    """Abs-max scale (pre pow2-floor): amax + 1e-8."""
    return amax + 1e-8


def nv_scale_quest(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """NVFP4 QuEST scale of a 16-group from its moments, pre e4m3 cast:
    ``sqrt(var) * (2.92247856/6) + 1e-8``.  No negative-variance guard:
    var < 0 gives the NaN that zeroes the group (sign bit set, as the
    JAX package's sqrt gives it)."""
    mean = s1 * (1.0 / 16.0)
    var = s2 * (1.0 / 16.0) - mean * mean
    scale = _f32_root(torch.clamp(var, min=0.0)) * QUEST_CONST + 1e-8
    neg_nan = _bits_f32(torch.full_like(var, _NEG_NAN_BITS, dtype=torch.int32))
    return torch.where(var >= 0.0, scale, neg_nan)


def _nv_out_mul(num: torch.Tensor, sq: torch.Tensor, keep: torch.Tensor):
    """num / sq where ``keep``, else 0; 0 where the scale is NaN."""
    mul = torch.where(keep, num / sq, torch.zeros_like(sq))
    return torch.where(torch.isnan(sq), torch.zeros_like(mul), mul)


def nv_absmax_scale_bytes(amax: torch.Tensor, global_scale: torch.Tensor):
    """NVFP4 abs-max (vLLM-compatible) scale byte and output multiplier:
    ``SF = e4m3(gs * (amax * (1/6)))``, ``mul = gs / SF`` (0 where SF is 0
    or NaN).  Returns (byte int32, mul fp32)."""
    gs = torch.as_tensor(global_scale, dtype=torch.float32,
                         device=amax.device).reshape(())
    byte = e4m3_rtne_bytes(gs * (amax * (1.0 / 6.0)))
    sfq = e4m3_decode_f32(byte)
    return byte, _nv_out_mul(gs.expand_as(sfq), sfq, sfq != 0.0)


def nv_quest_scale_bytes(s1: torch.Tensor, s2: torch.Tensor):
    """NVFP4 QuEST scale byte and output multiplier ``1/scale`` (0 where
    the decoded scale is not positive, or NaN)."""
    byte = e4m3_rtne_bytes(nv_scale_quest(s1, s2))
    sq = e4m3_decode_f32(byte)
    return byte, _nv_out_mul(torch.ones_like(sq), sq, sq > 0.0)
