"""MXFP4 arithmetic in plain PyTorch for the references: the rotate +
quantize of MXFP4 (group 32, e8m0 scales) in the order of sums the
format's kernels keep, and the exact fp4 product.

A reference loads its format's module by the configuration's
``quantization.format`` (``port_bench/reference/<format>.py``); each such
module gives ``hadamard``, ``weight_f64`` and ``linear`` with these
signatures.  This one knows the method ``quest`` only.

A frozen copy of the codec rules of the measured program's format spec,
written out again here so that the reference imports nothing of the
program: e2m1 RTNE with ties to the even code, saturating at +-6, NaN to
+0; e8m0 as the power-of-two floor of the fp32 scale; the QuEST scale
``sqrt(var) * 2.92247856/6 + 1e-8`` from the group's moments.  Each
rotated value is one fp32 chain in ascending i, and each group's sums a
xor butterfly of offsets 16 .. 1.  Dequantized fp4 values are exact in
fp64, and their products sum exactly in fp64 while a row's group scales
span fewer than ~40 binades, so the exact product is one fp64 matmul
rounded once to fp32.
"""
from __future__ import annotations

import torch

QUEST_CONST = 2.92247856 / 6.0


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def bits_f32(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32).contiguous().view(torch.float32)


def e2m1_codes(q: torch.Tensor) -> torch.Tensor:
    """fp32 -> e2m1 code 0..15 (int32), RTNE on the fp32 bits."""
    b = f32_bits(q)
    sign = (b >> 28) & 8
    a = b & 0x7FFFFFFF
    a = torch.where(a > 0x7F800000, torch.zeros_like(a), torch.clamp(a, max=0x40C00000))
    cl = (a > 0x3E800000).to(torch.int32) + (a >= 0x3F400000).to(torch.int32)
    r = a + 0x1FFFFF + ((a >> 22) & 1)
    code = torch.where(a < 0x3F800000, cl, (r >> 22) - 252)
    return code | sign


def e2m1_values(codes: torch.Tensor) -> torch.Tensor:
    """e2m1 code -> exact fp32 value."""
    c = codes.to(torch.int32)
    mag = c & 7
    e, m = mag >> 1, mag & 1
    bits = torch.where(e == 0, m * 0x3F000000, ((126 + e) << 23) | (m << 22))
    return bits_f32(torch.where(c >= 8, bits | -0x80000000, bits))


def pow2_floor(scale: torch.Tensor):
    """fp32 scale -> (power-of-two floor as fp32, e8m0 byte int32)."""
    bits = f32_bits(scale) & 0x7F800000
    return bits_f32(bits), bits >> 23


def pow2_f64(byte: torch.Tensor) -> torch.Tensor:
    """e8m0 byte -> exact fp64 2^(byte - 127); byte 255 -> NaN."""
    b = byte.to(torch.int64)
    v = ((b - 127 + 1023) << 52).view(torch.float64)
    return torch.where(b == 255, torch.full_like(v, float("nan")), v)


def f32_root(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 sqrt (the fp64 root rounded once)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def quest_scale(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    mean = s1 * (1.0 / 32.0)
    var = s2 * (1.0 / 32.0) - mean * mean
    scale = f32_root(torch.clamp(var, min=0.0)) * QUEST_CONST + 1e-8
    return torch.where(var >= 0.0, scale, torch.ones_like(scale))


def rotate_ordered(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x [..., K] bf16 rotated per chunk of r = h.shape[0] columns, each
    output one fp32 sum over i = 0 .. r-1 in order (a bf16 x bf16 product
    is exact in fp32, so each step rounds once, as an FMA does)."""
    r = h.shape[0]
    xr = x.reshape(-1, r).to(torch.float32)
    hh = h.to(torch.bfloat16).to(torch.float32)
    v = torch.zeros_like(xr)
    for i in range(r):
        v = v + xr[:, i:i + 1] * hh[i]
    return v.reshape(x.shape)


def butterfly_sum(g: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in xor-butterfly order (offsets n/2 .. 1)."""
    n = g.shape[-1]
    idx = torch.arange(n, device=g.device)
    o = n // 2
    while o:
        g = g + g[..., idx ^ o]
        o //= 2
    return g[..., 0]


def quantize_quest(x: torch.Tensor, h: torch.Tensor):
    """QuEST MXFP4 of bf16 x [R, K] under the rotation h: (codes int32
    [R, K], e8m0 bytes int32 [R, K/32], clip mask bool [R, K] that is
    True where the scaled value lies inside +-6)."""
    rows, k = x.shape
    g = rotate_ordered(x, h).reshape(rows, k // 32, 32)
    scale_f, byte = pow2_floor(quest_scale(butterfly_sum(g), butterfly_sum(g * g)))
    q = g / scale_f[..., None]
    return (e2m1_codes(q).reshape(rows, k), byte,
            (q.abs() < 6.0).reshape(rows, k))


def dequant_f64(codes: torch.Tensor, byte: torch.Tensor) -> torch.Tensor:
    """codes [R, K] and bytes [R, K/32] -> exact fp64 values [R, K]."""
    r, k = codes.shape
    v = e2m1_values(codes).to(torch.float64).reshape(r, k // 32, 32)
    return (v * pow2_f64(byte)[..., None]).reshape(r, k)


def dequantized_f64(x: torch.Tensor, h: torch.Tensor, method: str) -> torch.Tensor:
    """bf16 x [R, K] quantized under the rotation h by ``method`` and
    dequantized: its exact fp64 values."""
    if method != "quest":
        raise ValueError(f"the MXFP4 reference knows the method 'quest', not {method!r}")
    codes, byte, _ = quantize_quest(x, h)
    return dequant_f64(codes, byte)


def weight_f64(w: torch.Tensor, h: torch.Tensor, method: str) -> torch.Tensor:
    """A bf16 weight [N, K] quantized and dequantized, fp64."""
    return dequantized_f64(w, h, method)


def linear(x: torch.Tensor, w_dq: torch.Tensor, h: torch.Tensor, method: str) -> torch.Tensor:
    """The W4A4 linear: bf16(fp32(exact sum of dq(q(x H)) dq(W)^T)),
    x bf16 [R, K], w_dq the weight's exact fp64 dequantized values [N, K]."""
    acc = dequantized_f64(x, h, method) @ w_dq.T
    return acc.to(torch.float32).to(torch.bfloat16)


def hadamard(n: int, device) -> torch.Tensor:
    """The normalized Sylvester-Hadamard matrix H_n / sqrt(n), bf16."""
    h = torch.ones((1, 1), dtype=torch.float64)
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return (h * n ** -0.5).to(torch.bfloat16).to(device)
