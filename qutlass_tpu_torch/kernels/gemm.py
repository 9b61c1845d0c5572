"""Wrappers of the GEMM kernels K3 (``csrc/gemm_int8_rank1.cu``), K4
(``csrc/gemm_fp4_mx.cu``), K7 (``csrc/gemm_fp4_nv.cu``), K11
(``csrc/gemm_fp8_mx.cu``) and K18 (``csrc/gemm_fp4_experts.cu``, the
grouped MXFP4 GEMM of an expert layer: K4's decode arithmetic on each
routed expert's rows, every expert in one launch).

Each wrapper routes by device: tensors on the CPU go to the kernel's
plain version (``*_plain``, in ``ops.emulation``), tensors on a CUDA
device to the kernel.  Operands are passed to the kernels as logical row
views with their strides, so row-major, K-major and sliced scale buffers
need no copy.  A launch adds one to ``dispatch.launch_counts``.  An
alpha that is a CUDA tensor stays on the card (no host sync): K3 takes
it folded into ``sa``, K4, K7 and K11 read it from device memory (K4 takes
a number by value, with no launch for it).  K3, K4 and K7 write bf16 or,
with ``out_dtype=torch.float32``, the fp32 result unrounded.

K3 is two kernels, picked by M: up to ``DECODE_M`` rows the decode
kernel, which splits K over blocks (``decode_split``) and adds the int32
partial sums in a workspace allocated here, with one counter a column
tile that the kernel leaves zero (kept per device and stream, so two
streams never share one); above it the prefill kernel.

K4 and K7 pick between their kernels by ``fp4_kernel`` (format, layout
and shape alone).  In the ``kmajor`` layout up to ``DECODE_M`` rows both
run one decode kernel (``csrc/gemm_fp4_decode.cuh``, templated on the
format), which splits K over blocks (``fp4_decode_split``) and adds exact
fp64 partial sums in a workspace allocated here, with the same per-stream
counters.  Every other call runs one prefill kernel
(``csrc/gemm_fp4_prefill.cuh``, templated on the format: each group's sum
on the tensor cores, one int8 ``mma.sync`` a 16- or 32-group), which folds
each output's exact group terms into one fp64 chain in ascending k, with
no workspace.  A launch counts as ``gemm_fp4_mx`` and also as
``gemm_fp4_mx_decode`` or ``gemm_fp4_mx_prefill``; as ``gemm_fp4_nv`` and
also as ``gemm_fp4_nv_decode`` or ``gemm_fp4_nv_prefill``.  K4 has a
second prefill kernel for ``kmajor``, ``csrc/gemm_fp4_prefill_wg.cuh``
(one ``wgmma`` a 32-group beside the fp64 fold, bitwise the first), which
is not in the library and which no call here runs: the tools build it on
demand (``tools/time_nv_prefill.py``).
"""
from __future__ import annotations

import torch

from ..ops import dispatch
from ..ops import emulation as _emu
from ..ops.emulation import check_out_dtype
from ..ops.emulation import matmul_int8_rank1_plain as gemm_int8_rank1_plain
from . import _build

DECODE_M = 16            # K3's decode kernel takes M <= 16 rows
_DECODE_MAX_KC = 2048    # its K slices are at most this long
_counters: dict[tuple[int, int], torch.Tensor] = {}
_retired: list[torch.Tensor] = []   # outgrown counters a captured graph may still use
_FP4_DECODE_BLOCKS = 2   # K4's and K7's decode grid: resident blocks an SM

_NV_PLAIN = {"tn": _emu.matmul_nvf4_bf16_tn,
             "kmajor": _emu.matmul_nvf4_bf16_kmajor}
_FP8_PLAIN = {"tn": _emu.matmul_mxf8_bf16_tn,
              "nn": _emu.matmul_mxf8_bf16_nn}
_FP4_PLAIN = {"tn": _emu.matmul_mxf4_bf16_tn,
              "kmajor": _emu.matmul_mxf4_bf16_kmajor,
              "kmajor_codes": _emu.matmul_mxf4_bf16_kmajor_codes}


def _alpha_float(alpha) -> float:
    """Host value of alpha (a python number or a 1-element tensor)."""
    if isinstance(alpha, torch.Tensor):
        return float(alpha.reshape(()).to(torch.float32).item())
    return float(torch.tensor(alpha, dtype=torch.float32))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def decode_rows(kmajor_weight: bool) -> int:
    """Weight rows a block of K3's decode kernel: 128 for [K, N] weights
    (128-byte runs of each k-row), 64 for [N, K]."""
    return 128 if kmajor_weight else 64


def decode_split(n: int, k: int, sms: int, kmajor_weight: bool) -> tuple[int, int]:
    """(K slice length, number of slices) of K3's decode kernel: about six
    128-thread blocks an SM for an [N, K] weight, one and a half
    256-thread blocks for a [K, N] one (the best of 0.5x-4x these at the
    Qwen3-8B decode shapes on an H100); slices a multiple of the kernel's
    batch (128 k-rows of a [K, N] weight, 256 bytes of an [N, K] one) and
    at most 2048 long."""
    gran = 128 if kmajor_weight else 256
    tiles = -(-n // decode_rows(kmajor_weight))
    blocks = 3 * sms // 2 if kmajor_weight else 6 * sms
    kc = -(-k // -(-blocks // tiles))
    kc = min(_DECODE_MAX_KC, max(gran, -(-kc // gran) * gran))
    return kc, -(-k // kc)


def fp4_decode_cols(m: int) -> int:
    """Columns a block of the fp4 decode kernel (K4's and K7's) owns at M =
    m rows: 32 threads of 16 / MB columns, MB = 4, 8 or 16 the least
    bucket holding m (a thread keeps MB x columns fp64 sums)."""
    return 32 * (16 // (4 if m <= 4 else 8 if m <= 8 else 16))


def fp4_decode_split(m: int, n: int, k: int, sms: int, group: int) -> tuple[int, int]:
    """(K slice length, number of slices) of the fp4 decode kernel for
    ``group`` = 16 (K7, NVFP4) or 32 (K4, MXFP4): as many slices as keep
    every block resident at once (two 256-thread blocks an SM, no tail
    wave), but no more than keep the fp64 partial sums (slices x M x N x 8
    bytes) within a quarter of the weight's bytes (N x K x (1/2 + 1/group):
    0.5625 for NV, 0.53125 for MX); slices a multiple of 8 groups (one for
    each of the block's 8 warps) and at most 2048 long."""
    gran = 8 * group
    tiles = -(-n // fp4_decode_cols(m))
    want = max(1, _FP4_DECODE_BLOCKS * sms // tiles)
    cap = max(1, k * (group + 2) // (2 * group * 4 * 8 * m))
    kc = -(-k // min(want, cap))
    kc = min(_DECODE_MAX_KC, max(gran, -(-kc // gran) * gran))
    return kc, -(-k // kc)


def fp4_kernel(fmt: str, layout: str, m: int, n: int, k: int) -> str:
    """The kernel K4 (``fmt`` "mx") or K7 ("nv") runs for an M x K x N
    call in ``layout``: "decode" (``kmajor`` up to ``DECODE_M`` rows) or
    "prefill" (everything else)."""
    if fmt not in ("mx", "nv"):
        raise ValueError(f"invalid format {fmt!r}")
    return "decode" if layout == "kmajor" and m <= DECODE_M else "prefill"


def word_rows(t: torch.Tensor, rows: int) -> bool:
    """Whether the fp4 prefill kernel reads the logical [rows, K/2] packed
    K-major operand ``t`` in 4-byte words of rows (``pre::vec_rows``): unit
    stride along the rows, 4-byte aligned base and k-row stride, rows % 4
    == 0; else it reads it byte by byte."""
    return (t.stride(0) == 1 and t.data_ptr() % 4 == 0 and t.stride(1) % 4 == 0
            and rows % 4 == 0)


def _int8_strides(name: str, t: torch.Tensor) -> tuple[int, int]:
    """The (row, k) strides K3 is given for a logical [rows, K] int8 view:
    K-contiguous with 16-byte aligned rows and K % 16 == 0, or K-major
    (unit stride along the rows; a single row counts as either)."""
    rows, k = t.shape
    if t.stride(1) == 1 and t.stride(0) % 16 == 0 and k % 16 == 0 and t.data_ptr() % 16 == 0:
        return t.stride(0), 1
    if t.stride(0) == 1 or rows == 1:
        return 1, t.stride(1)
    raise ValueError(f"{name}: K3 takes a K-contiguous operand with 16-byte aligned rows and "
                     f"K % 16 == 0, or a K-major one; got shape {tuple(t.shape)} strides "
                     f"{t.stride()}")


def _decode_counters(dev: torch.device, tiles: int) -> torch.Tensor:
    """The zeroed arrival counters of K3's and K7's decode kernels for the
    current stream of ``dev`` (launches on one stream run in order, and
    each leaves the counters zero)."""
    stream = torch.cuda.current_stream(dev)
    key = (dev.index, stream.cuda_stream)
    cnt = _counters.get(key)
    if cnt is None or cnt.numel() < tiles:
        if cnt is not None:
            _retired.append(cnt)
        cnt = _counters[key] = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=dev)
    return cnt


def gemm_int8_rank1(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
                    sb: torch.Tensor, alpha, *, a_kmajor: bool, b_kmajor: bool,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel K3: C[M, N] = out_dtype(float(a' @ b'^T) * (sa * alpha) * sb).

    ``a`` is int8 [K, M] when ``a_kmajor`` else [M, K]; ``b`` is int8
    [K, N] when ``b_kmajor`` else [N, K]; sa f32 [M], sb f32 [N].  Each
    operand must be K-contiguous with 16-byte aligned rows and K % 16 == 0,
    or have unit stride along its rows (K-major); anything else raises.
    """
    a_mk = a.T if a_kmajor else a
    b_nk = b.T if b_kmajor else b
    out_dtype = check_out_dtype(out_dtype)
    if not dispatch.on_cuda(a, b, sa, sb):
        return gemm_int8_rank1_plain(a_mk, b_nk, sa, sb, alpha, out_dtype)
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"operands must be int8, got {a.dtype} / {b.dtype}")
    (m, k), (n, kb) = a_mk.shape, b_nk.shape
    if k != kb:
        raise ValueError(f"operands disagree on K: {k} vs {kb}")
    if min(m, n, k) == 0:
        raise ValueError(f"empty GEMM: M, N, K = {m}, {n}, {k}")
    for name, s, ln in (("sa", sa, m), ("sb", sb, n)):
        if s.dtype != torch.float32 or tuple(s.shape) != (ln,) or not s.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 [{ln}], got "
                             f"{s.dtype} {tuple(s.shape)}")
    a_s, b_s = _int8_strides("a", a_mk), _int8_strides("b", b_nk)
    if isinstance(alpha, torch.Tensor) and alpha.device.type == "cuda":
        # fp32 sa * alpha here is the product the kernel forms in its
        # epilogue, and sa * 1.0 is exact, so the result is the same bits
        sa, alpha = sa * alpha.reshape(()).to(torch.float32), 1.0
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    part = cnt = None
    kc = 0
    if m <= DECODE_M:
        kk = b_s[0] == 1                         # the weight is K-major
        kc, splits = decode_split(n, k, torch.cuda.get_device_properties(a.device)
                                  .multi_processor_count, kk)
        rows = decode_rows(kk)
        tiles = -(-n // rows)
        part = torch.empty((splits, tiles * rows, 16), dtype=torch.int32, device=a.device)
        cnt = _decode_counters(a.device, tiles)
    err = _build.library().qt_gemm_int8_rank1(
        a_mk.data_ptr(), *a_s, b_nk.data_ptr(), *b_s, sa.data_ptr(), sb.data_ptr(),
        _alpha_float(alpha), c.data_ptr(), int(out_dtype == torch.float32), m, n, k,
        None if part is None else part.data_ptr(), None if cnt is None else cnt.data_ptr(),
        kc, _stream(a))
    _build.check(err, "gemm_int8_rank1")
    dispatch.note_launch("gemm_int8_rank1")
    return c


def gemm_fp4_mx_plain(a, b, a_sf, b_sf, alpha, *, layout: str,
                      out_dtype: torch.dtype = torch.bfloat16):
    """Plain version of K4 for ``layout`` in ("tn", "kmajor",
    "kmajor_codes")."""
    return _FP4_PLAIN[layout](a, b, a_sf, b_sf, alpha, out_dtype)


def _fp4_decode_workspace(dev: torch.device, m: int, n: int, k: int, group: int):
    """(kc, fp64 partials [splits, m, n], counters) of a decode launch."""
    kc, splits = fp4_decode_split(m, n, k, torch.cuda.get_device_properties(dev)
                                  .multi_processor_count, group)
    part = torch.empty((splits, m, n), dtype=torch.float64, device=dev)
    return kc, part, _decode_counters(dev, -(-n // fp4_decode_cols(m)))


def gemm_fp4_mx(a: torch.Tensor, b: torch.Tensor, a_sf: torch.Tensor,
                b_sf: torch.Tensor, alpha, *, layout: str,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel K4: C[M, N] = out_dtype((dq(a) @ dq(b)^T) * alpha), the exact
    32-group terms folded in fp64 (the plain version's fp64 sum while they
    span fewer than ~40 binades; ``ops.emulation.gemm_fp4_mx_groupfold_plain``
    states the prefill kernel's order).

    ``layout="tn"``: a/b packed u8 [M, K/2] / [N, K/2], scales [M, K/32]
    / [N, K/32].  ``"kmajor"``: a/b packed [K/2, M] / [K/2, N], scales
    [K/32, M] / [K/32, N].  ``"kmajor_codes"``: a unpacked codes [K, M],
    b packed [K/2, N].  ``alpha``: a number (passed by value) or a
    1-element tensor (a CUDA one is read on the card: no host sync).
    K % 32 == 0.  ``fp4_kernel`` picks the kernel: ``kmajor`` at M <=
    ``DECODE_M`` runs the decode kernel, which takes a weight and scales
    of unit stride along N; any other call runs the prefill kernel, on
    any strides (a ``kmajor`` activation that ``word_rows`` refuses is
    first copied into zero-padded rows of a multiple of 4).  Anything else
    raises; nothing falls back to the plain version.
    """
    if layout not in _FP4_PLAIN:
        raise ValueError(f"invalid layout {layout!r}")
    out_dtype = check_out_dtype(out_dtype)
    if not dispatch.on_cuda(a, b, a_sf, b_sf):
        return gemm_fp4_mx_plain(a, b, a_sf, b_sf, alpha, layout=layout, out_dtype=out_dtype)
    for name, t in (("a", a), ("b", b), ("a_sf", a_sf), ("b_sf", b_sf)):
        if t.dtype != torch.uint8 or t.ndim != 2:
            raise TypeError(f"{name} must be a 2-D uint8 tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
    tn = layout == "tn"
    a_r, b_r = (a, b) if tn else (a.T, b.T)          # logical [rows, K or K/2]
    as_r, bs_r = (a_sf, b_sf) if tn else (a_sf.T, b_sf.T)
    a_packed = layout != "kmajor_codes"
    m, n = a_r.shape[0], b_r.shape[0]
    k = b_r.shape[1] * 2
    if a_r.shape[1] * (2 if a_packed else 1) != k:
        raise ValueError(f"operands disagree on K: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)} ({layout})")
    if tuple(as_r.shape) != (m, k // 32) or tuple(bs_r.shape) != (n, k // 32):
        raise ValueError(f"scale shapes {tuple(a_sf.shape)} / {tuple(b_sf.shape)} "
                         f"do not match M={m}, N={n}, K={k} ({layout})")
    if k % 32 or min(m, n, k) == 0:
        raise ValueError(f"K4 takes K % 32 == 0 and no empty operand; got M, N, K = "
                         f"{m}, {n}, {k}")
    al = alpha_val = None
    if isinstance(alpha, torch.Tensor) and alpha.device.type == "cuda":
        al = alpha.reshape(()).to(device=a.device, dtype=torch.float32)
    else:
        alpha_val = _alpha_float(alpha)             # a number, or a CPU tensor: no sync
    part = cnt = None
    kc = 0
    decode = fp4_kernel("mx", layout, m, n, k) == "decode"
    if decode:
        if b_r.stride(0) != 1 or bs_r.stride(0) != 1:
            raise ValueError(f"K4's decode kernel takes a weight and scales of unit stride "
                             f"along N; got b strides {b.stride()}, b_sf strides "
                             f"{b_sf.stride()}")
        kc, part, cnt = _fp4_decode_workspace(a.device, m, n, k, 32)
    rows = m
    if layout == "kmajor" and not decode and not word_rows(a_r, m):
        # a ragged (M % 4 != 0) or misaligned activation would be read byte
        # by byte, ~20% slower at M = 6523 on the H100 (PERF.md §6): copy it into
        # zero-padded rows of a multiple of 4 and drop the pad rows' outputs
        rows = -(-m // 4) * 4
        a_r = torch.nn.functional.pad(a, (0, rows - m)).T
        as_r = torch.nn.functional.pad(a_sf, (0, rows - m)).T
    c = torch.empty((rows, n), dtype=out_dtype, device=a.device)
    err = _build.library().qt_gemm_fp4_mx(
        a_r.data_ptr(), a_r.stride(0), a_r.stride(1), int(a_packed),
        as_r.data_ptr(), as_r.stride(0), as_r.stride(1),
        b_r.data_ptr(), b_r.stride(0), b_r.stride(1), 1,
        bs_r.data_ptr(), bs_r.stride(0), bs_r.stride(1),
        None if al is None else al.data_ptr(), alpha_val or 0.0, c.data_ptr(),
        int(out_dtype == torch.float32), rows, n, k,
        None if part is None else part.data_ptr(), None if cnt is None else cnt.data_ptr(),
        kc, _stream(a))
    _build.check(err, "gemm_fp4_mx")
    dispatch.note_launch("gemm_fp4_mx")
    dispatch.note_launch("gemm_fp4_mx_decode" if decode else "gemm_fp4_mx_prefill")
    return c[:m]


def gemm_fp4_experts(a: torch.Tensor, a_sf: torch.Tensor, b: torch.Tensor,
                     b_sf: torch.Tensor, offsets: torch.Tensor, alpha, *,
                     rows: torch.Tensor | None = None, max_rows: int,
                     counts: torch.Tensor | None = None,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel K18: the grouped MXFP4 GEMM of an expert layer, every expert
    in one launch.  Output row r of [offsets[e], offsets[e + 1]) is K4's
    row of activation column ``rows[r]`` (r itself where ``rows`` is None)
    against expert e's weight: C[r] = out_dtype((dq(a[:, rows[r]]) @
    dq(b[e])^T) * alpha), the same bits.

    ``a`` packed u8 [K/2, Ma] and ``a_sf`` [K/32, Ma] (K1's ``kmajor``
    layout, any strides); ``b`` [E, K/2, N] and ``b_sf`` [E, K/32, N],
    unit stride along N; ``offsets`` int32 [E + 1] and ``rows`` int32 [R]
    on the device (R = Ma without ``rows``); rows outside [offsets[0],
    offsets[E]) are not written.  ``max_rows`` bounds any expert's row
    count (the kernel's row tile; more rows are taken in turns).  Blocks
    of an expert without rows exit at once, so the launch reads only the
    routed experts' weights, and nothing is read on the host: graph-safe.
    ``alpha`` as for :func:`gemm_fp4_mx`.  ``counts``, a routing counter
    int64 [2, E] beside the operands, gains each expert's row count (row
    0) and 1 where it has rows (row 1) in the same launch.  On the CPU the
    plain version (K4's on each expert's rows)."""
    out_dtype = check_out_dtype(out_dtype)
    ts = (a, a_sf, b, b_sf, offsets) + tuple(t for t in (rows, counts) if t is not None)
    if not dispatch.on_cuda(*ts):
        return _emu.gemm_fp4_experts_plain(a, a_sf, b, b_sf, offsets, alpha, rows=rows,
                                           counts=counts, out_dtype=out_dtype)
    for name, t, nd in (("a", a, 2), ("a_sf", a_sf, 2), ("b", b, 3), ("b_sf", b_sf, 3)):
        if t.dtype != torch.uint8 or t.ndim != nd:
            raise TypeError(f"{name} must be a {nd}-D uint8 tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
    (kh, ma), (e, kb, n) = a.shape, b.shape
    k = 2 * kb
    r = ma if rows is None else rows.shape[0]
    if kh != kb or tuple(a_sf.shape) != (k // 32, ma) or tuple(b_sf.shape) != (e, k // 32, n):
        raise ValueError(f"shapes do not agree: a {tuple(a.shape)}, a_sf {tuple(a_sf.shape)}, "
                         f"b {tuple(b.shape)}, b_sf {tuple(b_sf.shape)}")
    if k % 32 or min(r, n, k, max_rows) <= 0:
        raise ValueError(f"K18 takes K % 32 == 0 and no empty operand; got R, N, K = "
                         f"{r}, {n}, {k}, max_rows {max_rows}")
    for name, t, ln in (("offsets", offsets, e + 1), ("rows", rows, r)):
        if t is not None and (t.dtype != torch.int32 or tuple(t.shape) != (ln,)
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 [{ln}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if counts is not None and (counts.dtype != torch.int64 or tuple(counts.shape) != (2, e)
                               or not counts.is_contiguous()):
        raise ValueError(f"counts must be contiguous int64 [2, {e}], got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if b.stride(2) != 1 or b_sf.stride(2) != 1:
        raise ValueError(f"K18 takes expert weights and scales of unit stride along N; got "
                         f"b strides {b.stride()}, b_sf strides {b_sf.stride()}")
    al = alpha_val = None
    if isinstance(alpha, torch.Tensor) and alpha.device.type == "cuda":
        al = alpha.reshape(()).to(device=a.device, dtype=torch.float32)
    else:
        alpha_val = _alpha_float(alpha)
    c = torch.empty((r, n), dtype=out_dtype, device=a.device)
    err = _build.library().qt_gemm_fp4_experts(
        a.data_ptr(), a.stride(1), a.stride(0), a_sf.data_ptr(), a_sf.stride(1), a_sf.stride(0),
        None if rows is None else rows.data_ptr(), offsets.data_ptr(), e,
        b.data_ptr(), b.stride(0), b.stride(1), b_sf.data_ptr(), b_sf.stride(0), b_sf.stride(1),
        None if al is None else al.data_ptr(), alpha_val or 0.0, c.data_ptr(),
        int(out_dtype == torch.float32), None if counts is None else counts.data_ptr(), max_rows,
        n, k, _stream(a))
    _build.check(err, "gemm_fp4_experts")
    dispatch.note_launch("gemm_fp4_experts")
    return c


def gemm_fp4_nv_plain(a, b, a_sf, b_sf, alpha, *, layout: str,
                      out_dtype: torch.dtype = torch.bfloat16):
    """Plain version of K7 for ``layout`` in ("tn", "kmajor")."""
    return _NV_PLAIN[layout](a, b, a_sf, b_sf, alpha, out_dtype)


def gemm_fp4_nv(a: torch.Tensor, b: torch.Tensor, a_sf: torch.Tensor,
                b_sf: torch.Tensor, alpha, *, layout: str,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel K7: C[M, N] = out_dtype((dq(a) @ dq(b)^T) * alpha), NVFP4
    operands (e2m1 codes, e4m3 bytes per 16-group).

    ``layout="tn"``: a/b packed u8 [M, K/2] / [N, K/2], scales [M, K/16]
    / [N, K/16].  ``"kmajor"``: a/b packed [K/2, M] / [K/2, N], scales
    [K/16, M] / [K/16, N].  ``alpha``: a number or a 1-element tensor.
    K % 16 == 0.  ``fp4_kernel`` picks the kernel: ``kmajor`` at M <=
    ``DECODE_M`` runs the decode kernel, which takes a weight and scales
    of unit stride along N; any other call runs the prefill kernel, on
    any strides.  Anything else raises; nothing falls back to the plain
    version.
    """
    if layout not in _NV_PLAIN:
        raise ValueError(f"invalid layout {layout!r}")
    out_dtype = check_out_dtype(out_dtype)
    al = torch.as_tensor(alpha, dtype=torch.float32, device=a.device).reshape(())
    if not dispatch.on_cuda(a, b, a_sf, b_sf, al):
        return gemm_fp4_nv_plain(a, b, a_sf, b_sf, al, layout=layout, out_dtype=out_dtype)
    for name, t in (("a", a), ("b", b), ("a_sf", a_sf), ("b_sf", b_sf)):
        if t.dtype != torch.uint8 or t.ndim != 2:
            raise TypeError(f"{name} must be a 2-D uint8 tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
    tn = layout == "tn"
    a_r, b_r = (a, b) if tn else (a.T, b.T)          # logical [rows, K/2]
    as_r, bs_r = (a_sf, b_sf) if tn else (a_sf.T, b_sf.T)
    m, n, k = a_r.shape[0], b_r.shape[0], b_r.shape[1] * 2
    if a_r.shape[1] * 2 != k:
        raise ValueError(f"operands disagree on K: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)} ({layout})")
    if tuple(as_r.shape) != (m, k // 16) or tuple(bs_r.shape) != (n, k // 16):
        raise ValueError(f"scale shapes {tuple(a_sf.shape)} / {tuple(b_sf.shape)} "
                         f"do not match M={m}, N={n}, K={k} ({layout})")
    if k % 16 or min(m, n, k) == 0:
        raise ValueError(f"K7 takes K % 16 == 0 and no empty operand; got M, N, K = "
                         f"{m}, {n}, {k}")
    part = cnt = None
    kc = 0
    decode = fp4_kernel("nv", layout, m, n, k) == "decode"
    if decode:
        if b_r.stride(0) != 1 or bs_r.stride(0) != 1:
            raise ValueError(f"K7's decode kernel takes a weight and scales of unit stride "
                             f"along N; got b strides {b.stride()}, b_sf strides "
                             f"{b_sf.stride()}")
        kc, part, cnt = _fp4_decode_workspace(a.device, m, n, k, 16)
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _build.library().qt_gemm_fp4_nv(
        a_r.data_ptr(), a_r.stride(0), a_r.stride(1),
        as_r.data_ptr(), as_r.stride(0), as_r.stride(1),
        b_r.data_ptr(), b_r.stride(0), b_r.stride(1),
        bs_r.data_ptr(), bs_r.stride(0), bs_r.stride(1),
        al.data_ptr(), c.data_ptr(), int(out_dtype == torch.float32), m, n, k,
        None if part is None else part.data_ptr(), None if cnt is None else cnt.data_ptr(),
        kc, _stream(a))
    _build.check(err, "gemm_fp4_nv")
    dispatch.note_launch("gemm_fp4_nv")
    dispatch.note_launch("gemm_fp4_nv_decode" if decode else "gemm_fp4_nv_prefill")
    return c


def gemm_fp8_mx_plain(a, b, a_sf, b_sf, alpha, *, layout: str):
    """Plain version of K11 for ``layout`` in ("tn", "nn")."""
    return _FP8_PLAIN[layout](a, b, a_sf, b_sf, alpha)


def gemm_fp8_mx(a: torch.Tensor, b: torch.Tensor, a_sf: torch.Tensor,
                b_sf: torch.Tensor, alpha, *, layout: str) -> torch.Tensor:
    """Kernel K11: C[M, N] = bf16((dq(a) @ dq(b)^T) * alpha), MXFP8
    operands (e4m3 bytes, an e8m0 byte per 32-group along K).

    ``layout="tn"``: a u8 [M, K]; ``"nn"``: a stored u8 [K, M].  b u8
    [N, K]; scales for the logical operands, a_sf [M, K/32] and b_sf
    [N, K/32] (any strides).  ``alpha``: a number or a 1-element tensor.
    """
    if layout not in _FP8_PLAIN:
        raise ValueError(f"invalid layout {layout!r}")
    al = torch.as_tensor(alpha, dtype=torch.float32, device=a.device).reshape(())
    if not dispatch.on_cuda(a, b, a_sf, b_sf, al):
        return gemm_fp8_mx_plain(a, b, a_sf, b_sf, al, layout=layout)
    for name, t in (("a", a), ("b", b), ("a_sf", a_sf), ("b_sf", b_sf)):
        if t.dtype != torch.uint8 or t.ndim != 2:
            raise TypeError(f"{name} must be a 2-D uint8 tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
    a_r = a if layout == "tn" else a.T               # logical [M, K]
    (m, k), n = a_r.shape, b.shape[0]
    if b.shape[1] != k:
        raise ValueError(f"operands disagree on K: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)} ({layout})")
    if k % 32:
        raise ValueError(f"K={k} must be a multiple of 32")
    if tuple(a_sf.shape) != (m, k // 32) or tuple(b_sf.shape) != (n, k // 32):
        raise ValueError(f"scale shapes {tuple(a_sf.shape)} / {tuple(b_sf.shape)} "
                         f"do not match M={m}, N={n}, K={k} ({layout})")
    c = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    err = _build.library().qt_gemm_fp8_mx(
        a_r.data_ptr(), a_r.stride(0), a_r.stride(1),
        a_sf.data_ptr(), a_sf.stride(0), a_sf.stride(1),
        b.data_ptr(), b.stride(0), b.stride(1),
        b_sf.data_ptr(), b_sf.stride(0), b_sf.stride(1),
        al.data_ptr(), c.data_ptr(), m, n, k, _stream(a))
    _build.check(err, "gemm_fp8_mx")
    dispatch.note_launch("gemm_fp8_mx")
    return c
