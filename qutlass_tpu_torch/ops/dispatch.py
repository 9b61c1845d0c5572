"""Kernel dispatch by tensor device, and the per-kernel launch counters.

The JAX package chooses between Pallas kernels and XLA emulation at run
time.  Here the choice follows the tensors alone: tensors on the CPU go
to a kernel's plain PyTorch version, tensors on a CUDA device go to the
hand-written Hopper kernel, and anything else raises.  There is no
switch that sends CUDA tensors to a plain version.

``launch_counts`` maps each kernel's name to the number of times its
wrapper launched it; only a kernel launch adds to it, so a run can show
which kernels its main path went through.  ``gemm_fp4_mx`` counts every
launch of K4, ``gemm_fp4_mx_decode`` and ``gemm_fp4_mx_prefill`` those
that ran its decode or its prefill kernel; ``gemm_fp4_nv`` counts every
launch of K7, ``gemm_fp4_nv_decode`` and ``gemm_fp4_nv_prefill`` those that
ran its decode or its prefill kernel; ``gemm_fp4_experts`` counts K18, the
grouped expert GEMM (one launch a projection of an expert layer).

``span(name)`` decorates a function of the serving path: while a torch
profiler records, each call is a ``record_function(name)`` range on the
profile's clock beside its device trace, and the launch calls made in it
nest in it; otherwise the call goes straight through after one flag
read (a ``record_function`` costs 7-14 us even with no profiler running).
The ranges live only in the profile's memory.  A span makes no CUDA call,
so it is harmless under CUDA-graph capture.  The spans, outermost first:
``qt.decode_step`` / ``qt.prefill`` (``models.serving``), in them
``qt.attend``, ``qt.rope`` and ``qt.linear`` (``nn.linear.quantized_linear``,
the activation's quantize and the GEMM), and in LFM2's layers ``qt.conv``
(``models.shortconv``: the short-conv mixer, its projections included) and
``qt.moe`` (``models.experts``: router, dispatch, experts, combine).  A ragged decode step on the card
holds ``qt.graph_capture`` (a cache's first step: its eager run, then the
CUDA graph's capture) or ``qt.graph_replay`` (every later step: no other
span runs in it).  A replay adds the launches its capture noted.

``fused_linear_single_kernel`` is the JAX package's switch between the
two bitwise-identical routes of ``fused_linear_mxf4`` / ``_nvf4``.
"""
from __future__ import annotations

import functools
import os

import torch
from torch.autograd import profiler as _profiler

KERNELS = ("quantize_mx", "quantize_mx_int8", "gemm_int8_rank1",
           "gemm_fp4_mx", "gemm_fp4_mx_decode", "gemm_fp4_mx_prefill", "quantize_nv",
           "quantize_nv_int8", "gemm_fp4_nv", "gemm_fp4_nv_decode", "gemm_fp4_nv_prefill",
           "square_double_scaled", "square_double_mxfp8", "mxfp4_transpose_mxfp8",
           "gemm_fp8_mx", "backward_t_bf16", "backward_qt_bf16", "mxfp4_transpose_scaled",
           "mxfp4_transpose_scaled_kmajor", "fused_linear_mx", "fused_linear_nv",
           "gemm_fp4_experts")

launch_counts: dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def note_launch(name: str) -> None:
    launch_counts[name] += 1


def span(name: str):
    """Decorate a function so that each call is a ``record_function(name)``
    range while a torch profiler records."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def fused_linear_single_kernel() -> bool:
    """``QUTLASS_TPU_FUSED_LINEAR``, read at every call: unset, "" or "0"
    runs ``fused_linear_*`` as the composition of the quantize and GEMM
    kernels (K1 + K4, K5 + K7), anything else as the single kernel K16 /
    K17.  On the CPU it picks between the same routes' plain versions."""
    return os.environ.get("QUTLASS_TPU_FUSED_LINEAR", "") not in ("", "0")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device (launch the
    kernel), False when every tensor lies on the CPU (plain version).
    Mixed or other devices raise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands lie on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
