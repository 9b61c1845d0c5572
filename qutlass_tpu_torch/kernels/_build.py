"""Build and load the hand-written Hopper kernels.

The CUDA sources in ``qutlass_tpu_torch/csrc`` have a plain C interface.
At first use each is compiled with ``nvcc`` for ``sm_90a`` to an object
file, all of them at once in parallel processes, and the objects are
linked into one shared library under ``qutlass_tpu_torch/_build/``
(named by a hash of the sources and flags, so an edited source
rebuilds), which is loaded with ``ctypes``.  Nothing here runs at
import time, so the package imports on machines without ``nvcc`` or a
GPU; a build or load failure raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("quantize_mx.cu", "quantize_mx_int8.cu", "gemm_int8_rank1.cu",
           "gemm_fp4_mx.cu", "quantize_nv.cu", "quantize_nv_int8.cu",
           "gemm_fp4_nv.cu", "square_double.cu", "transpose_mxfp8.cu",
           "gemm_fp8_mx.cu", "backward_quant.cu", "fused_linear.cu", "gemm_fp4_experts.cu")
# no --use_fast_math: the scale math must round like the fp32 reference;
# --fmad=false keeps nvcc from contracting a*b+c in it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "qt_quantize_mx": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _LL,
                       _LL, _P],
    "qt_quantize_mx_int8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "qt_gemm_int8_rank1": [_P, _LL, _LL, _P, _LL, _LL, _P, _P, _F, _P, _I, _I,
                           _I, _I, _P, _P, _I, _P],
    "qt_gemm_fp4_mx": [_P, _LL, _LL, _I, _P, _LL, _LL, _P, _LL, _LL, _I, _P,
                       _LL, _LL, _P, _F, _P, _I, _I, _I, _I, _P, _P, _I, _P],
    "qt_gemm_fp4_experts": [_P, _LL, _LL, _P, _LL, _LL, _P, _P, _I, _P, _LL, _LL, _P, _LL,
                            _LL, _P, _F, _P, _I, _P, _I, _I, _I, _P],
    "qt_quantize_nv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _P],
    "qt_quantize_nv_int8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "qt_gemm_fp4_nv": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL,
                       _P, _P, _I, _I, _I, _I, _P, _P, _I, _P],
    "qt_square_double": [_P, _P, _P, _P, _I, _I, _I, _P],
    "qt_mxfp4_transpose_mxfp8": [_P, _P, _LL, _LL, _P, _P, _P, _I, _I, _P],
    "qt_mxfp4_transpose_scaled_kmajor": [_P, _P, _P, _I, _I, _P],
    "qt_gemm_fp8_mx": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL,
                       _P, _P, _I, _I, _I, _P],
    "qt_backward_t": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "qt_backward_qt": [_P, _P, _LL, _LL, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "qt_fused_linear_mx": [_P, _P, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _I, _I, _I, _I, _I,
                           _P],
    "qt_fused_linear_nv": [_P, _P, _P, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _I, _I, _I, _I,
                           _I, _P],
}

# entry points of sources that are not in the library: the tools build them
# on demand (tools/_variants.build)
ON_DEMAND_SIGNATURES = {
    "qt_gemm_fp4_mx_wg": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _F, _P,
                          _I, _I, _I, _I, _P],
}

_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the Hopper kernels are built from "
                           "qutlass_tpu_torch/csrc with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / src for src in SOURCES]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run(procs) -> None:
    """Wait for every (cmd, Popen); raise on the first that failed."""
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    return its path."""
    out = BUILD_DIR / f"libqutlass_torch_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in SOURCES:        # one nvcc per source, all started together
            obj = str(Path(tmpdir, src.replace(".cu", ".o")))
            cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
            objs.append(obj)
        _run(procs)
        lib = str(Path(tmpdir, "lib.so"))
        cmd = [nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(lib, out)   # atomic: a concurrent build sees a whole file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.qt_error_string.argtypes = [ctypes.c_int]
        lib.qt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().qt_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {msg} ({err})")
