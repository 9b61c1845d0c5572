"""Arithmetic shared by the per-layer metric readers (each reader is a
file of ``port_bench/metrics`` that names its own kernels and work).
A reader returns None where its stretch holds nothing to read."""
from __future__ import annotations

from port_bench import counts
from port_bench.lib import trace as T


def idle_pct(trace):
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - T.busy_s(trace) / trace.window_s)


def busy_ms_per_unit(trace):
    if trace is None or not trace.units or not trace.in_stretch():
        return None
    return T.busy_s(trace) * 1e3 / trace.units


def kernels_per_unit(trace):
    if trace is None or not trace.units or not trace.kernels():
        return None
    return len(trace.kernels()) / trace.units


def fp4_gemm_roofline_pct(trace, patterns, select):
    """The work bound of the stretch's W4A4 GEMMs that ``select(m)``
    keeps (by row count m), over the device time of the kernels whose
    names hold ``patterns``."""
    if trace is None:
        return None
    ops = T.matching(trace, patterns)
    gemms = [g for g in trace.work.get("gemms", []) if select(g[0])]
    if not ops or not gemms:
        return None
    group = counts.GROUP[trace.work.get("format", "mxfp4")]
    return 100.0 * counts.fp4_gemms_bound_s(gemms, group) / T.total_s(ops)


def mfu_pct(work):
    """Model FLOPs done in the window over the window's seconds at the
    int8 dense peak."""
    if not work or not work.get("flops") or not work.get("seconds"):
        return None
    return 100.0 * work["flops"] / (work["seconds"] * counts.MFU_PEAK)
