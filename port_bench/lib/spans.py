"""The host side of the program's spans in a traced stretch.

The port marks parts of its serving path with ``qt.*`` host ranges
(``qutlass_tpu_torch.ops.dispatch.span``), which exist only while a
profiler records: a ``Trace`` keeps them among its host operations, with
their times on the profiler's clock.  A parent program without spans
reads nothing.
"""
from __future__ import annotations

PREFIX = "qt."


def from_trace(trace):
    """{name: {"count", "host_us"}} of the ``qt.*`` spans of a ``Trace``,
    ``host_us`` inclusive of the spans inside; None without a trace or a
    ``qt.*`` span."""
    out: dict = {}
    for name, s, e in (trace.host if trace else ()):
        if name.startswith(PREFIX):
            row = out.setdefault(name, {"count": 0, "host_us": 0.0})
            row["count"] += 1
            row["host_us"] += e - s
    return out or None


def host_ms(trace, name: str):
    """Host milliseconds inside the ``name`` spans per unit of the
    stretch (decode step, request), or None without them."""
    row = (from_trace(trace) or {}).get(name)
    return row["host_us"] / 1e3 / trace.units if row else None
