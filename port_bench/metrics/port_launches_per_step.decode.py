"""Launches of the port's own kernels per decode step, from the program's
counter ``ops.dispatch.launch_counts`` over the traced decode steps (each
kernel wrapper adds one a launch); beside ``kernels_per_step.decode``,
which counts every kernel in the trace, it splits the port's launches
from PyTorch's."""
LAYER = "kernels"
UNIT = "count"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "itl_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.chat-b4"]


def read(ctx):
    trace = ctx["trace"]
    n = trace.work.get("port_launches") if trace is not None else None
    return n / trace.units if n and trace.units else None
