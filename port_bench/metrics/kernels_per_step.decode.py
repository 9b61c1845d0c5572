"""Device kernels launched per decode step (copies and sets left out),
counted in the traced stretch of decode steps."""
from port_bench.lib import readers as R

LAYER = "model step"
UNIT = "count"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "itl_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.chat-b4"]


def read(ctx):
    return R.kernels_per_unit(ctx["trace"])
