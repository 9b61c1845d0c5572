"""Device-busy milliseconds per decode step: the union of the device
operations' intervals over the traced stretch of decode steps, per step."""
from port_bench.lib import readers as R

LAYER = "model step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "itl_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.chat-b4"]


def read(ctx):
    return R.busy_ms_per_unit(ctx["trace"])
