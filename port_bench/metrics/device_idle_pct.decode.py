"""Share of the traced stretch (decode) in which no device operation ran:
1 - (union of the device operations' intervals) / (the stretch's wall
time), both from the same trace."""
from port_bench.lib import readers as R

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "itl_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.chat-b4"]


def read(ctx):
    return R.idle_pct(ctx["trace"])
