"""Model FLOPs done in the measured window (prefill; ``counts``: 2 N K a
linear and token, 4 heads head_dim context of attention, 2 V D a logits
row) over the window's seconds at the int8
dense peak, 1979 TOP/s."""
from port_bench.lib import readers as R

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "ttft_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.long-prompt"]


def read(ctx):
    return R.mfu_pct(ctx["work"])
