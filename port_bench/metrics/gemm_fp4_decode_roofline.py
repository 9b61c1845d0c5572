"""Share of its roofline that K4's decode kernel (the MXFP4 GEMM at
M <= 16) reaches in the traced decode steps: the work bound of every
projection GEMM of those steps (``counts.fp4_gemm_bound_s``, from the
configuration's shapes) over the device time of the kernels named
below.  A kernel renamed or taken off the path leaves it unread."""
from port_bench.lib import readers as R

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "itl_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.chat-b4"]
PATTERNS = ("gemm_fp4_decode",)


def read(ctx):
    return R.fp4_gemm_roofline_pct(ctx["trace"], PATTERNS, lambda m: m <= 16)
