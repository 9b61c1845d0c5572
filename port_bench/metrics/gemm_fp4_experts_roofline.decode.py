"""Share of its roofline that K18, the grouped MXFP4 expert GEMM, reaches
in the traced decode steps: the work bound of every grouped launch of
those steps (``expert_counts.experts_bound_s``: each active expert's
weight read once a step, the routed rows' activation codes, scales and
bf16 outputs, at the int8 peak; rows and active experts from the
program's routing counters) over the device time of the kernels named
below.  A program without the kernel or the counters leaves it unread."""
from port_bench import expert_counts as EC
from port_bench.lib import trace as T

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "itl_ms_p95"
WORKLOADS = ["lfm2-24b-a2b-mxfp4.chat-b8"]
PATTERNS = ("gemm_fp4_experts",)


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    ops = T.matching(trace, PATTERNS)
    gemms = trace.work.get("expert_gemms")
    if not ops or not gemms:
        return None
    return 100.0 * EC.experts_bound_s(gemms) / T.total_s(ops)
