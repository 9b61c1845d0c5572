"""The share of a traced prefill's host time (the program's ``qt.prefill``
span) spent inside its ``qt.rope`` spans: ``_rope`` copies its inverse
frequencies from the host to the card, a copy that waits for the kernels
queued before it, so the host stops running ahead of the device there."""
from port_bench.lib import spans as S

LAYER = "model step"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "ttft_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.long-prompt"]


def read(ctx):
    trace = ctx["trace"]
    prefill, rope = S.host_ms(trace, "qt.prefill"), S.host_ms(trace, "qt.rope")
    return 100.0 * rope / prefill if prefill and rope is not None else None
