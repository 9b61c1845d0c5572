"""Device-busy milliseconds per 1000 prompt tokens over the traced stretch
of prefill-only requests."""
from port_bench.lib import readers as R

LAYER = "model step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "ttft_ms_p95"
WORKLOADS = ["qwen3-8b-mxfp4.long-prompt"]


def read(ctx):
    trace = ctx["trace"]
    tokens = trace.work.get("prompt_tokens") if trace else None
    busy = R.busy_ms_per_unit(trace)
    return busy * trace.units / (tokens / 1000.0) if busy is not None and tokens else None
