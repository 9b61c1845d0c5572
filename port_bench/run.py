"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in BENCHMARK.json: a configuration
(``port_bench/configs/<config>.json``) under a traffic mix
(``port_bench/traffic/<mix>.json``), driven by the mix's driver
(``port_bench/drivers/<driver>.py``) and checked against the limits of
``port_bench/checks/<cell>.json``.  With ``--trace 1`` the per-layer
metrics are read by ``port_bench/metrics/<metric>.py``.  The run needs a
CUDA card; without one it exits with code 2 and prints no result.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from port_bench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
