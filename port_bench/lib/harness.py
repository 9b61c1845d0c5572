"""The harness: finds a cell's files by the names in BENCHMARK.json, runs
its driver through set-up, the measured window, the traced stretch and
the output check, and prints the result line.

Nothing here knows a configuration, a mix or a metric by name: a later
cell, mix, driver or metric is a new file and a new BENCHMARK.json entry.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
# whole top-level module names that no run may load (the JAX package's
# name is a prefix of the port's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "qutlass_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (metric files have dots
    in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


class Cell:
    """A workload of BENCHMARK.json with its files loaded."""

    def __init__(self, spec: dict, name: str):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.spec, self.entry, self.name = spec, cells[name], name
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = load_json(ROOT / configs[self.entry["config"]]["file"])
        self.traffic = load_json(BENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.checks = load_json(BENCH / "checks" / f"{name}.json")
        self.chips = self.entry["chips"]

    @classmethod
    def from_parts(cls, spec: dict, name: str, config: dict, traffic: dict, checks: dict,
                   chips: int = 1) -> "Cell":
        """A cell held in memory (the tests' tiny cells)."""
        cell = cls.__new__(cls)
        cell.spec, cell.name, cell.config, cell.traffic, cell.checks = (
            spec, name, config, traffic, checks)
        cell.entry, cell.chips = {"name": name, "chips": chips}, chips
        return cell

    def applies(self, metric: dict, e2e_names=None) -> bool:
        """Whether this cell reports ``metric``: it lists the cell, or it
        lists none and the cell reports the metric it moves."""
        if "workloads" in metric:
            return self.name in metric["workloads"]
        if e2e_names is None or "moves" not in metric:
            return True
        return metric["moves"] in e2e_names

    def end_to_end(self) -> list:
        return [m for m in self.spec["end_to_end"] if self.applies(m)]

    def per_layer(self) -> list:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"] if self.applies(m, e2e)]

    def driver(self):
        return load_module(BENCH / "drivers" / f"{self.traffic['driver']}.py",
                           f"port_bench_driver_{self.traffic['driver']}")


def power_limit_w():
    """The card's power limit in watts, from nvidia-smi (None if unread)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def steady_host(torch) -> None:
    """One intra-op thread, and the main thread held to one core of those
    the process may use (the last), so that a run's host loop neither
    migrates nor shares its core with the process's other threads."""
    torch.set_num_threads(1)
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[-1]})


def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "power_limit_w": power_limit_w()}


def read_per_layer(cell: Cell, trace, work: dict) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    ctx = {"trace": trace, "work": work}
    for m in cell.per_layer():
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             "port_bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: list) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit, and finite."""
    table, ok = {}, True
    for name, value, limit in numbers:
        table[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok and bool(numbers), table


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell: Cell, args, t0: float, device: str, device_desc: dict) -> dict:
    """Set-up, window, traced stretch and check of one run; returns the
    result line's object.  ``device`` is "cuda" on the chip; the tests
    drive it on "cpu" at a tiny size."""
    import torch

    run = cell.driver().Run(cell, args.seed, device)
    run.setup()
    gc.collect()
    gc.freeze()                 # what set-up made is not scanned again in the window
    setup_s = time.perf_counter() - t0
    win = run.window(args.seconds)
    metrics = {}
    if args.trace:
        trace = run.traced()
        metrics = read_per_layer(cell, trace, win["work"])
        from . import trace as T
        device_desc = dict(device_desc, busy_s=T.busy_s(trace), window_s=trace.window_s)
        extra = {"breakdown": T.breakdown(trace)}
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        for m in cell.end_to_end():
            if m["name"] not in values:
                raise RuntimeError(f"{cell.traffic['driver']} gave no {m['name']} for {cell.name}")
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
        extra = {}
    if device == "cuda":
        torch.cuda.synchronize()
        device_desc = dict(device_desc, memory_peak_bytes=torch.cuda.max_memory_allocated())
    run.release()
    correct, table = judge(run.check())
    return {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
            "metrics": metrics, "device": device_desc, **extra, "checks": table}


def main(argv, t0: float) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(spec, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}: "
              "no result", file=sys.stderr)
        return 2
    torch.cuda.init()
    steady_host(torch)
    result = run_cell(cell, args, t0, "cuda", device_info(torch, cell.chips))
    bad = forbidden_loaded()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}: no result",
              file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
