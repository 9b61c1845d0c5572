"""Readings that set the output check's limits, on the chip at a cell's
own size: the program's numbers over many seeds (the lower readings) and
the control's (the plain reference computed one precision lower, in the
program's place: TF32 in its fp32 matmuls).

    python3 port_bench/calibrate.py --workload <cell> --seeds 1 2 3 [--seconds 14]
        [--control] [--out calib.jsonl]

After set-up, a short window at the cell's load, then the reference over
the checked batches twice, in fp32 and in TF32.  The control's readings:
the widest gap, in the fp32 reference's logits, of the token that the
TF32 pass puts first at each served position, and the largest
difference of a TF32 logit from the fp32 one.  The benchmark's own runs
do none of this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from port_bench.lib import harness as H  # noqa: E402


def serving(driver, run, seconds: float, control: bool) -> dict:
    run.setup()
    run.window(seconds)
    run.release()
    t = time.perf_counter()
    sample = run._sample()
    batches = run.reference_batches(sample)
    logits = run.reference_logits(batches, (False, True) if control else (False,))
    ref = logits[False]
    out = {"widest_logit_gap": max(run.ref.widest_gap(lg, b[2]) for lg, b in zip(ref, batches)),
           "logit_max_abs_diff": driver.largest_diff(ref, run.program_logits(sample)),
           "reference_s": time.perf_counter() - t, "checked_batches": len(batches)}
    if control:
        low = logits[True]
        out["control.widest_logit_gap"] = max(
            run.ref.widest_gap(r, b[2], [lg.argmax(dim=-1) for lg in c])
            for r, c, b in zip(ref, low, batches))
        out["control.logit_max_abs_diff"] = driver.largest_diff(ref, low)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=14.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = H.Cell(H.load_json(ROOT / "BENCHMARK.json"), args.workload)
    driver = cell.driver()
    for seed in args.seeds:
        run = driver.Run(cell, seed, "cuda")
        t = time.perf_counter()
        row = serving(driver, run, args.seconds, args.control)
        row = {"cell": cell.name, "seed": seed, "seconds": time.perf_counter() - t, **row}
        del run
        torch.cuda.empty_cache()
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(ROOT / args.out, "a") as f:
                f.write(line + "\n")
    bad = H.forbidden_loaded()
    print(f"forbidden modules loaded: {bad}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
