"""What the harness promises: the result line's keys, the refusal without a
card, the import check by whole module names."""
import ast
import json
import os
import shutil
import subprocess
import sys

import tiny
from port_bench.lib import harness as H

CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}


def test_result_line_keys_plain_and_traced():
    plain = tiny.run(tiny.serving_cell())
    assert set(plain) == CONTRACT | {"checks"} and list(plain)[-1] == "checks"
    assert set(plain["metrics"]) == {"itl_ms_p95", "setup_s"}
    assert set(plain["checks"]) == {"widest_logit_gap", "logit_max_abs_diff"}
    traced = tiny.run(tiny.serving_cell(), trace=1)
    assert set(traced) == CONTRACT | {"breakdown", "checks"} and list(traced)[-1] == "checks"
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in traced["breakdown"].values())
    json.dumps(traced)
    long = tiny.run(tiny.serving_cell(decode_steps=0, batch=1,
                                      name="qwen3-8b-mxfp4.long-prompt"))
    assert set(long["metrics"]) == {"ttft_ms_p95", "serve_tok_s", "setup_s"}


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    spec = H.load_json(H.ROOT / "BENCHMARK.json")
    for w in spec["workloads"]:
        cell = H.Cell(spec, w["name"])
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = cell.per_layer()
        assert per and all(m["moves"] in e2e for m in per)
        assert (H.BENCH / "drivers" / f"{cell.traffic['driver']}.py").exists()


def test_refuses_without_a_card(tmp_path):
    """Run from a directory holding only BENCHMARK.json and the benchmark's
    files: no card here, so exit 2 and no result line."""
    shutil.copy(H.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(H.BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (tmp_path, H.ROOT):
        out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                              "qwen3-8b-mxfp4.chat-b4", "--seed", str(2 ** 31 + 3),
                              "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_names_compared_whole():
    assert H.forbidden_loaded(["qutlass_tpu_torch", "qutlass_tpu_torch.models", "jaxtyping",
                               "flaxen", "torch"]) == []
    assert H.forbidden_loaded(["qutlass_tpu", "qutlass_tpu.ops", "jax.numpy", "jaxlib",
                               "flax.linen"]) == ["flax.linen", "jax.numpy", "jaxlib",
                                                  "qutlass_tpu", "qutlass_tpu.ops"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_and_the_reference_imports_no_program():
    for path in H.BENCH.rglob("*.py"):
        names = set(_imports(path))
        assert not names & set(H.FORBIDDEN), (path, names)
        if "reference" in path.parts:
            assert "qutlass_tpu_torch" not in names, path


def test_a_run_loads_no_jax():
    code = ("import sys, runpy; sys.argv=['x']; sys.path.insert(0, 'port_bench/tests');"
            "import tiny; tiny.run(tiny.serving_cell());"
            "from port_bench.lib import harness as H; print(H.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
