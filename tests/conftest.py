"""Test configuration.

Tests default to the CPU backend with an 8-device virtual mesh so the
suite is hermetic (the driver validates multi-chip sharding this way).
Set QUTLASS_TPU_TEST_PLATFORM=tpu to run the same suite on real TPU
hardware (kernel-vs-golden checks then exercise the compiled Pallas
path).
"""
import os

os.environ.setdefault("XLA_FLAGS",
                      os.environ.get("XLA_FLAGS", "")
                      + " --xla_force_host_platform_device_count=8")

_PLATFORM = os.environ.get("QUTLASS_TPU_TEST_PLATFORM", "cpu")

import jax  # noqa: E402

if _PLATFORM == "cpu":
    jax.config.update("jax_platforms", "cpu")

# Persistent compile cache: OPT-IN on CPU (QUTLASS_TPU_TEST_CACHE=1).
# The CPU cache proved UNSOUND in this jaxlib/host combo — three
# distinct crash signatures across full-suite runs with it enabled:
# (1) SIGSEGV serializing multi-device executables (put_executable_
# and_time), (2) the same after guarding writes to single-device
# programs only, now inside backend_compile_and_load on a later big
# shard_map compile, (3) reproduced with a freshly-purged cache dir —
# while every cached LOAD logs an AOT machine-feature mismatch
# ("could lead to execution errors such as SIGILL").  Standalone
# module runs with the cache are fine; the full suite is not.  For
# fast iteration use `python -m pytest tests -n 8` (pytest-xdist)
# instead — compiles parallelize across workers.
_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))),
    ".jax_cache" if _PLATFORM != "cpu" else ".jax_cache_cpu")
if _PLATFORM != "cpu" or os.environ.get("QUTLASS_TPU_TEST_CACHE") == "1":
    jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Even opt-in, never serialize MULTI-DEVICE CPU executables (hard
# SIGSEGV in the xla serialize call, observed twice on test_serving_tp's
# big shard_map program).  The patch touches a private jax symbol, so it
# is applied only when the cache is actually enabled and tolerates the
# symbol moving in a jaxlib upgrade (the cache is best-effort anyway).
if _PLATFORM != "cpu" or os.environ.get("QUTLASS_TPU_TEST_CACHE") == "1":
    try:
        from jax._src import compilation_cache as _cc

        _orig_put_executable = _cc.put_executable_and_time

        def _put_single_device_only(cache_key, module_name, executable,
                                    backend, compile_time):
            try:
                ndev = len(executable.local_devices())
            except Exception:
                ndev = 2  # unknown shape: be safe, skip the write
            if ndev > 1:
                return
            return _orig_put_executable(cache_key, module_name, executable,
                                        backend, compile_time)

        _cc.put_executable_and_time = _put_single_device_only
    except (ImportError, AttributeError):  # jax internals moved
        pass


# Two-tier suite: the default run skips tests marked ``slow`` (heavy
# model/serving geometries whose features also have light smoke
# coverage) so the routine gate finishes in minutes; set
# QUTLASS_TPU_TEST_FULL=1 for the complete suite (CI / pre-release).
_FULL = os.environ.get("QUTLASS_TPU_TEST_FULL", "") not in ("", "0")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy test, skipped by default; QUTLASS_TPU_TEST_FULL=1 "
        "(or -m slow) runs it")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (PyTorch port); skips without one")


def pytest_collection_modifyitems(config, items):
    if _FULL or config.getoption("-m"):
        return  # explicit -m selection overrides the tiering
    skip = pytest.mark.skip(
        reason="slow tier (set QUTLASS_TPU_TEST_FULL=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _seed_each_test():
    np.random.seed(0)


@pytest.fixture
def on_tpu():
    return jax.default_backend() not in ("cpu", "gpu")
