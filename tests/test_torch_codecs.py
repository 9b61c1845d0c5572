"""The port's codecs against the JAX codecs, bit for bit: every byte value
and a dense fp32 sweep of [-8, 8] plus specials."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from qutlass_tpu.formats import codecs as JC
from qutlass_tpu_torch.formats import codecs as TC
import torch_helpers  # noqa: F401  (the worker's thread budget)

PKG = pathlib.Path(__file__).resolve().parent.parent / "qutlass_tpu_torch"

_SPECIALS = np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 0.25, 0.75,
                      1.25, 1.75, 2.5, 3.5, 5.0, 6.0, 7.0, 1e-45, -1e-45,
                      1e-38, 3.4e38, -3.4e38], np.float32)


def _sweep() -> np.ndarray:
    dense = np.linspace(-8.0, 8.0, 400_001, dtype=np.float32)
    # every fp32 in a window around each e2m1 rounding boundary
    mids = np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 6.0], np.float32)
    bits = mids.view(np.int32)[:, None] + np.arange(-64, 65, dtype=np.int32)
    near = bits.reshape(-1).view(np.float32)
    return np.concatenate([dense, near, -near, _SPECIALS])


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def test_e2m1_codes_match_jax():
    x = _sweep()
    want = np.asarray(JC.e2m1_rtne_codes(jnp.asarray(x)))
    got = TC.e2m1_rtne_codes(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_e2m1_codes_to_m2_match_jax():
    c = np.arange(16, dtype=np.int32)
    want = np.asarray(JC.e2m1_codes_to_m2(jnp.asarray(c)))
    np.testing.assert_array_equal(TC.e2m1_codes_to_m2(torch.from_numpy(c)).numpy(),
                                  want)


def test_decode_scaled_all_bytes_match_jax():
    codes, sb = np.meshgrid(np.arange(16, dtype=np.int32),
                            np.arange(256, dtype=np.int32), indexing="ij")
    want = np.asarray(JC.e2m1_decode_scaled_bf16(jnp.asarray(codes),
                                                 jnp.asarray(sb))).view(np.uint16)
    got = TC.e2m1_decode_scaled_bf16(torch.from_numpy(codes), torch.from_numpy(sb))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


@pytest.mark.parametrize("fn", ["e8m0_decode_f32", "e8m0_recip_f32"])
def test_e8m0_all_bytes_match_jax(fn):
    b = np.arange(256, dtype=np.int32)
    want = _bits(getattr(JC, fn)(jnp.asarray(b)))
    np.testing.assert_array_equal(_bits(getattr(TC, fn)(torch.from_numpy(b)).numpy()),
                                  want)


def test_pow2_f32_matches_jax():
    n = np.arange(-300, 300, dtype=np.int32)
    np.testing.assert_array_equal(_bits(TC.pow2_f32(torch.from_numpy(n)).numpy()),
                                  _bits(JC.pow2_f32(jnp.asarray(n))))


def test_pow2_floor_matches_jax():
    x = np.abs(_sweep())
    x = np.concatenate([x, np.float32(2.0) ** np.arange(-149, 128, dtype=np.float32)])
    jf, jb = JC.pow2_floor_e8m0(jnp.asarray(x))
    tf, tb = TC.pow2_floor_e8m0(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(tf.numpy()), _bits(jf))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_scale_functions_match_jax():
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((4096, 32)) * np.exp(rng.uniform(-20, 20, (4096, 1)))
         ).astype(np.float32)
    s1, s2 = g.sum(-1), (g * g).sum(-1)
    s2[:4] = s1[:4] ** 2 / 32 * 0.999          # negative variance -> 1.0
    want = JC.mx_scale_quest(jnp.asarray(s1), jnp.asarray(s2), 32.0)
    got = TC.mx_scale_quest(torch.from_numpy(s1), torch.from_numpy(s2), 32.0)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    amax = np.abs(g).max(-1)
    np.testing.assert_array_equal(
        _bits(TC.mx_scale_absmax(torch.from_numpy(amax)).numpy()),
        _bits(JC.mx_scale_absmax(jnp.asarray(amax))))


def test_port_never_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.]|import\s+qutlass_tpu\b"
                         r"(?!_torch)|from\s+qutlass_tpu\b(?!_torch))", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py") if pattern.search(p.read_text())]
    assert not offenders, offenders
    code = ("import sys, qutlass_tpu_torch, qutlass_tpu_torch.models, "
            "qutlass_tpu_torch.nn, qutlass_tpu_torch.kernels.gemm, "
            "qutlass_tpu_torch.kernels.quantize; "
            "bad = [m for m in sys.modules if m in ('jax', 'qutlass_tpu') or m.startswith(('jax.', 'qutlass_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=PKG.parent, timeout=120)


def test_xdist_worker_takes_its_share_of_the_cores():
    """In a pytest-xdist worker, torch's intra-op threads times the workers
    fit the cores (``torch_helpers``'s budget), or the budget is one."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if not workers:
        pytest.skip("runs in a pytest-xdist worker only")
    threads = torch.get_num_threads()
    assert threads == 1 or threads * workers <= os.cpu_count()
