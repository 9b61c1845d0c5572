"""Build, check and time K4's warp-specialised MXFP4 prefill kernel
(``csrc/gemm_fp4_prefill_wg.cuh`` behind the C entry point of
``csrc/gemm_fp4_mx_wg.cu``), which is not in the kernel library, against
K4's prefill kernel in the library (what ``kernels.gemm.gemm_fp4_mx``
runs for K-major calls above 16 rows), in turns on one card.

``build`` compiles the entry source, and edited copies of the header, each
into a library of its own (``tools/_variants.py``, which prints ptxas's
registers and spills of each instantiation); ``call`` launches one of them
on K-major operands.  ``chip_smoke.py`` phase 2 and the ``gpu`` tests use
both.

At each shape every library is first held bitwise to K4 and, up to
(512, 4096, 12288), to the plain version, on random K-major operands
(every code; scale bytes 120..135, so every fp64 sum is exact); then K4
and each library are timed in turns (K4, this, this, K4, variants; CUDA
events around 10 calls queued behind a device sleep,
``chip_smoke.timed_ms``) beside the int8 bound and the fp64 fold floor.
Shapes: (512, 4096, 12288), and the ``long-prompt`` cell's prompt lengths
M = 345, 1596, 6523 (and 6524, a multiple of 4) at Qwen3-8B's four (K, N).
``--crossover`` adds M = 17 .. 1024 at Qwen3-8B's four (K, N) and
LFM2-24B-A2B's dense and per-expert (K, N), K4 against this tree's kernel
alone.  ``--watchdog`` makes every barrier wait trap after 2^28 polls, so
that a kernel that never completes a barrier fails its launch instead of
hanging the card.

Usage: python3 qutlass_tpu_torch/tools/time_mx_prefill_wg.py [--crossover] [--watchdog]
       [VARIANT ...]
(VARIANT: NAME=EDIT[,EDIT...], each EDIT ``CONST:VALUE`` for a ``constexpr
int`` of the ``pwg`` namespace, e.g. ``s2=SETS:2`` or ``rd4=RD:4``, or
``bn:64`` (one tile width, 128, 64 or 32, at every shape))
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ENTRY, FN, HEADER = "gemm_fp4_mx_wg.cu", "qt_gemm_fp4_mx_wg", "gemm_fp4_prefill_wg.cuh"
QWEN3_KN = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
SHAPES = ((512, 4096, 12288),) + tuple((m, k, n) for m in (345, 1596, 6523, 6524)
                                      for k, n in QWEN3_KN)
# LFM2-24B-A2B: attention (2048 -> 2048, 512), the dense MLP (2048 <-> 11776),
# an expert (2048 -> 1536, 1536 -> 2048)
CROSSOVER_KN = QWEN3_KN + ((2048, 2048), (2048, 512), (2048, 11776), (11776, 2048),
                           (2048, 1536), (1536, 2048))
CROSSOVER_M = (17, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)
PICK_BN = "  switch (pick_bn(M, N, n_sm)) {"
WAIT = "  } while (!done);\n"


def edited(text: str, edits: str, what: str) -> str:
    """The header with ``edits`` (``CONST:VALUE`` or ``bn:VALUE``, comma
    separated) made."""
    from qutlass_tpu_torch.tools import _variants as V
    for e in edits.split(","):
        const, value = e.split(":")
        if const == "bn":
            text = V.replace(text, PICK_BN, f"  switch ({int(value)}) {{", what)
        else:
            text = V.set_const(text, const, value, what)
    return text


def build(tmp: Path, variants: dict | None = None, watchdog: bool = False) -> dict:
    """{name: library} for this tree's kernel ("this") and each of
    ``variants`` ({name: edits}), compiled into ``tmp``."""
    from qutlass_tpu_torch.kernels import _build
    from qutlass_tpu_torch.tools import _variants as V
    src = (_build.CSRC / ENTRY).read_text()
    header = (_build.CSRC / HEADER).read_text()
    if watchdog:
        header = V.replace(header, "  uint32_t done;\n  do {", "  uint32_t done, polls = 0;\n  do {",
                           "watchdog")
        header = V.replace(header, WAIT, "    if (!done && ++polls > (1u << 28)) __trap();\n" + WAIT,
                           "watchdog")
    texts = {"this": header}
    for name, edits in (variants or {}).items():
        texts[name] = edited(header, edits, f"variant {name}")
    sources = {}
    for name, text in texts.items():
        inc = Path(tmp, f"{name}_include")
        inc.mkdir()
        for other in _build.CSRC.glob("*.cuh"):
            (inc / other.name).write_text(other.read_text())
        (inc / HEADER).write_text(text)
        sources[name] = (src, inc)
    return V.build(sources, Path(tmp), FN, "prefill_wg")


def call(torch, lib, a, b, a_sf, b_sf, alpha, out_dtype=None):
    """One launch of ``lib``'s kernel on K-major operands (a [K/2, M], b
    [K/2, N], scales [K/32, M] / [K/32, N]); ``alpha`` a CUDA tensor (read
    on the card) or a number; the launch's CUDA error code is raised."""
    m, n, k = a.shape[1], b.shape[1], 2 * b.shape[0]
    out_dtype = out_dtype or torch.bfloat16
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    on_card = isinstance(alpha, torch.Tensor)
    err = getattr(lib, FN)(
        a.data_ptr(), a.stride(1), a.stride(0), a_sf.data_ptr(), a_sf.stride(1), a_sf.stride(0),
        b.data_ptr(), b.stride(1), b.stride(0), b_sf.data_ptr(), b_sf.stride(1), b_sf.stride(0),
        alpha.data_ptr() if on_card else None, 0.0 if on_card else float(alpha), c.data_ptr(),
        int(out_dtype == torch.float32), m, n, k, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{FN} failed: CUDA error {err}")
    return c


def operands(torch, gen, m, n, k, dev):
    """Random K-major operands: every code, scale bytes 120..135."""
    return (torch.randint(0, 256, (k // 2, m), generator=gen, device=dev, dtype=torch.uint8),
            torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8),
            torch.randint(120, 136, (k // 32, m), generator=gen, device=dev, dtype=torch.uint8),
            torch.randint(120, 136, (k // 32, n), generator=gen, device=dev, dtype=torch.uint8))


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as S
    from qutlass_tpu_torch.kernels import gemm as G
    from qutlass_tpu_torch.tools import _variants as V

    ap = argparse.ArgumentParser()
    ap.add_argument("--crossover", action="store_true",
                    help="also K4 against this tree's kernel over M = 17 .. 1024")
    ap.add_argument("--watchdog", action="store_true",
                    help="barrier waits trap after 2^28 polls instead of spinning for ever")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv[1:])
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(V.card(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    alpha = torch.tensor([0.37], device=dev)
    variants = dict(v.split("=", 1) for v in args.variants)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), variants, args.watchdog)

        def k4(ops):
            return G.gemm_fp4_mx(*ops, alpha, layout="kmajor")
        for m, k, n in SHAPES:
            ops = operands(torch, gen, m, n, k, dev)
            want = k4(ops)
            if m * n * k <= 512 * 4096 * 12288:
                plain = G.gemm_fp4_mx_plain(*ops, alpha, layout="kmajor")
                if not torch.equal(want, plain):
                    raise SystemExit(f"K4 differs from the plain version at {(m, k, n)}")
            for name, lib in libs.items():
                if not torch.equal(call(torch, lib, *ops, alpha), want):
                    raise SystemExit(f"{name} differs from K4 at {(m, k, n)}")
            runs = [("k4", lambda: k4(ops))] + [
                (name, lambda lib=lib: call(torch, lib, *ops, alpha)) for name, lib in libs.items()]
            order = [runs[0], runs[1], runs[1], runs[0]] + runs[2:]
            times = [(name, round(S.timed_ms(torch, fn), 5)) for name, fn in order]
            bnd = S.gemm_bound(m, n, k, m * k // 2 + m * k // 32, n * k // 2 + n * k // 32,
                               "int8")[0]
            print(f"mx (M, K, N) = {(m, k, n)} kmajor bf16: bound {bnd:.5f} ms, fp64 fold floor "
                  f"{S.fold_floor_ms(m, n, k, 32):.5f} ms; bitwise K4; ms {times}", flush=True)
        if args.crossover:
            for k, n in CROSSOVER_KN:
                row = []
                for m in CROSSOVER_M:
                    ops = operands(torch, gen, m, n, k, dev)
                    if not torch.equal(call(torch, libs["this"], *ops, alpha), k4(ops)):
                        raise SystemExit(f"this differs from K4 at {(m, k, n)}")
                    t = [S.timed_ms(torch, fn) for fn in (
                        lambda: k4(ops), lambda: call(torch, libs["this"], *ops, alpha))]
                    t += [S.timed_ms(torch, fn) for fn in (
                        lambda: call(torch, libs["this"], *ops, alpha), lambda: k4(ops))]
                    row.append((m, round((t[0] + t[3]) / 2, 5), round((t[1] + t[2]) / 2, 5)))
                print(f"crossover (K, N) = {(k, n)}: (M, K4 ms, this ms) {row}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
