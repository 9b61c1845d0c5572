"""Time variants of K7's decode kernel (``dec::gemm_fp4_decode<dec::Nv>``
in ``csrc/gemm_fp4_decode.cuh``, launched by ``csrc/gemm_fp4_nv.cu``) at
the decode shapes of Qwen3-8B (M = 4; (K, N) = (4096, 4096), (4096,
1024), (4096, 12288), (12288, 4096)) over a range of K-slice counts.

Each variant is this checkout's ``gemm_fp4_nv.cu`` built against a copy
of the decode header with the constants ``DEPTH`` (16-groups whose loads
are in flight while one is multiplied) and ``COLS4`` (columns a thread
owns at M <= 4) set to the variant's values, compiled alone into a
library of its own (all variants' ``nvcc`` in parallel) and called
through its C entry point.  Every variant's output at every shape and slice count is first
checked bitwise against the plain version.  Two probes, which compute
something else and are not checked, split the time: ``loads`` keeps the
weight loads and drops the arithmetic on them, ``compute`` keeps the
arithmetic on made-up weight bytes and drops the loads.  Times are CUDA events around 50 calls queued behind a device
sleep (``chip_smoke.timed_ms``), "hot" on one weight and "cold" cycling
through enough copies of it (>= 120 MB) that the 50 MB L2 cannot hold
the weight between calls, as in a decode step, where each linear has
its own weight.

Usage: python3 qutlass_tpu_torch/tools/time_nv_decode.py [DEPTH,COLS4[,PROBE] ...]
(default: 1,4 1,4,loads 1,4,compute)
"""
from __future__ import annotations

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPES_KN = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
M = 4


LOADS = ("      group<F, MB, C>(acc, buf[u], act + (gu - gbeg) * G, kc, sc_s + (gu - gbeg), gpr, "
         "tab);",
         "      acc[0][0] += (double)(buf[u][0] ^ buf[u][1] ^ buf[u][2] ^ buf[u][3] ^ buf[u][4] ^ "
         "buf[u][5] ^ buf[u][6] ^ buf[u][7] ^ buf[u][8]);")
COMPUTE = ("    for (int r = 0; r < R; ++r, row += b_k) f[r] = load_cols<C, VEC>(row, valid);\n"
           "    f[R] = load_cols<C, VEC>(sp + (long long)g * bs_g, valid);",
           "    for (int r = 0; r <= R; ++r) f[r] = (uint32_t)g * 0x9E3779B1u + r * 0x01010101u;")


def build(variants, tmp: Path) -> dict:
    """Compile gemm_fp4_nv.cu against each (depth, cols4, probe) variant of
    the decode header, each in an include directory of its own beside
    copies of the other headers; return the loaded libraries."""
    from qutlass_tpu_torch.kernels import _build
    from qutlass_tpu_torch.tools import _variants as V
    header = (_build.CSRC / "gemm_fp4_decode.cuh").read_text()
    src = (_build.CSRC / "gemm_fp4_nv.cu").read_text()
    sources, keys = {}, {}
    for depth, cols4, probe in variants:
        text = V.set_const(header, "DEPTH", depth, "DEPTH")
        text = V.set_const(text, "COLS4", cols4, "COLS4")
        if probe:
            text = V.replace(text, *(LOADS if probe == "loads" else COMPUTE), f"probe {probe}")
        name = f"nv_{depth}_{cols4}_{probe or 'full'}"
        inc = tmp / f"{name}_include"
        inc.mkdir()
        for other in _build.CSRC.glob("*.cuh"):
            (inc / other.name).write_text(other.read_text())
        (inc / "gemm_fp4_decode.cuh").write_text(text)
        sources[name], keys[name] = (src, inc), (depth, cols4, probe)
    libs = V.build(sources, tmp, "qt_gemm_fp4_nv", "Li4ELb1E13__nv_bfloat16")
    return {keys[name]: lib for name, lib in libs.items()}


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as S
    from qutlass_tpu_torch.kernels import gemm as G

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    variants = [(*(int(v) for v in a.split(",")[:2]), (a.split(",") + [""])[2])
                for a in argv[1:]] or [(1, 4, ""), (1, 4, "loads"), (1, 4, "compute")]
    from qutlass_tpu_torch.tools import _variants as V
    print(V.card())
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    alpha = torch.tensor([0.37], device=dev)
    cnt = torch.zeros(4096, dtype=torch.int32, device=dev)
    floor = S.timed_ms(torch, lambda: torch.cuda._sleep(0), 50)
    print(f"launch floor (torch.cuda._sleep(0)) {floor:.4f} ms")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(variants, Path(tmp))
        for k, n in SHAPES_KN:
            def rnd(*shape):
                return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
            # e4m3 scale bytes with exponent fields 5..11: every sum is exact
            def scales(*shape):
                return rnd(*shape) & 0x87 | (torch.randint(5, 12, shape, generator=gen,
                                                            device=dev, dtype=torch.uint8) << 3)
            at, ast = rnd(k // 2, M), scales(k // 16, M)
            copies = max(1, -(-120 * 2 ** 20 // (n * k * 9 // 16)))
            ws = [(rnd(k // 2, n), scales(k // 16, n)) for _ in range(copies)]
            want = G.gemm_fp4_nv_plain(at, ws[0][0], ast, ws[0][1], alpha, layout="kmajor")
            bound = (n * k * 9 / 16 + M * k * 9 / 16 + 2 * M * n) / S.HBM_BYTES_PER_S * 1e3
            for key, lib in libs.items():
                cols = 32 * key[1]
                tiles = -(-n // cols)
                best = None
                res = []
                for kc in sorted({min(2048, max(128, -(-k // s // 128) * 128))
                                  for s in (1, 2, 3, 4, 5, 6, 8, 11, 16, 24, 32)}):
                    splits = -(-k // kc)
                    part = torch.empty((splits, M, n), dtype=torch.float64, device=dev)

                    def call(w=ws[0], part=part, kc=kc):
                        c = torch.empty((M, n), dtype=torch.bfloat16, device=dev)
                        err = lib.qt_gemm_fp4_nv(
                            at.data_ptr(), 1, M, ast.data_ptr(), 1, M, w[0].data_ptr(), 1, n,
                            w[1].data_ptr(), 1, n, alpha.data_ptr(), c.data_ptr(), 0, M, n, k,
                            part.data_ptr(), cnt.data_ptr(), kc,
                            torch.cuda.current_stream().cuda_stream)
                        assert err == 0, err
                        return c
                    got = call()
                    torch.cuda.synchronize()
                    assert key[2] or torch.equal(got, want), (key, k, n, kc)
                    hot = S.timed_ms(torch, call, 50)
                    it = iter(range(10 ** 9))
                    cold = S.timed_ms(torch, lambda: call(ws[next(it) % copies]), 50)
                    res.append((kc, splits, tiles * splits, round(hot, 5), round(cold, 5)))
                    if best is None or cold < best[4]:
                        best = res[-1]
                rate = (n * k * 9 / 16) / (best[4] * 1e-3) / 1e12
                print(f"K={k} N={n} {key} bound {bound:.5f} ms: best kc={best[0]} "
                      f"splits={best[1]} blocks={best[2]} hot {best[3]} cold {best[4]} ms "
                      f"({rate:.2f} TB/s of weight); all (kc, splits, blocks, hot, cold) {res}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
