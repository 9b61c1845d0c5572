"""Time K7's prefill kernel (``csrc/gemm_fp4_nv.cu``) against the kernel of
another tree and against variants of its own source, at the prefill
shapes of Qwen3-8B (M = 512; (K, N) = (4096, 4096), (4096, 1024),
(4096, 12288), (12288, 4096)) and at phase 8's (64, 4096, 12288) and
(64, 12288, 4096).

Each tree's ``gemm_fp4_nv.cu`` (this checkout's, ``--parent DIR``'s, and
each variant: this checkout's source with the edits named on the command
line) is compiled alone into a library of its own (``tools/_variants.py``)
and called through its C entry point with no decode workspace (the
prefill kernel, or the tile kernel of a tree that predates it).  Each
library but a probe is first checked bitwise against the plain version at
every timed shape (K-major, bf16; ``tests/test_torch_gpu.py`` holds the
kernel to its plain versions everywhere else).  Times are CUDA events
around 20 calls queued behind a device sleep (``chip_smoke.timed_ms``), in
the order parent, this, this, parent at each shape (variants after),
beside the operations bound (int8 tensor cores) and the fp64 fold's floor
(two DFMA an output and group on the CUDA cores).

Two probes, which compute something else and are neither checked nor
kept, split the time: ``compute`` drops the loads and staging of every
slab after the first (it multiplies the first slab over and over), and
``nofold`` keeps the loads, the staging and the MMAs and drops the fp64
fold (one fp64 add a 16 x 8 tile instead of 8 FMAs).  With ``--sass-dir
DIR`` the SASS of each library's main instantiation is written to
``DIR/NAME.sass``.

Usage: python3 qutlass_tpu_torch/tools/time_nv_prefill.py [--parent DIR] [--sass-dir DIR]
       [VARIANT ...]
(VARIANT: NAME=EDIT[,EDIT...], each EDIT ``CONST:VALUE`` for a ``constexpr
int`` of the ``pre`` namespace, e.g. ``mb4=MIN_BLOCKS:4`` or
``big=SMALL_BELOW:0`` (the 64 x 64 tile at every shape), or
``probe:compute`` / ``probe:nofold``)
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPES = ((512, 4096, 4096), (512, 4096, 1024), (512, 4096, 12288), (512, 12288, 4096),
          (64, 4096, 12288), (64, 12288, 4096))
PROBES = {
    "compute": (("    if (step + 1 < steps) fetch_slab(k0 + BK);  // in flight while this slab "
                 "is multiplied\n", ""),
                ("    if (step + 1 < steps) stage(slab[(step + 1) & 1]);\n", ""),
                ("    const Slab<BN>& sl = slab[step & 1];", "    const Slab<BN>& sl = slab[0];")),
    "nofold": (("            acc[mt][nt][e] = fold(d[e], sa[mt][e >> 1], e & 1 ? sb.y : sb.x, "
                "acc[mt][nt][e]);",
                "            if (e == 0) acc[mt][nt][0] += __int_as_float(d[0] ^ d[1] ^ d[2] ^ d[3]);"),),
}


def call(torch, lib, at, bt, ast, bst, alpha):
    """One K-major bf16 launch of ``lib``'s K7 without a decode workspace."""
    m, n, k = at.shape[1], bt.shape[1], at.shape[0] * 2
    c = torch.empty((m, n), dtype=torch.bfloat16, device=at.device)
    err = lib.qt_gemm_fp4_nv(
        at.data_ptr(), 1, m, ast.data_ptr(), 1, m, bt.data_ptr(), 1, n, bst.data_ptr(), 1, n,
        alpha.data_ptr(), c.data_ptr(), 0, m, n, k, None, None, 0,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return c


def operands(torch, gen, m, n, k, dev):
    """Random K-major operands: every code, e4m3 scale bytes of either sign
    with exponent fields 5..11 (every fp64 sum of group terms exact)."""
    def scales(*shape):
        e = torch.randint(5, 12, shape, generator=gen, device=dev, dtype=torch.uint8)
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8) & 0x87 | e << 3
    codes = [torch.randint(0, 256, (k // 2, r), generator=gen, device=dev, dtype=torch.uint8)
             for r in (m, n)]
    return codes[0], codes[1], scales(k // 16, m), scales(k // 16, n)


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as S
    from qutlass_tpu_torch.kernels import _build
    from qutlass_tpu_torch.kernels import gemm as G
    from qutlass_tpu_torch.tools import _variants as V

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="a tree whose K7 to time beside this one")
    ap.add_argument("--sass-dir", type=Path, help="where to write each library's SASS")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv[1:])
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(V.card())
    dev = torch.device("cuda")
    src = (_build.CSRC / "gemm_fp4_nv.cu").read_text()
    sources = {"this": (src, _build.CSRC)}
    if args.parent:
        pc = args.parent.resolve() / "qutlass_tpu_torch" / "csrc"
        sources["parent"] = ((pc / "gemm_fp4_nv.cu").read_text(), pc)
    probes = set()
    for v in args.variants:
        name, edits = v.split("=", 1)
        text = src
        for e in edits.split(","):
            const, value = e.split(":")
            if const == "probe":
                probes.add(name)
                for old, new in PROBES[value]:
                    text = V.replace(text, old, new, f"probe {value}")
            else:
                text = V.set_const(text, const, value, f"variant {name}")
        sources[name] = (text, _build.CSRC)
    with tempfile.TemporaryDirectory() as tmp:
        # the main instantiation: the 64 x 64 tile (NT = 4), both operands
        # vector-loaded, bf16 out (the tile kernel's bf16 in an older tree)
        libs = V.build(sources, Path(tmp), "qt_gemm_fp4_nv", "prefill",
                       r"\S*(prefillILi4ELb1ELb1E13__nv_bfloat16|nv_kernelI13__nv_bfloat16)",
                       args.sass_dir)
        gen = torch.Generator(device=dev).manual_seed(0)
        alpha = torch.tensor([0.37], device=dev)
        par = ["parent"] if "parent" in libs else []
        order = par + ["this", "this"] + par + [v.split("=")[0] for v in args.variants]
        for m, k, n in SHAPES:
            ops = operands(torch, gen, m, n, k, dev)
            want = G.gemm_fp4_nv_plain(*ops, alpha, layout="kmajor")
            for name, lib in libs.items():
                if name not in probes and not torch.equal(call(torch, lib, *ops, alpha), want):
                    raise SystemExit(f"{name} differs from the plain version at {(m, k, n)}")
            ops_bytes = (m + n) * k * 9 / 16 + 2 * m * n
            bnd = max(2 * m * n * k / S.PEAK_OPS_PER_S["int8"], ops_bytes / S.HBM_BYTES_PER_S) * 1e3
            times = [(name, round(S.timed_ms(torch, lambda: call(torch, libs[name], *ops, alpha),
                                             20), 5)) for name in order]
            print(f"(M, K, N) = {(m, k, n)} kmajor bf16: bound {bnd:.5f} ms, fp64 fold floor "
                  f"{S.fold_floor_ms(m, n, k):.5f} ms; bitwise the plain version; ms {times}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
