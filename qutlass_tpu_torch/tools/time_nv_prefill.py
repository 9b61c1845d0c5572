"""Time the fp4 prefill kernel (``csrc/gemm_fp4_prefill.cuh``) of K7
(``--fmt nv``, the default; ``csrc/gemm_fp4_nv.cu``) or K4 (``--fmt mx``;
``csrc/gemm_fp4_mx.cu``) against the kernel of another tree and against
variants of its own source, at the prefill shapes of Qwen3-8B (M = 512;
(K, N) = (4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096)) and at
phase 8's (64, 4096, 12288) and (64, 12288, 4096), in the K-major layout;
for K4 also in the row-major (tn) and unpacked-codes (kmajor_codes)
layouts at (512, 4096, 12288).

Each tree's entry source (this checkout's, ``--parent DIR``'s, and each
variant: this checkout's with the edits named on the command line made
to a copy of the prefill header) is compiled alone into a library of its
own (``tools/_variants.py``) and called through its C entry point with no
decode workspace (the prefill kernel, or the tile kernel of a tree that
predates it).  Each library but a probe is first checked bitwise against
the plain version at every timed shape and layout (bf16;
``tests/test_torch_gpu.py`` holds the kernels to their plain versions
everywhere else).  Times are CUDA events around 20 calls queued behind a
device sleep (``chip_smoke.timed_ms``), in the order parent, this, this,
parent at each shape (variants after), beside the operations bound (int8
tensor cores) and the fp64 fold's floor (two DFMA an output and group on
the CUDA cores).

Two probes, which compute something else and are neither checked nor
kept, split the time: ``compute`` drops the loads and staging of every
slab after the first (it multiplies the first slab over and over), and
``nofold`` keeps the loads, the staging and the MMAs and drops the fp64
fold (one fp64 add a 16 x 8 tile instead of 8 FMAs).  With ``--sass-dir
DIR`` the SASS of each library's main instantiation (the 64 x 64 tile,
both operands vector-loaded, bf16 out) is written to ``DIR/NAME.sass``.

Usage: python3 qutlass_tpu_torch/tools/time_nv_prefill.py [--fmt mx|nv] [--parent DIR]
       [--sass-dir DIR] [VARIANT ...]
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
LAYOUT_SHAPE = (512, 4096, 12288)   # K4's tn and kmajor_codes layouts are timed here
HEADER = "gemm_fp4_prefill.cuh"
PROBES = {
    "compute": (("    if (step + 1 < steps) fetch_slab(k0 + BK);  // in flight while this slab "
                 "is multiplied\n", ""),
                ("    if (step + 1 < steps) stage(slab[(step + 1) & 1]);\n", ""),
                ("    const Slab<F, BN>& sl = slab[step & 1];",
                 "    const Slab<F, BN>& sl = slab[0];")),
    "nofold": (("            acc[mt][nt][e] = fold(d[e], sa[mt][e >> 1], e & 1 ? sb.y : sb.x, "
                "acc[mt][nt][e]);",
                "            if (e == 0) acc[mt][nt][0] += __int_as_float(d[0] ^ d[1] ^ d[2] ^ d[3]);"),),
}
# per format: entry source, C entry point, group width, and the SASS name of
# the main instantiation (this tree's template, or an older tree's kernel)
FORMATS = {
    "nv": ("gemm_fp4_nv.cu", "qt_gemm_fp4_nv", 16,
           r"\S*(prefillI\S*2NvELi4ELi1ELi1E13__nv_bfloat16|nv_prefillILi4ELb1ELb1E13__nv_bfloat16"
           r"|nv_kernelI13__nv_bfloat16)"),
    "mx": ("gemm_fp4_mx.cu", "qt_gemm_fp4_mx", 32,
           r"\S*(prefillI\S*2MxELi4ELi1ELi1E13__nv_bfloat16|mx_kernelI13__nv_bfloat16)"),
}


def call(torch, fmt, lib, layout, a, b, a_sf, b_sf, alpha, m, n, k):
    """One bf16 launch of ``lib``'s K4 or K7 without a decode workspace:
    ``a`` packed [K/2, M] (kmajor), [M, K/2] (tn) or codes [K, M]
    (kmajor_codes), ``b`` and the scales K-major or (tn) row-major."""
    c = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    st = torch.cuda.current_stream().cuda_stream
    tn = layout == "tn"
    a_s = (a.stride(0), a.stride(1)) if tn else (a.stride(1), a.stride(0))
    b_s = (b.stride(0), b.stride(1)) if tn else (b.stride(1), b.stride(0))
    as_s = (a_sf.stride(0), a_sf.stride(1)) if tn else (a_sf.stride(1), a_sf.stride(0))
    bs_s = (b_sf.stride(0), b_sf.stride(1)) if tn else (b_sf.stride(1), b_sf.stride(0))
    if fmt == "nv":
        err = lib.qt_gemm_fp4_nv(a.data_ptr(), *a_s, a_sf.data_ptr(), *as_s, b.data_ptr(), *b_s,
                                 b_sf.data_ptr(), *bs_s, alpha.data_ptr(), c.data_ptr(), 0, m, n,
                                 k, None, None, 0, st)
    else:
        err = lib.qt_gemm_fp4_mx(a.data_ptr(), *a_s, int(layout != "kmajor_codes"),
                                 a_sf.data_ptr(), *as_s, b.data_ptr(), *b_s, 1, b_sf.data_ptr(),
                                 *bs_s, alpha.data_ptr(), 0.0, c.data_ptr(), 0, m, n, k, None,
                                 None, 0, st)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return c


def operands(torch, gen, fmt, m, n, k, dev):
    """Random K-major operands: every code; NV: e4m3 scale bytes of either
    sign with exponent fields 5..11, MX: e8m0 bytes 120..135 (every fp64
    sum of group terms exact)."""
    group = FORMATS[fmt][2]

    def scales(*shape):
        if fmt == "mx":
            return torch.randint(120, 136, shape, generator=gen, device=dev, dtype=torch.uint8)
        e = torch.randint(5, 12, shape, generator=gen, device=dev, dtype=torch.uint8)
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8) & 0x87 | e << 3
    codes = [torch.randint(0, 256, (k // 2, r), generator=gen, device=dev, dtype=torch.uint8)
             for r in (m, n)]
    return codes[0], codes[1], scales(k // group, m), scales(k // group, n)


def in_layout(E, layout, at, bt, ast, bst):
    """K-major operands -> ``layout``."""
    if layout == "tn":
        return tuple(t.T.contiguous() for t in (at, bt, ast, bst))
    if layout == "kmajor_codes":
        return E.unpack_codes(at.T).T.contiguous().to(at.dtype), bt, ast, bst
    return at, bt, ast, bst


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as S
    from qutlass_tpu_torch.kernels import _build
    from qutlass_tpu_torch.kernels import gemm as G
    from qutlass_tpu_torch.ops import emulation as E
    from qutlass_tpu_torch.tools import _variants as V

    ap = argparse.ArgumentParser()
    ap.add_argument("--fmt", choices=sorted(FORMATS), default="nv")
    ap.add_argument("--parent", type=Path, help="a tree whose kernel to time beside this one")
    ap.add_argument("--sass-dir", type=Path, help="where to write each library's SASS")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv[1:])
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(V.card())
    fmt = args.fmt
    entry, fn, group, sass = FORMATS[fmt]
    plain = G.gemm_fp4_nv_plain if fmt == "nv" else G.gemm_fp4_mx_plain
    dev = torch.device("cuda")
    src = (_build.CSRC / entry).read_text()
    header = (_build.CSRC / HEADER).read_text()
    sources = {"this": (src, _build.CSRC)}
    if args.parent:
        pc = args.parent.resolve() / "qutlass_tpu_torch" / "csrc"
        sources["parent"] = ((pc / entry).read_text(), pc)
    probes = set()
    with tempfile.TemporaryDirectory() as tmp:
        for v in args.variants:
            name, edits = v.split("=", 1)
            text = header
            for e in edits.split(","):
                const, value = e.split(":")
                if const == "probe":
                    probes.add(name)
                    for old, new in PROBES[value]:
                        text = V.replace(text, old, new, f"probe {value}")
                else:
                    text = V.set_const(text, const, value, f"variant {name}")
            inc = Path(tmp, f"{name}_include")
            inc.mkdir()
            for other in _build.CSRC.glob("*.cuh"):
                (inc / other.name).write_text(other.read_text())
            (inc / HEADER).write_text(text)
            sources[name] = (src, inc)
        libs = V.build(sources, Path(tmp), fn, "prefill", sass, args.sass_dir)
        gen = torch.Generator(device=dev).manual_seed(0)
        alpha = torch.tensor([0.37], device=dev)
        par = ["parent"] if "parent" in libs else []
        order = par + ["this", "this"] + par + [v.split("=")[0] for v in args.variants]
        cases = [(shape, "kmajor") for shape in SHAPES]
        if fmt == "mx":
            cases += [(LAYOUT_SHAPE, "tn"), (LAYOUT_SHAPE, "kmajor_codes")]
        for (m, k, n), layout in cases:
            kops = operands(torch, gen, fmt, m, n, k, dev)
            ops = in_layout(E, layout, *kops)
            want = plain(*kops, alpha, layout="kmajor")
            for name, lib in libs.items():
                got = call(torch, fmt, lib, layout, *ops, alpha, m, n, k)
                if name not in probes and not torch.equal(got, want):
                    raise SystemExit(f"{name} differs from the plain version at {(m, k, n)} "
                                     f"{layout}")
            ops_bytes = (m + n) * k * (0.5 + 1 / group) + 2 * m * n
            bnd = max(2 * m * n * k / S.PEAK_OPS_PER_S["int8"], ops_bytes / S.HBM_BYTES_PER_S) * 1e3
            times = [(name, round(S.timed_ms(
                torch, lambda: call(torch, fmt, libs[name], layout, *ops, alpha, m, n, k), 20), 5))
                for name in order]
            print(f"{fmt} (M, K, N) = {(m, k, n)} {layout} bf16: bound {bnd:.5f} ms, fp64 fold "
                  f"floor {S.fold_floor_ms(m, n, k, group):.5f} ms; bitwise the plain version; "
                  f"ms {times}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
