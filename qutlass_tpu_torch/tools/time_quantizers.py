"""Time the fp4 quantizers K1 (``--fmt mx``, ``csrc/quantize_mx.cu``) and
K5 (``--fmt nv``, ``csrc/quantize_nv.cu``) against the kernel of another
tree and against edited copies of their own sources; ``--fmt mx_int8``
runs the same probes on K2 (``csrc/quantize_mx_int8.cu``, two launches a
call), whose pass A asks the same question.

Shapes (rotation 32, the serving path's): rows 4 and 512 at K 4096 and
12288 in the K-major layout (every fp4 linear's activation), K1's
training shapes (4096, 4096) and (4096, 12288) K-major with the clip mask
(the QAT forward), and (512, 4096) row-major.  K1 and K5 are also checked,
untimed, at the rest of ``chip_smoke.py`` phase 2's shapes (the weights
of Qwen3-8B's linears K-major, 64 rows, and the row-major operands of the
reference-parity drives).

Each tree's entry source (this checkout's, ``--parent DIR``'s, and each
variant: this checkout's with the edits named on the command line made to
copies of its files) is compiled alone into a library of its own
(``tools/_variants.py``) and called through the package's wrapper.  Each
library but a probe is first checked bit for bit against
``emulation.fused_quantize_{mx,nv}_ordered_plain`` at every shape (K2:
its scale bytes and row scales against the plain version, and a' within
the `gpu` tests' 1e-4 budget).  Times are CUDA events around 20 calls
queued behind a device sleep (``chip_smoke.timed_ms``), in the order
parent, this, this, parent at each shape (variants after), beside the
byte bound, the fp32-FMA floor of the rotation kept in its exact order
(rot FMAs an element on 128 lanes an SM at the card's top SM clock) and
the time of one launch (``torch.cuda._sleep(0)``).

Probes compute something else, are neither checked nor kept, and split
the time: ``norotate`` (v = x), ``nostats`` (a constant scale byte) and
``nostore`` (no code, scale or mask store to device memory).  A probe
names the lines it replaces and stops if they are gone.

With ``--sass-dir DIR`` the SASS of each library's main instantiation (32
rows, rotation 32) is written to ``DIR/NAME.sass``; its opcode count is
printed in any case.

Usage: python3 qutlass_tpu_torch/tools/time_quantizers.py [--fmt mx|nv|mx_int8]
       [--parent DIR] [--sass-dir DIR] [VARIANT ...]
(VARIANT: NAME=EDIT[,EDIT...], each EDIT ``CONST:VALUE`` for a ``constexpr
int`` declared once in the entry source or one header, or ``probe:NAME``)
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ROT = 32
TIMED = {   # (rows, K, layout, clip mask)
    "mx": ((4, 4096, "kmajor", False), (4, 12288, "kmajor", False),
           (512, 4096, "kmajor", False), (512, 12288, "kmajor", False),
           (4096, 4096, "kmajor", True), (4096, 12288, "kmajor", True),
           (512, 4096, "rowmajor", False)),
    "nv": ((4, 4096, "kmajor", False), (4, 12288, "kmajor", False),
           (512, 4096, "kmajor", False), (512, 12288, "kmajor", False),
           (512, 4096, "rowmajor", False)),
    "mx_int8": ((4, 4096, "kmajor", False), (4, 12288, "kmajor", False),
                (512, 4096, "kmajor", False), (512, 12288, "kmajor", False)),
}
CHECKED = {  # checked bit for bit, not timed: the rest of phase 2's shapes
    "mx": ((4096, 4096, "kmajor", False), (1024, 4096, "kmajor", False),
           (12288, 4096, "kmajor", False), (4096, 12288, "kmajor", False),
           (12288, 4096, "rowmajor", False), (4096, 12288, "rowmajor", False),
           (512, 4096, "kmajor_codes", False), (4096, 4096, "rowmajor", False)),
    "nv": ((4096, 4096, "kmajor", False), (1024, 4096, "kmajor", False),
           (12288, 4096, "kmajor", False), (4096, 12288, "kmajor", False),
           (64, 4096, "kmajor", False), (64, 12288, "kmajor", False),
           (504, 2048, "rowmajor", False), (512, 2048, "rowmajor", False)),
    "mx_int8": (),
}
FORMATS = {  # entry source, C entry point, kernel name in ptxas's output, the SASS
    # name of the main instantiation (32 rows, rotation 32)
    "mx": ("quantize_mx.cu", "qt_quantize_mx", "quantize_",
           r"\S*(quantize_fp4I\S*2MxELi32ELi32E|quantize_mx_kernel)"),
    "nv": ("quantize_nv.cu", "qt_quantize_nv", "quantize_",
           r"\S*(quantize_fp4I\S*2NvELi32ELi32E|quantize_nv_kernel)"),
    "mx_int8": ("quantize_mx_int8.cu", "qt_quantize_mx_int8", "pass_a",
                r"\S*quantize_mx_int8_pass_aILi32ELi32E"),
}
# probe: {fmt: ((file, old, new), ...)}; the files are the entry source or
# a header of csrc
TILE = "quantize_fp4_tile.cuh"   # K1's and K5's kernel
_NOROTATE = (TILE, "  rotate_task<ROT, C>(x_s + r * T::XP + chunk, hp, j, v);",
             "#pragma unroll\n  for (int t = 0; t < C; ++t) v[t] = x_s[r * T::XP + c0 + j + S * t];")
_NOSTORE = (TILE, "  if (rm) {\n    // codes [rows, K/2]",
            "  if (rows < 0) {\n  } else if (rm) {\n    // codes [rows, K/2]")
PROBES = {
    "norotate": {
        "mx": (_NOROTATE,),
        "nv": (_NOROTATE,),
        "mx_int8": (("quantize_mx_int8.cu",
                     "        const float v = hcol.rotate(&x_s[rr][col - hc]);",
                     "        const float v = __bfloat162float(x_s[rr][col]);"),),
    },
    "nostats": {
        "mx": ((TILE, "    byte[0] = (__float_as_int(scale) & 0x7F800000) >> 23;",
                "    byte[0] = 127 + (method > 9);"),),
        "nv": ((TILE, "      const float mul = qt::nv_mul(byte[u], method, gs);",
                "      byte[u] = 0x38 + (method > 9);\n"
                "      const float mul = qt::nv_mul(byte[u], method, gs);"),),
        "mx_int8": (("quantize_mx_int8.cu",
                     "        const int byte = qt::group_scale_byte(v, method);",
                     "        const int byte = 127 + (method > 9);"),),
    },
    "nostore": {
        "mx": (_NOSTORE,),
        "nv": (_NOSTORE,),
        "mx_int8": (("quantize_mx_int8.cu",
                     "  store_a_tile<TR>(a, a_s, r0, nr, rows, k0, kw, tid);",
                     "  if (rows < 0) store_a_tile<TR>(a, a_s, r0, nr, rows, k0, kw, tid);"),
                    ("quantize_mx_int8.cu",
                     "    if (g * 32 < kw && rr < nr) s[",
                     "    if (g * 32 < kw && rr < nr && rows < 0) s[")),
    },
}


def card() -> str:
    """name, power limit, top SM clock (MHz)."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


class _Lib:
    """A variant library standing in for the package's: the entry point
    from the variant, an error string even where its source has none."""

    def __init__(self, lib):
        self._lib = lib
        if hasattr(lib, "qt_error_string"):
            lib.qt_error_string.argtypes = [ctypes.c_int]
            lib.qt_error_string.restype = ctypes.c_char_p

    def __getattr__(self, name):
        if name == "qt_error_string" and not hasattr(self._lib, name):
            return lambda err: f"CUDA error {err}".encode()
        return getattr(self._lib, name)


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as S
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch.kernels import _build
    from qutlass_tpu_torch.kernels import quantize as Q
    from qutlass_tpu_torch.nn import linear as L
    from qutlass_tpu_torch.ops import emulation as E
    from qutlass_tpu_torch.tools import _variants as V

    ap = argparse.ArgumentParser()
    ap.add_argument("--fmt", choices=sorted(FORMATS), default="mx")
    ap.add_argument("--parent", type=Path, help="a tree whose kernel to time beside this one")
    ap.add_argument("--sass-dir", type=Path, help="where to write each library's SASS")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv[1:])
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    info = card()
    print(info)
    sm_mhz = float(info.split(",")[-1].split()[0])
    fmt = args.fmt
    entry, fn, kname, sass = FORMATS[fmt]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    files = {p.name: p.read_text() for p in _build.CSRC.glob("*.cuh")}
    files[entry] = (_build.CSRC / entry).read_text()
    probes = set()
    with tempfile.TemporaryDirectory() as tmp:
        sources = {"this": (files[entry], _build.CSRC)}
        if args.parent:
            pc = args.parent.resolve() / "qutlass_tpu_torch" / "csrc"
            sources["parent"] = ((pc / entry).read_text(), pc)
        for v in args.variants:
            name, edits = v.split("=", 1)
            text = dict(files)
            for e in edits.split(","):
                const, value = e.split(":")
                if const == "probe":
                    probes.add(name)
                    for f, old, new in PROBES[value][fmt]:
                        text[f] = V.replace(text[f], old, new, f"probe {value}")
                else:
                    hits = [f for f, t in text.items() if f"constexpr int {const} =" in t
                            or f", {const} =" in t]
                    if len(hits) != 1:
                        raise SystemExit(f"variant {name}: {const} declared in {hits}")
                    text[hits[0]] = V.set_const(text[hits[0]], const, value, f"variant {name}")
            inc = Path(tmp, f"{name}_include")
            inc.mkdir()
            for f, t in text.items():
                (inc / f).write_text(t)
            sources[name] = (text[entry], inc)
        libs = V.build(sources, Path(tmp), fn, kname, sass, args.sass_dir)
        gen = torch.Generator(device=dev).manual_seed(0)
        h = qt.hadamard_matrix(ROT, device=dev)
        floor = S.timed_ms(torch, lambda: torch.cuda._sleep(0), 50)
        par = ["parent"] if "parent" in libs else []
        order = par + ["this", "this"] + par + [v.split("=")[0] for v in args.variants]

        def run(rows, k, layout, mask, x, gs):
            if fmt == "mx":
                return Q.quantize_mx(x, h, rot_size=ROT, return_mask=mask, layout=layout)
            if fmt == "nv":
                return Q.quantize_nv(x, h, gs, rot_size=ROT, layout=layout)
            return Q.quantize_mx_int8(x, h, rot_size=ROT)

        def check(name, rows, k, layout, mask, x, gs):
            got = run(rows, k, layout, mask, x, gs)
            if fmt == "mx_int8":
                wa, ws, wb = Q.quantize_mx_int8_plain(x, h, rot_size=ROT)
                ok = (torch.equal(got[2], wb) and torch.equal(got[1], ws)
                      and (got[0] != wa).float().mean().item() <= 1e-4)
            elif fmt == "mx":
                want = E.fused_quantize_mx_ordered_plain(x, h, rot_size=ROT, return_mask=mask,
                                                         layout=layout)
                ok = all(torch.equal(a, b) for a, b in zip(got, want))
            else:
                want = E.fused_quantize_nv_ordered_plain(x, h, gs, rot_size=ROT, layout=layout)
                ok = all(torch.equal(a, b) for a, b in zip(got, want))
            if not ok:
                raise SystemExit(f"{name} differs from the ordered plain version at "
                                 f"{(rows, k)} {layout} mask={mask}")

        old = _build._lib
        try:
            for (rows, k, layout, mask), timed in (
                    [(c, True) for c in TIMED[fmt]] + [(c, False) for c in CHECKED[fmt]]):
                x = (torch.randn((rows, k), generator=gen, device=dev)
                     * (25.0 if layout == "rowmajor" and fmt == "nv" else 1.0)).to(torch.bfloat16)
                gs = L.nv_global_scale(L.rotated_amax(x, h)) if fmt == "nv" else None
                for name, lib in libs.items():
                    _build._lib = _Lib(lib)
                    if name not in probes:
                        check(name, rows, k, layout, mask, x, gs)
                if not timed:
                    print(f"{fmt} {(rows, k)} {layout} mask={mask}: every library bitwise "
                          f"the ordered plain version", flush=True)
                    continue
                times = []
                for name in order:
                    _build._lib = _Lib(libs[name])
                    times.append((name, round(S.timed_ms(
                        torch, lambda: run(rows, k, layout, mask, x, gs), 20), 5)))
                group = 16 if fmt == "nv" else 32
                out = 1.0 if fmt == "mx_int8" else 0.5 + (0.125 if mask else 0.0)
                bnd = S.quantize_bound(rows, k, out, group, 4 * rows if fmt == "mx_int8" else 0)
                fma = rows * k * ROT / (sms * 128 * sm_mhz * 1e6) * 1e3
                print(f"{fmt} {(rows, k)} {layout} mask={mask}: bound {bnd[0]:.6f} ms ({bnd[1]}), "
                      f"fp32-FMA floor {fma:.6f} ms ({sms} SMs at {sm_mhz:.0f} MHz), one launch "
                      f"{floor:.4f} ms; checked; ms {times}", flush=True)
        finally:
            _build._lib = old
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
