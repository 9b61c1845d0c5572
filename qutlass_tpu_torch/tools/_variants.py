"""Build edited copies of a kernel source, all ``nvcc`` in parallel, and
load each as a library of its own: what the ``time_*`` tools of K7 share.

``edit`` replaces one line of a source (a probe) or sets a ``constexpr
int``; ``build`` compiles each copy with ``-Xptxas -v``, prints the
registers and spills of the entry functions whose name matches, and, where
asked, an opcode count of one function's SASS (written to a directory).
"""
from __future__ import annotations

import collections
import ctypes
import re
import subprocess
from pathlib import Path


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def replace(text: str, old: str, new: str, what: str) -> str:
    """``text`` with its one ``old`` replaced; raises if it is not there once."""
    if text.count(old) != 1:
        raise SystemExit(f"{what}: the source line to replace is gone")
    return text.replace(old, new)


def set_const(text: str, const: str, value, what: str) -> str:
    """``text`` with the ``constexpr int`` ``const`` (alone or in a list of
    declarations) set to ``value``; raises unless it is declared once."""
    text, hits = re.subn(rf"(constexpr int (?:[A-Z_0-9]+ = \w+, )*{const} = )\w+",
                         rf"\g<1>{value}", text)
    if hits != 1:
        raise SystemExit(f"{what}: constant {const} found {hits} times")
    return text


def build(sources: dict, tmp: Path, entry: str, kernel: str, sass: str | None = None,
          sass_dir: Path | None = None) -> dict:
    """Compile each {name: (source text, include dir)} into ``tmp``; return
    {name: library} with ``entry``'s C signature set.  Prints ptxas's
    registers / spills of the kernels whose mangled name contains
    ``kernel``, and the opcode count of the SASS function whose name
    matches the regex ``sass`` (written to ``sass_dir/NAME.sass`` where
    given)."""
    from qutlass_tpu_torch.kernels import _build
    procs = {}
    for name, (text, inc) in sources.items():
        cu, so = tmp / f"{name}.cu", tmp / f"{name}.so"
        cu.write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(inc), "-shared",
               "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{err}")
        for fn in err.split("Compiling entry function")[1:]:
            head = fn.splitlines()[0]
            if kernel in head:
                info = " ".join(ln.strip() for ln in fn.splitlines()[1:]
                                if "registers" in ln or "spill" in ln)
                print(f"{name}: {head.strip()[:90]}: {info}", flush=True)
        if sass:
            dump = subprocess.run([str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass", str(so)],
                                  capture_output=True, text=True).stdout
            for func in dump.split("Function : ")[1:]:
                if re.match(sass, func):
                    ops = collections.Counter(m.group(1).split(".")[0] for m in re.finditer(
                        r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func))
                    print(f"{name}: SASS opcodes of {func.split()[0][:60]}: "
                          f"{dict(ops.most_common(16))}", flush=True)
                    if sass_dir is not None:
                        sass_dir.mkdir(parents=True, exist_ok=True)
                        (sass_dir / f"{name}.sass").write_text(func)
        lib = ctypes.CDLL(str(so))
        getattr(lib, entry).argtypes = {**_build._SIGNATURES,
                                        **_build.ON_DEMAND_SIGNATURES}[entry]
        getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs
