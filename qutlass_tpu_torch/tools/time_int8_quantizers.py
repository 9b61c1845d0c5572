"""Time K2 (``quantize_mx_int8``) and K6 (``quantize_nv_int8``) on the
card at the serving shapes of Qwen3-8B (rows 4 and 512, K 1024, 4096 and
12288, rotation 32), each call first checked against its plain version,
beside the least time of one launch (``torch.cuda._sleep(0)``).

Usage: python3 qutlass_tpu_torch/tools/time_int8_quantizers.py [ROOT [TAG]]

ROOT is a checkout holding ``qutlass_tpu_torch/`` and ``chip_smoke.py``
(default: the one that holds this script), whose package is the one
timed, so that two trees can be timed in turns, one process each, on the
same card.  Run it as a script (not with ``-m``, which would import this
checkout's package first).  Times are CUDA events around 50 calls
queued behind a device sleep (``chip_smoke.timed_ms``), the least of
three repetitions (each is printed)."""
from __future__ import annotations

import sys
import time
from pathlib import Path

SHAPES = ((4, 1024), (4, 4096), (4, 12288), (512, 1024), (512, 4096), (512, 12288))


def main(argv: list[str]) -> int:
    root = Path(argv[1] if len(argv) > 1 else Path(__file__).resolve().parents[2])
    tag = argv[2] if len(argv) > 2 else root.name
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as S
    import qutlass_tpu_torch as qt
    from qutlass_tpu_torch.kernels import _build
    from qutlass_tpu_torch.kernels import quantize as Q

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    t0 = time.perf_counter()
    _build.library()
    print(f"{tag} build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    h = qt.hadamard_matrix(32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    gs = torch.tensor([2688.0 / 5.0], device=dev)
    floor = S.timed_ms(torch, lambda: torch.cuda._sleep(0), 50)
    print(f"{tag} launch floor (torch.cuda._sleep(0)) {floor:.4f} ms")
    for rows, k in SHAPES:
        x = torch.randn((rows, k), generator=gen, device=dev).to(torch.bfloat16)
        ga, gsc, gb = Q.quantize_mx_int8(x, h, rot_size=32)
        wa, wsc, wb = Q.quantize_mx_int8_plain(x, h, rot_size=32)
        ok2 = (torch.equal(gb, wb) and torch.equal(gsc, wsc)
               and (ga != wa).float().mean().item() <= 1e-4)
        na, ns, nb = Q.quantize_nv_int8(x, h, gs, rot_size=32)
        pa, ps, pb = Q.quantize_nv_int8_plain(x, h, gs, rot_size=32)
        same = (nb == pb).all(0)
        ok6 = ((nb != pb).float().mean().item() <= 1e-4 and torch.equal(na[:, same], pa[:, same])
               and torch.equal(ns[same], ps[same]))
        t2 = [S.timed_ms(torch, lambda: Q.quantize_mx_int8(x, h, rot_size=32), 50)
              for _ in range(3)]
        t6 = [S.timed_ms(torch, lambda: Q.quantize_nv_int8(x, h, gs, rot_size=32), 50)
              for _ in range(3)]
        print(f"{tag} rows={rows} K={k} K2 ok={ok2} ms={min(t2):.4f} "
              f"({' '.join(f'{t:.4f}' for t in t2)}) K6 ok={ok6} ms={min(t6):.4f} "
              f"({' '.join(f'{t:.4f}' for t in t6)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
