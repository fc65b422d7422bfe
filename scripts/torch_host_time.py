"""Host time a call of the public transforms on one CUDA card, with no
input requiring grad, for this checkout or another one.

    python3 scripts/torch_host_time.py [--root DIR] [--reps N]

Imports ``cfftpack_tpu_torch`` and ``chip_smoke.py`` from DIR (default:
this checkout) and prints, for each call, the host time a call
(``chip_smoke.host_us``: the wall time of N calls enqueued back to back
over N, after one call and a synchronize) and the CUDA-event median, with
the card's name and power limit: ``fft_split`` ortho at (4096, 1024),
(64, 65536) and (8, 2^20), ``rfft_split``, ``irfft_split``, ``dct`` type
2 ortho and ``rfilter_split`` at (64, 65536), ``fft2_split`` at (4, 1024,
1024) and the K1 wrapper alone at (4096, 1024).  To compare two trees,
run it for each in one call, in turns (A B B A).  Needs the card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose package and chip_smoke.py to use")
    ap.add_argument("--reps", type=int, default=200,
                    help="calls a host-time measurement")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_host_time: no CUDA device")
    import chip_smoke as cs
    import cfftpack_tpu_torch as ct
    from cfftpack_tpu_torch.ops import fused_fft
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card}; tree {root}")
    f32 = torch.float32
    k1 = cs.pair((4096, 1024), f32, seed=400)
    big = cs.pair((64, 65536), f32, seed=401)
    long_ = cs.pair((8, 1 << 20), f32, seed=402)
    x = cs.real((64, 65536), f32, seed=403)
    sr, si = ct.rfft_split(x)
    fr, fi = ct.rfft_split(cs.real((65536,), f32, seed=404))
    img = cs.pair((4, 1024, 1024), f32, seed=405)
    for name, fn in (
            ("K1 sfft_fused (4096, 1024)",
             lambda: fused_fft.sfft_fused(*k1, 1024, False)),
            ("fft_split ortho (4096, 1024)",
             lambda: ct.fft_split(*k1, norm="ortho")),
            ("fft_split ortho (64, 65536)",
             lambda: ct.fft_split(*big, norm="ortho")),
            ("fft_split ortho (8, 2^20)",
             lambda: ct.fft_split(*long_, norm="ortho")),
            ("rfft_split (64, 65536)", lambda: ct.rfft_split(x)),
            ("irfft_split (64, 65536)",
             lambda: ct.irfft_split(sr, si, 65536)),
            ("dct type 2 ortho (64, 65536)",
             lambda: ct.dct(x, 2, norm="ortho")),
            ("rfilter_split (64, 65536)",
             lambda: ct.rfilter_split(x, fr, fi)),
            ("fft2_split (4, 1024, 1024)", lambda: ct.fft2_split(*img))):
        host = cs.host_us(fn, reps=args.reps)
        event = cs.median_ms(fn)
        print(f"  host time a call, {name}: {host:.1f} us, event median "
              f"{event:.4f} ms  [{card}]")


if __name__ == "__main__":
    main()
