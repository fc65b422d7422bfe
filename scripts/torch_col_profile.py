"""Device time of the column kernels (K6, K9) and of the 2-D routes that
run them, on one CUDA card, for this checkout or another one.

    python3 scripts/torch_col_profile.py [--root DIR]

Imports ``cfftpack_tpu_torch`` and ``chip_smoke.py`` from DIR (default:
this checkout), so the same measurement runs on an older tree unpacked
with ``git archive`` beside the current one; each tree builds its own
kernels.  With ``torch.profiler`` (``chip_smoke.profile_route``: 10 calls
after 3 warm-up calls, kernel rows only) it prints the device time and
kernel rows a call of ``fft2_split``, ``rfft2_split`` and ``dctn`` type 2
over (-2, -1) at (64, 1024, 1024) float32 ortho, and of K6 (``scolfft``)
and K9 (``scoldct`` types 2 and 3) alone at (64, 1024, 1024), with the
card's name and power limit.  Needs the card.
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
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_col_profile: no CUDA device")
    import chip_smoke as cs
    import cfftpack_tpu_torch as ct
    from cfftpack_tpu_torch.ops import colfft
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card}; tree {root}")
    fr, fi = cs.pair((64, 1024, 1024), torch.float32, seed=70)
    x = cs.real((64, 1024, 1024), torch.float32, seed=47)
    for name, fn in (
            ("fft2_split ortho", lambda: ct.fft2_split(fr, fi, norm="ortho")),
            ("rfft2_split ortho", lambda: ct.rfft2_split(x, norm="ortho")),
            ("dctn type 2 ortho", lambda: ct.dctn(x, 2, axes=(-2, -1),
                                                  norm="ortho")),
            ("K6 scolfft", lambda: colfft.scolfft(fr, fi)),
            ("K9 scoldct dct2", lambda: colfft.scoldct(x, 2)),
            ("K9 scoldct dct3", lambda: colfft.scoldct(x, 3))):
        cs.profile_route(f"{name} (64, 1024, 1024)", fn, card)


if __name__ == "__main__":
    main()
