"""Device time of the float64 ``*_hp`` path and of the Monte-Carlo and
QMC pipelines on one CUDA card, for this checkout or another one.

    python3 scripts/torch_models_profile.py [--root DIR]

Imports ``cfftpack_tpu_torch`` and ``chip_smoke.py`` from DIR (default:
this checkout).  With ``torch.profiler`` (``chip_smoke.profile_route``:
kernel rows only, after 3 warm-up calls) it prints the device time and
kernel rows a call, the CUDA-event time and the idle share of
``fft_hp`` and ``torch.fft.fft`` at (4096, 1024) complex128, the float32
``asian_option_qmc_device`` pipeline at 2^20 samples x 128 steps and its
three stages alone (``halton_batch``, ``normal_icdf``, the orthonormal
DCT-IV), and ``vg_mc_price_device`` at n = 2048 with 2^24 float32
draws, with the card's name and power limit.  Needs the card.
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
        sys.exit("torch_models_profile: no CUDA device")
    import chip_smoke as cs
    import cfftpack_tpu_torch as ct
    from cfftpack_tpu_torch.models import (asian_option_qmc_device,
                                           vg_mc_price_device)
    from cfftpack_tpu_torch.utils import halton_batch, normal_icdf
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card}; tree {root}")
    xc = torch.complex(*cs.pair((4096, 1024), torch.float64, seed=132))
    samples, steps = 1 << 20, 128
    pts = halton_batch(1, samples, steps, torch.float32, device="cuda")
    z = normal_icdf(pts)
    for name, fn, calls in (
            ("fft_hp (4096, 1024) complex128", lambda: ct.fft_hp(xc), 10),
            ("torch.fft.fft (4096, 1024) complex128",
             lambda: torch.fft.fft(xc, norm="forward"), 10),
            (f"asian_option_qmc_device f32 ({samples}, {steps})",
             lambda: asian_option_qmc_device(steps=steps, samples=samples,
                                             device="cuda"), 5),
            (f"halton_batch f32 ({samples}, {steps})",
             lambda: halton_batch(1, samples, steps, torch.float32,
                                  device="cuda"), 5),
            (f"normal_icdf f32 ({samples}, {steps})",
             lambda: normal_icdf(pts), 5),
            (f"dct type 4 ortho f32 ({samples}, {steps})",
             lambda: ct.dct(z, 4, norm="ortho"), 5),
            ("vg_mc_price_device f32 n=2048, 2^24 draws",
             lambda: vg_mc_price_device(n=2048, samples=1 << 24,
                                        device="cuda"), 5)):
        cs.profile_route(name, fn, card, calls=calls)


if __name__ == "__main__":
    main()
