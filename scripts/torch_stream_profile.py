"""Device time of the stream kernels K2, K3, K4 and K8 and of the routes
that run them, on one CUDA card, for this checkout or another one.

    python3 scripts/torch_stream_profile.py [--root DIR]

Imports ``cfftpack_tpu_torch`` and ``chip_smoke.py`` from DIR (default:
this checkout), so the same measurement runs on an older tree unpacked
with ``git archive`` beside the current one; each tree builds its own
kernels.  With ``torch.profiler`` (``chip_smoke.profile_route``: 10 calls
after 3 warm-up calls, kernel rows only) it prints the device time and
kernel rows a call of K2 forward and inverse and K4 (one filter slice)
at (64, 512, 128) float32, K2 forward and K3 ``fwd_nat`` at (8, 4096,
128) (m = 4096), K5 ``split`` at (8, 2^20), K8 (``dct._dct4_stream``)
at (64, 65536), ``dct`` and ``dst`` type 4 at (64, 65536) under the
ortho and backward norms, and ``rfilter_split`` at (64, 65536), with
the card's name and power limit.  Calls only functions whose signatures the trees share.
Needs the card.
"""
from __future__ import annotations

import argparse
import importlib
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
        sys.exit("torch_stream_profile: no CUDA device")
    import chip_smoke as cs
    import cfftpack_tpu_torch as ct
    from cfftpack_tpu_torch.ops import stream_fft
    dct = importlib.import_module("cfftpack_tpu_torch.ops.dct")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{card}; tree {root}")
    n = 65536
    xr, xi = cs.pair((64, n // 128, 128), torch.float32, seed=80)
    fr, fi = cs.pair((1, n // 128, 128), torch.float32, seed=81)
    x = cs.real((64, n), torch.float32, seed=82)
    gr, gi = cs.pair((n // 2 + 1,), torch.float32, seed=83)
    gi[0] = 0.0
    gi[-1] = 0.0
    big = 524288
    ar, ai = cs.pair((8, big // 128, 128), torch.float32, seed=84)
    cr, ci = cs.pair((8, 1 << 20), torch.float32, seed=85)
    for name, fn in (
            ("K2 fwd (64, 512, 128)",
             lambda: stream_fft._launch(xr, xi, n, "fwd")),
            ("K2 inv (64, 512, 128)",
             lambda: stream_fft._launch(xr, xi, n, "inv")),
            ("K2 fwd (8, 4096, 128)",
             lambda: stream_fft._launch(ar, ai, big, "fwd")),
            ("K3 fwd_nat (8, 4096, 128)",
             lambda: stream_fft._launch(ar, ai, big, "fwd_nat")),
            ("K5 split (8, 2^20)",
             lambda: stream_fft._launch(cr, ci, 1 << 20, "split")),
            ("K4 filter (64, 512, 128) s=1",
             lambda: stream_fft._launch(xr, xi, n, "filter", fr, fi)),
            ("K8 dct4 (64, 65536)", lambda: dct._dct4_stream(x, n)),
            ("dct type 4 ortho (64, 65536)",
             lambda: ct.dct(x, 4, norm="ortho")),
            ("dct type 4 backward (64, 65536)",
             lambda: ct.dct(x, 4, norm="backward")),
            ("dst type 4 ortho (64, 65536)",
             lambda: ct.dst(x, 4, norm="ortho")),
            ("dst type 4 backward (64, 65536)",
             lambda: ct.dst(x, 4, norm="backward")),
            ("rfilter_split (64, 65536)",
             lambda: ct.rfilter_split(x, gr, gi))):
        cs.profile_route(name, fn, card)


if __name__ == "__main__":
    main()
