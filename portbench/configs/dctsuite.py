"""dctsuite: the real-FFT, DCT and DST suite at 960, 1000 and 1250 in
float32 with FFTPACK scaling, through the port's public API on the last
axis.  A call takes one block of rows at each length through four round
trips and returns, length by length, nine outputs: the packed spectrum's
planes of ``rfft_split`` and ``irfft_split``'s reconstruction, then
``dct`` type 2, ``dst`` type 2 and ``dct`` type 4, each followed by its
inverse's reconstruction (``idct`` type 2 runs the DCT-III, ``idst`` type
2 the DST-III).  Inputs: standard normal rows from the run's seed,
made on the card, one ring of slots for each length."""
from __future__ import annotations

import torch

import cfftpack_tpu_torch as ct


def make_inputs(sizes, traffic, gen, device):
    rows, ring = traffic["rows"], traffic["ring"]
    dtype = getattr(torch, sizes["dtype"])
    return {"x": {n: list(torch.randn((ring, rows, n), generator=gen,
                                      device=device, dtype=dtype).unbind(0))
                  for n in sizes["lengths"]}}


def program(sizes, traffic):
    norm = sizes["norm"]

    def call(inputs, slot):
        outs = []
        for n in sizes["lengths"]:
            x = inputs["x"][n][slot]
            yr, yi = ct.rfft_split(x, norm=norm)
            outs += [yr, yi, ct.irfft_split(yr, yi, n, norm=norm)]
            for fwd, inv, t in ((ct.dct, ct.idct, 2), (ct.dst, ct.idst, 2),
                                (ct.dct, ct.idct, 4)):
                y = fwd(x, type=t, norm=norm)
                outs += [y, inv(y, type=t, norm=norm)]
        return tuple(outs)
    return call
