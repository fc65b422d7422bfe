"""c2c1024: the complex round trip in double precision,
``cfftpack_tpu_torch.fft`` then ``ifft`` on complex128 rows of 1024 with
FFTPACK scaling; a call returns the spectrum and the reconstruction.
Inputs: standard normal real and imaginary parts from the run's seed."""
from __future__ import annotations

import torch

import cfftpack_tpu_torch as ct


def make_inputs(sizes, traffic, gen, device):
    n, rows, ring = sizes["n"], traffic["rows"], traffic["ring"]
    real = torch.randn((ring, rows, n, 2), generator=gen, device=device,
                       dtype=getattr(torch, sizes["dtype"]).to_real())
    return {"x": list(torch.view_as_complex(real).unbind(0))}


def program(sizes, traffic):
    norm = sizes["norm"]

    def call(inputs, slot):
        spec = ct.fft(inputs["x"][slot], norm=norm)
        return spec, ct.ifft(spec, norm=norm)
    return call
