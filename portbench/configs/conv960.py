"""conv960: the pricer's step, ``cfftpack_tpu_torch.entry.step``, at
n = 960 in float32 with FFTPACK scaling: ``rfft_split``, the multiply by one characteristic
function, ``irfft_split``.  Inputs as ``entry()`` makes them, at the
traffic's rows and from the run's seed: standard normal payoff rows, a
filter of unit modulus with random phases, real at bin 0 (a
characteristic function is 1 there) and at bin n/2."""
from __future__ import annotations

import torch
from torch.profiler import record_function

from cfftpack_tpu_torch import entry


def make_inputs(sizes, traffic, gen, device):
    n, rows, ring = sizes["n"], traffic["rows"], traffic["ring"]
    dtype = getattr(torch, sizes["dtype"])
    grad = traffic["call"] == "grad"
    v = torch.randn((ring, rows, n), generator=gen, device=device,
                    dtype=dtype)
    theta = torch.randn(n // 2 + 1, generator=gen, device=device,
                        dtype=torch.float64)
    theta[0] = 0.0
    theta[-1] = 0.0
    cot = (torch.randn((rows, n), generator=gen, device=device, dtype=dtype)
           if grad else None)
    return {"v": [b.detach().requires_grad_(grad) for b in v.unbind(0)],
            "phr": theta.cos().to(dtype).requires_grad_(grad),
            "phi": theta.sin().to(dtype).requires_grad_(grad),
            "cot": cot}


def program(sizes, traffic):
    """A call of the traffic's kind on ring slot ``slot``: the step's
    output, and with ``"call": "grad"`` the gradients of the output with
    respect to v, phi_r and phi_i, the cotangent its ``grad_outputs``
    (autograd's first such call imports sympy for its shape check: the
    warm-up pays it)."""
    if traffic["call"] == "forward":
        def call(inputs, slot):
            return (entry.step(inputs["v"][slot], inputs["phr"],
                               inputs["phi"]),)
        return call

    def call(inputs, slot):
        v, phr, phi = inputs["v"][slot], inputs["phr"], inputs["phi"]
        out = entry.step(v, phr, phi)
        with record_function("portbench.backward"):
            g = torch.autograd.grad(out, (v, phr, phi), inputs["cot"])
        return (out.detach(),) + g
    return call
