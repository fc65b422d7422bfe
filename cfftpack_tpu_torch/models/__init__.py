"""Spectral quant-finance applications (PyTorch port).

The reference's real workload above the transforms (test/vargamma.c,
blackscholes.cpp, vg_mc.cpp, montecarlo.c, shortrate.cpp), batched:
strikes, samples and paths are tensor axes.  Characteristic functions
are host numpy (complex128) and enter the transforms as split (re, im)
tensors.
"""
from .chfun import (bs_cf, vg_cf, normal_cf, nig_cf,  # noqa: F401
                    alpha_stable_cf, heston_cf, cf_moment_sigma)
from .pricing import conv_option_price, conv_bsvg_option  # noqa: F401
from .montecarlo import (vg_mc_price, vg_mc_price_device,  # noqa: F401
                         asian_option_qmc, asian_option_qmc_device,
                         brownian_paths_qmc)
from .shortrate import ShortRateMesh, callable_bond_demo  # noqa: F401
