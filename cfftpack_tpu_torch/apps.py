"""Convenience alias: the quant-finance applications live in
cfftpack_tpu_torch.models; this module re-exports them under the name
the reference's test/ directory suggests ("apps")."""
from .models import (bs_cf, vg_cf, normal_cf, nig_cf,  # noqa: F401
                     alpha_stable_cf, cf_moment_sigma,
                     conv_option_price, conv_bsvg_option,
                     vg_mc_price, asian_option_qmc, brownian_paths_qmc,
                     ShortRateMesh, callable_bond_demo)
from .utils import (normal_cdf, normal_icdf, halton, primes,  # noqa: F401
                    black_scholes_option, brent)
