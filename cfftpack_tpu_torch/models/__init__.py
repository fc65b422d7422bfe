"""Spectral option pricing over the port's fused real filter.

Characteristic functions are host numpy (complex128) and enter the
transform as split (re, im) tensors.
"""
from .chfun import (bs_cf, vg_cf, normal_cf, nig_cf,  # noqa: F401
                    alpha_stable_cf, heston_cf, cf_moment_sigma)
from .pricing import conv_option_price, conv_bsvg_option  # noqa: F401
