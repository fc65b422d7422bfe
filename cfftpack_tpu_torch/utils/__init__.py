"""Numerics utilities for the finance apps (reference: test/util.{h,c}:
the Acklam inverse normal CDF, the Halton sequence, the Black-Scholes
closed form; Brent's root finder for the short-rate fit).

The JAX package's four small utils (``enable_compilation_cache``,
``warm_plans``, ``enable_nan_checks``, ``check_finite``, ``trace``,
``Timer``, ``precompile``) are not ported yet (ROADMAP.md queue 1,
item 14).
"""
from .qmc import (normal_cdf, normal_icdf, halton, halton_batch,  # noqa: F401
                  primes, black_scholes_option)
from .roots import brent  # noqa: F401
