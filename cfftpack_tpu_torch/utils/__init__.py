"""Numerics utilities for the finance apps (reference: test/util.{h,c}:
the Acklam inverse normal CDF, the Halton sequence, the Black-Scholes
closed form; Brent's root finder for the short-rate fit), and the JAX
package's four small utils under their names: the plan and build caches
(``warm_plans``, ``enable_compilation_cache``), a warm-up call
(``precompile``), a ``torch.profiler`` trace and a CUDA-event ``Timer``,
and NaN checks at the API layer's exit (``enable_nan_checks``,
``check_finite``).
"""
from .qmc import (normal_cdf, normal_icdf, halton, halton_batch,  # noqa: F401
                  primes, black_scholes_option)
from .roots import brent  # noqa: F401
from .cache import enable_compilation_cache, warm_plans  # noqa: F401
from .debug import enable_nan_checks, check_finite  # noqa: F401
from .profiling import trace, Timer  # noqa: F401
from .aot import precompile  # noqa: F401
