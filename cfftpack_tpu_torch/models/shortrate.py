"""FFT short-rate lattice (Zywina's mesh model): callable bonds.

Counterpart of ``cfftpack_tpu/models/shortrate.py``, the re-design of
test/shortrate.cpp's Mesh without QuantLib: its own time grid and a
linearly interpolated zero curve; the models (Black-Karasinski,
Hull-White, shifted BK, NIG, Pelsser, alpha-stable) come from
``chfun`` and the short-rate maps below.

Per time step the lattice does rfft -> multiply by the characteristic
function -> irfft (shortrate.cpp:174-192 fit and 228-239 stepBack) on
``rfft_split`` / ``irfft_split``: in the standard packed spectrum a
multiply by phi(u) to diffuse state prices forward, by conj(phi) to
roll values back.  The lattice's state stays host numpy float64 (``x``,
``u``, ``gamma``, ``ad``, ``fdf``, ``bond``, the cash flows); the device
(``device``, the card unless the caller names another) holds only what
one step needs, in ``dtype``.  Brent's gamma fit per step is host
control flow over an objective computed on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.rfft import irfft_split, rfft_split
from ..plan import fft_next_fast_even_size
from ..utils.roots import brent
from .chfun import alpha_stable_cf, cf_moment_sigma, nig_cf, normal_cf

__all__ = ["ShortRateMesh", "callable_bond_demo",
           "exponential_levy", "linear_levy", "shifted_exponential_levy",
           "square_levy"]


# short-rate conversion functions (shortrate.cpp:313-327), on tensors
def exponential_levy(x, gamma):
    return torch.exp(x + gamma)


def linear_levy(x, gamma):
    return x + gamma


def shifted_exponential_levy(shift):
    def conv(x, gamma):
        return torch.exp(x + gamma) - shift
    return conv


def square_levy(x, gamma):
    return (x + gamma) ** 2


_CONVS = ("exponential", "linear", "shifted_exponential", "square")


def _convolve(tmp, phr, phi_, n: int):
    """rfft -> multiply by a split-complex factor -> irfft."""
    sr, si = rfft_split(tmp)
    tr = sr * phr - si * phi_
    ti = sr * phi_ + si * phr
    return irfft_split(tr, ti, n)


class ShortRateMesh:
    """The lattice: N-point Levy state space per time step."""

    def __init__(self, n_fft: int, times, phi, mean_reversion: float = 0.0,
                 conv: str = "linear", shift: float = 0.0, device=None,
                 dtype: torch.dtype = torch.float64):
        if conv not in _CONVS:
            raise ValueError(f"conv must be one of {list(_CONVS)}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.N = fft_next_fast_even_size(n_fft)
        self.NC = self.N // 2 + 1
        self.times = np.asarray(times, dtype=np.float64)
        self.nstep = len(self.times)
        self.phi = phi
        self.mean_rev = float(mean_reversion)
        self.conv = conv
        self.shift = float(shift)
        self.levy = (shifted_exponential_levy(self.shift)
                     if conv == "shifted_exponential"
                     else {"exponential": exponential_levy,
                           "linear": linear_levy,
                           "square": square_levy}[conv])
        self.root_guess = 0.0
        self.root_step = 0.5
        self.root_lo = -1e6
        self.root_hi = 1e6

        # grid setup (shortrate.cpp:131-164): mean reversion shrinks the
        # process space with term
        sigma = cf_moment_sigma(phi, float(self.times[-1]))
        L = 2 * 10 * sigma * np.exp(self.mean_rev * self.times[-1])
        dxm = L / self.N
        dum = 2 * np.pi / (dxm * self.N)
        n2 = self.N // 2
        self.dt = np.empty(self.nstep)
        self.dt[:-1] = np.diff(self.times)
        self.dt[-1] = self.dt[-2] if self.nstep > 1 else 1.0
        self.x = np.empty((self.nstep, self.N))
        self.u = np.empty((self.nstep, self.NC))
        for i, term in enumerate(self.times):
            dxi = dxm * np.exp(-self.mean_rev * term)
            dui = dum * np.exp(self.mean_rev * term)
            self.x[i] = (np.arange(self.N) - n2) * dxi
            self.u[i] = np.arange(self.NC) * dui
        # per-step filled by fit():
        self.gamma = np.zeros(self.nstep)
        self.fdf = np.ones((self.nstep, self.N))
        self.ad = np.zeros((self.nstep, self.N))
        self.bond = np.ones(self.nstep)
        self.cash_flow = np.zeros(self.nstep)
        self.accrued = np.zeros(self.nstep)
        self.can_exercise = np.zeros(self.nstep, dtype=bool)

    def _dev(self, a):
        return torch.as_tensor(a, dtype=torch.float64).to(
            device=self.device, dtype=self.dtype)

    def _phi_split(self, i):
        ph = np.asarray(self.phi(self.u[i], self.dt[i]),
                        dtype=np.complex128)
        return self._dev(ph.real), self._dev(ph.imag)

    def fit(self, discounts):
        """Calibrate gamma per step so Arrow-Debreu prices reprice the
        zero curve (shortrate.cpp:167-216)."""
        self.bond = np.asarray(discounts, dtype=np.float64)
        self.ad[0] = 0.0
        self.ad[0, self.N // 2] = 1.0
        for i in range(self.nstep - 1):
            ad = self._dev(self.ad[i])
            x = self._dev(self.x[i])
            dt = float(self.dt[i])
            target = self.bond[i + 1]

            def f(g):
                v = torch.sum(ad * torch.exp(-dt * self.levy(x, g)))
                return float(v) - target

            guess = self.gamma[i - 1] if i > 0 else self.root_guess
            self.gamma[i] = brent(f, guess=guess, step=self.root_step,
                                  lo=self.root_lo, hi=self.root_hi)
            r = self.levy(x, float(self.gamma[i])).cpu().double().numpy()
            self.fdf[i] = np.exp(-dt * r)
            phr, phi_ = self._phi_split(i)
            self.ad[i + 1] = _convolve(
                self._dev(self.ad[i] * self.fdf[i]), phr, phi_,
                self.N).cpu().double().numpy()

    def price_callable_bond(self, exercise_price: float) -> float:
        """Backward induction with early exercise
        (shortrate.cpp:243-263)."""
        value = torch.zeros(self.N, dtype=self.dtype, device=self.device)
        for i in range(self.nstep - 1, 0, -1):
            price = exercise_price + self.accrued[i]
            if self.can_exercise[i]:
                value = torch.clamp(value, max=float(price))
            value = value + float(self.cash_flow[i])
            # roll back: conj(phi) in standard packing + fwd discount
            phr, phi_ = self._phi_split(i - 1)
            value = _convolve(value, phr, -phi_, self.N)
            value = value * self._dev(self.fdf[i - 1])
        return float(value[self.N // 2])


def linear_zero_curve(terms, rates):
    """Linearly-interpolated continuous zero curve -> discount fn."""
    terms = np.asarray(terms, dtype=np.float64)
    rates = np.asarray(rates, dtype=np.float64)

    def discount(t):
        t = np.asarray(t, dtype=np.float64)
        z = np.interp(t, terms, rates)
        return np.exp(-z * t)
    return discount


def callable_bond_demo(model: int = 1, nstep: int = 200, n_fft: int = 1024,
                       notional: float = 10000.0, coupon_pct: float = 3.0,
                       maturity: float = 13.85, pay_freq: int = 2,
                       call_penalty: float = 1.02,
                       mean_reversion: float = 0.01, device=None,
                       dtype: torch.dtype = torch.float64):
    """Self-contained analog of testCallableBond (shortrate.cpp:332-500)
    with simple year-fraction scheduling (no calendar library).

    Returns (straight_bond_pv, pv_check, callable_pv)."""
    if model == 0:    # Black-Karasinski
        phi, conv, shift = normal_cf(0.275), "exponential", 0.0
    elif model == 1:  # Hull-White
        phi, conv, shift = normal_cf(0.01), "linear", 0.0
    elif model == 2:  # shifted Black-Karasinski
        phi, conv, shift = normal_cf(0.10), "shifted_exponential", 0.04
    elif model == 3:  # NIG (Hainaut & MacGilchrist)
        phi, conv, shift = nig_cf(100.14, 5.52, 6.361e-5), "linear", 0.0
    elif model == 4:  # Pelsser squared-Gaussian
        phi, conv, shift = normal_cf(0.02), "square", 0.0
    elif model == 5:  # alpha-stable, shifted exponential
        phi, conv, shift = alpha_stable_cf(1.8, 0.0, 0.08), \
            "shifted_exponential", 0.02
    else:
        raise ValueError("model must be 0..5")

    # coupon schedule in year fractions
    cf_times = np.arange(maturity % (1.0 / pay_freq) or 1.0 / pay_freq,
                         maturity + 1e-9, 1.0 / pay_freq)
    req = np.concatenate([[0.0], cf_times])
    # refine to ~nstep points while keeping required times on-grid
    grid = np.unique(np.concatenate(
        [req, np.linspace(0.0, maturity, nstep)]))

    mesh = ShortRateMesh(n_fft, grid, phi, mean_reversion, conv, shift,
                         device=device, dtype=dtype)
    if model == 4:
        mesh.root_guess, mesh.root_step, mesh.root_lo = 0.1, 0.01, 1e-8

    curve = linear_zero_curve([0, 1, 2, 5, 10, 20, 30],
                              [0.018, 0.02, 0.0225, 0.025, 0.03, 0.032,
                               0.034])
    mesh.fit(curve(mesh.times))

    cpn = coupon_pct / 100.0 / pay_freq * notional
    prev_t = 0.0
    for t_cf in cf_times:
        j = int(np.argmin(np.abs(mesh.times - t_cf)))
        mesh.cash_flow[j] += cpn
        mesh.can_exercise[j] = True
        between = (mesh.times > prev_t + 1e-12) & (mesh.times
                                                   < t_cf - 1e-12)
        mesh.accrued[between] = (mesh.times[between] - prev_t) \
            / (t_cf - prev_t) * cpn
        prev_t = t_cf
    mesh.cash_flow[int(np.argmin(np.abs(mesh.times - cf_times[-1])))] \
        += notional
    mesh.can_exercise[:] = True  # american exercise

    straight_pv = float(np.sum(mesh.bond * mesh.cash_flow))
    pv_check = mesh.price_callable_bond(notional * 1e5)
    callable_pv = mesh.price_callable_bond(notional * call_penalty)
    return straight_pv, pv_check, callable_pv
