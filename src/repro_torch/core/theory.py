"""Closed-form runtime analysis of synchronous training and DropCompute.

Carried over from ``repro.core.theory`` unchanged (numpy only: the port keeps its own
copy); ``tests/test_torch_core.py`` pins it to exact equality.

Implements the analytical results of section 4 and appendix C.2:

* eq. (3):  pdf of the max of N i.i.d. worker step times,
* eq. (4)/(7):  Bailey et al. approximation of E[max of N normals],
* eq. (5)/(10): expected completed micro-batches E[M~(tau)],
* eq. (6)/(11): expected effective speedup E[S_eff(tau)],
* the asymptotic E[T] = Theta(sqrt(log N)) behaviour,
* the optimal-threshold rule tau* = argmax E[S_eff(tau)].

Everything is pure numpy (host-side analytics).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

_EULER_GAMMA = 0.5772156649015329


def _ndtri(p):
    """Inverse standard-normal CDF (Acklam's rational approximation).

    Max abs error ~1.15e-9, plenty for the runtime analytics here (scipy is
    not available in this environment).
    """
    p = np.asarray(p, dtype=np.float64)
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    plow, phigh = 0.02425, 1 - 0.02425
    out = np.empty_like(p)

    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)

    if np.any(mid):
        q = p[mid] - 0.5
        r = q * q
        num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
        den = (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
        out[mid] = num * q / den
    if np.any(lo):
        q = np.sqrt(-2 * np.log(p[lo]))
        num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
        den = ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
        out[lo] = num / den
    if np.any(hi):
        q = np.sqrt(-2 * np.log(1 - p[hi]))
        num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
        den = ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
        out[hi] = -num / den
    return out


def norm_cdf(x):
    x = np.asarray(x, dtype=np.float64)
    return 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))


def norm_ppf(p):
    return _ndtri(p)


# ---------------------------------------------------------------------------
# eq. (3): distribution of the max
# ---------------------------------------------------------------------------


def max_pdf_iid(x, pdf, cdf, n: int):
    """f_T(x) = N f(x) F(x)^{N-1} for i.i.d. worker step times."""
    return n * pdf(x) * np.power(np.clip(cdf(x), 0.0, 1.0), n - 1)


# ---------------------------------------------------------------------------
# eq. (4)/(7): expected max of N normals (Bailey et al. 2014)
# ---------------------------------------------------------------------------


def expected_max_normal(mu: float, sigma: float, n: int) -> float:
    """E[max of N iid N(mu, sigma^2)] via the Bailey approximation (eq. 4)."""
    if n <= 1:
        return mu
    g = _EULER_GAMMA
    q1 = float(norm_ppf(1.0 - 1.0 / n))
    q2 = float(norm_ppf(1.0 - 1.0 / (math.e * n)))
    return sigma * ((1.0 - g) * q1 + g * q2) + mu


def expected_step_time(
    mu: float, sigma: float, m: int, n: int, tc: float = 0.0
) -> float:
    """eq. (7): E[T] for N workers each running M accumulations ~ N(mu, s^2).

    Under CLT, T_n ~ N(M mu, M sigma^2); add the serial latency tc.
    """
    return expected_max_normal(m * mu, math.sqrt(m) * sigma, n) + tc


def asymptotic_max_coefficient(n: int) -> float:
    """The Theta(sqrt(log N)) asymptote: Phi^-1(1-y) ~ sqrt(-2 log y)."""
    return math.sqrt(2.0 * math.log(max(n, 2)))


# ---------------------------------------------------------------------------
# eq. (5)/(10): expected completed micro-batches
# ---------------------------------------------------------------------------


def expected_completed_microbatches(
    tau: float, mu: float, sigma: float, m: int
) -> float:
    """E[M~(tau)] = sum_m Phi((tau - m mu) / sqrt(m sigma^2))  (eq. 5)."""
    ms = np.arange(1, m + 1, dtype=np.float64)
    z = (tau - ms * mu) / np.sqrt(ms * sigma**2 + 1e-30)
    return float(np.sum(norm_cdf(z)))


# ---------------------------------------------------------------------------
# eq. (6)/(11): effective speedup
# ---------------------------------------------------------------------------


def effective_speedup(
    tau: float,
    mu: float,
    sigma: float,
    m: int,
    n: int,
    tc: float = 0.0,
    e_t: Optional[float] = None,
) -> float:
    """Analytic E[S_eff(tau)] per eq. (11).

    ``e_t`` lets callers plug the *empirical* E[T] (compute part only, without
    tc) when the Gaussian approximation of the max is poor (fig. 3b).
    """
    if e_t is None:
        e_t = expected_max_normal(m * mu, math.sqrt(m) * sigma, n)
    m_tilde = expected_completed_microbatches(tau, mu, sigma, m)
    return (m_tilde / m) * (e_t + tc) / (min(tau, e_t) + tc)


def optimal_tau(
    mu: float,
    sigma: float,
    m: int,
    n: int,
    tc: float = 0.0,
    e_t: Optional[float] = None,
    grid: Optional[np.ndarray] = None,
):
    """tau* = argmax_tau E[S_eff(tau)] over a grid (section 4.4 / C.2).

    Returns (tau*, S_eff(tau*)).
    """
    if grid is None:
        lo = max(0.55 * m * mu, mu)  # assumption C.3: tau > M mu / 2
        hi = m * (mu + 4.0 * sigma)
        grid = np.linspace(lo, hi, 512)
    vals = np.array([effective_speedup(t, mu, sigma, m, n, tc, e_t) for t in grid])
    i = int(np.argmax(vals))
    return float(grid[i]), float(vals[i])


def speedup_vs_workers(
    mu: float, sigma: float, m: int, ns, tc: float = 0.0
) -> dict:
    """E[S_eff(tau*)] as a function of N — shows S_eff -> inf as N grows."""
    out = {}
    for n in ns:
        tau, s = optimal_tau(mu, sigma, m, n, tc)
        out[int(n)] = {"tau": tau, "speedup": s}
    return out
