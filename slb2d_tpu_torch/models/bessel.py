"""Modified Bessel functions of the first kind, integer order.

The reference links GSL for ``gsl_sf_bessel_In`` (reference: GNUmakefile:18,
src/boltzmann_c_solver.c:118).  On the TPU stack we only need these on the
host, in float64, at configuration time — scipy when present, else a pure
power-series evaluation (converges for all x >= 0 we care about; terms are
computed in log space to avoid overflow).
"""

from __future__ import annotations

import math

try:
    from scipy.special import iv as _scipy_iv
except ImportError:  # pragma: no cover - scipy is present in practice
    _scipy_iv = None


def bessel_In(n: int, x: float) -> float:
    """I_n(x) for integer n >= 0, float64 accuracy ~1e-15 rel."""
    if _scipy_iv is not None:
        return float(_scipy_iv(n, x))
    return _series_In(n, x)


def _series_In(n: int, x: float) -> float:
    if x == 0.0:
        return 1.0 if n == 0 else 0.0
    if x < 0:
        raise ValueError("bessel_In fallback requires x >= 0")
    # I_n(x) = sum_k (x/2)^(2k+n) / (k! (n+k)!)
    log_t0 = n * math.log(x / 2.0) - math.lgamma(n + 1)
    t = math.exp(log_t0)
    q = x * x / 4.0
    total = t
    k = 0
    while True:
        k += 1
        t *= q / (k * (n + k))
        total_new = total + t
        if total_new == total:
            return total
        total = total_new
        if k > 100000:  # unreachable in practice
            return total
