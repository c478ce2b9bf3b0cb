"""Distribution fitting with goodness-of-fit diagnostics, pure stdlib.

The validation loop (ingest -> fit -> generate -> cross-check) needs one
question answered honestly: *which* textbook distribution does an observed
arrival/service sample actually follow, and how well?  This module fits
the four candidates the MLaaS-trace literature reaches for —

* ``exponential`` — memoryless arrivals (the Poisson-process null),
* ``lognormal``  — multiplicative service-time spread,
* ``weibull``    — heavy-tailed time-to-failure / short-job mass
  (shape ``k < 1``), the shape :class:`repro_torch.faults.StochasticFailures`
  draws from,
* ``pareto``     — power-law tails (the "few huge jobs" extreme),

each by maximum likelihood, and scores every fit with two classical
diagnostics: the one-sample Kolmogorov–Smirnov statistic (with the
asymptotic p-value series) and a chi-square test over equal-count bins
(Wilson–Hilferty p-value approximation).  No scipy — every estimator and
p-value is closed-form or a few Newton iterations, so the validate layer
stays importable in the dependency-free test environment.

A :class:`FitResult` is a *usable* object, not just a report row: it
carries the analytic ``mean``/``scv`` (the inputs Allen–Cunneen M/G/k
needs), a ``cdf`` for plotting/diagnostics, and a seeded ``sample`` hook
the ``synthetic:alibaba-like`` generator replays — so the trace that is
fit is also the trace that can be re-generated.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: candidate distribution names, in fit order
CANDIDATES = ("exponential", "lognormal", "weibull", "pareto")

#: free parameters per candidate (chi-square degrees-of-freedom debit)
_N_PARAMS = {"exponential": 1, "lognormal": 2, "weibull": 2, "pareto": 2}


def _phi(x: float) -> float:
    """Standard normal CDF via ``erf`` (no scipy)."""
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def kolmogorov_pvalue(d: float, n: int) -> float:
    """Asymptotic one-sample KS p-value (Stephens' small-sample scaling).

    ``lambda = (sqrt(n) + 0.12 + 0.11/sqrt(n)) * D``; the alternating
    series converges in a handful of terms for any lambda of interest.
    """
    if n <= 0 or d <= 0:
        return 1.0
    lam = (math.sqrt(n) + 0.12 + 0.11 / math.sqrt(n)) * d
    total = 0.0
    for j in range(1, 101):
        term = 2.0 * (-1.0) ** (j - 1) * math.exp(-2.0 * j * j * lam * lam)
        total += term
        if abs(term) < 1e-12:
            break
    return min(max(total, 0.0), 1.0)


def chi2_pvalue(stat: float, dof: int) -> float:
    """Upper-tail chi-square probability via the Wilson–Hilferty cube-root
    normal approximation — accurate to a few 1e-3 for ``dof >= 3``, which
    is all a pass/fail GOF verdict needs."""
    if dof <= 0:
        return 1.0
    if stat <= 0:
        return 1.0
    z = (((stat / dof) ** (1.0 / 3.0)) - (1.0 - 2.0 / (9.0 * dof))) \
        / math.sqrt(2.0 / (9.0 * dof))
    return min(max(1.0 - _phi(z), 0.0), 1.0)


@dataclass(frozen=True)
class FitResult:
    """One candidate distribution fit to one sample."""

    dist: str                      # one of CANDIDATES
    params: Tuple[float, ...]      # distribution-native parameters
    mean: float                    # analytic mean of the FITTED dist
    variance: float                # analytic variance (inf for fat Pareto)
    n: int                         # sample size
    ks_stat: float                 # one-sample KS D
    ks_pvalue: float
    chi2_stat: float
    chi2_pvalue: float
    chi2_dof: int

    @property
    def scv(self) -> float:
        """Squared coefficient of variation — the Cs^2 Allen–Cunneen
        uses; inf-variance fits report inf."""
        if self.mean <= 0:
            return 0.0
        if not math.isfinite(self.variance):
            return math.inf
        return self.variance / (self.mean * self.mean)

    def cdf(self, x: float) -> float:
        return _CDFS[self.dist](self.params, x)

    def sample(self, rng: random.Random) -> float:
        return _SAMPLERS[self.dist](self.params, rng)

    def describe(self) -> str:
        names = {"exponential": ("rate",),
                 "lognormal": ("mu", "sigma"),
                 "weibull": ("shape", "scale"),
                 "pareto": ("alpha", "xm")}[self.dist]
        ps = ", ".join(f"{k}={v:.4g}" for k, v in zip(names, self.params))
        return (f"{self.dist:<11s} ({ps}) mean={self.mean:.4g} "
                f"scv={self.scv:.3g} KS D={self.ks_stat:.4f} "
                f"p={self.ks_pvalue:.3f} chi2 p={self.chi2_pvalue:.3f}")


# ---------------------------------------------------------------------------
# per-candidate CDFs / samplers / MLE estimators
# ---------------------------------------------------------------------------

def _cdf_exponential(p: Tuple[float, ...], x: float) -> float:
    (rate,) = p
    return 1.0 - math.exp(-rate * x) if x > 0 else 0.0


def _cdf_lognormal(p: Tuple[float, ...], x: float) -> float:
    mu, sigma = p
    if x <= 0:
        return 0.0
    if sigma <= 0:
        return 1.0 if math.log(x) >= mu else 0.0
    return _phi((math.log(x) - mu) / sigma)


def _cdf_weibull(p: Tuple[float, ...], x: float) -> float:
    shape, scale = p
    return 1.0 - math.exp(-((x / scale) ** shape)) if x > 0 else 0.0


def _cdf_pareto(p: Tuple[float, ...], x: float) -> float:
    alpha, xm = p
    if x <= xm:
        return 0.0
    return 1.0 - (xm / x) ** alpha


_CDFS: Dict[str, Callable] = {
    "exponential": _cdf_exponential, "lognormal": _cdf_lognormal,
    "weibull": _cdf_weibull, "pareto": _cdf_pareto}

_SAMPLERS: Dict[str, Callable] = {
    "exponential": lambda p, rng: rng.expovariate(p[0]),
    "lognormal": lambda p, rng: rng.lognormvariate(p[0], max(p[1], 1e-12)),
    "weibull": lambda p, rng: rng.weibullvariate(p[1], p[0]),
    "pareto": lambda p, rng: p[1] * rng.paretovariate(p[0]),
}


def _fit_exponential(xs: Sequence[float]) -> Tuple[Tuple[float, ...],
                                                   float, float]:
    mean = sum(xs) / len(xs)
    rate = 1.0 / mean
    return (rate,), mean, mean * mean


def _fit_lognormal(xs: Sequence[float]) -> Tuple[Tuple[float, ...],
                                                 float, float]:
    logs = [math.log(x) for x in xs]
    mu = sum(logs) / len(logs)
    var = sum((l - mu) ** 2 for l in logs) / len(logs)
    sigma = math.sqrt(var)
    mean = math.exp(mu + var / 2.0)
    variance = (math.exp(var) - 1.0) * math.exp(2.0 * mu + var)
    return (mu, sigma), mean, variance


def _fit_weibull(xs: Sequence[float], iters: int = 50,
                 tol: float = 1e-9) -> Tuple[Tuple[float, ...],
                                             float, float]:
    """MLE shape via the standard fixed-point/Newton iteration on

        g(k) = sum(x^k ln x)/sum(x^k) - 1/k - mean(ln x) = 0

    (monotone in k), scale from the profile MLE ``(mean(x^k))^(1/k)``.
    """
    logs = [math.log(x) for x in xs]
    mean_log = sum(logs) / len(logs)
    k = 1.0
    for _ in range(iters):
        num = den = dnum = 0.0
        for x, lx in zip(xs, logs):
            xk = x ** k
            num += xk * lx
            den += xk
            dnum += xk * lx * lx
        g = num / den - 1.0 / k - mean_log
        # g'(k) = d/dk [num/den] + 1/k^2
        gp = (dnum / den - (num / den) ** 2) + 1.0 / (k * k)
        step = g / gp if gp > 0 else g
        k_new = k - step
        if k_new <= 0:
            k_new = k / 2.0
        if abs(k_new - k) < tol:
            k = k_new
            break
        k = k_new
    scale = (sum(x ** k for x in xs) / len(xs)) ** (1.0 / k)
    g1 = math.gamma(1.0 + 1.0 / k)
    g2 = math.gamma(1.0 + 2.0 / k)
    mean = scale * g1
    variance = scale * scale * (g2 - g1 * g1)
    return (k, scale), mean, variance


def _fit_pareto(xs: Sequence[float]) -> Tuple[Tuple[float, ...],
                                              float, float]:
    xm = min(xs)
    s = sum(math.log(x / xm) for x in xs)
    n = len(xs)
    alpha = n / s if s > 0 else math.inf
    if not math.isfinite(alpha):
        # degenerate all-equal sample: arbitrarily steep tail
        alpha = 1e6
    mean = alpha * xm / (alpha - 1.0) if alpha > 1 else math.inf
    if alpha > 2:
        variance = (xm * xm * alpha) / ((alpha - 1.0) ** 2 * (alpha - 2.0))
    else:
        variance = math.inf
    return (alpha, xm), mean, variance


_FITTERS = {"exponential": _fit_exponential, "lognormal": _fit_lognormal,
            "weibull": _fit_weibull, "pareto": _fit_pareto}


# ---------------------------------------------------------------------------
# goodness of fit
# ---------------------------------------------------------------------------

def ks_statistic(sorted_xs: Sequence[float],
                 cdf: Callable[[float], float]) -> float:
    """One-sample KS D over an already-sorted sample."""
    n = len(sorted_xs)
    d = 0.0
    for i, x in enumerate(sorted_xs):
        f = cdf(x)
        d = max(d, (i + 1) / n - f, f - i / n)
    return d


def chi_square(sorted_xs: Sequence[float], cdf: Callable[[float], float],
               n_params: int, max_bins: int = 16,
               min_expected: float = 5.0) -> Tuple[float, float, int]:
    """Chi-square GOF over equal-count bins (edges at sample quantiles).

    Expected counts come from the fitted CDF mass between the edges, so
    only the *forward* CDF is needed.  Adjacent bins are merged until
    every bin carries at least ``min_expected`` expected counts (the
    classical Cochran rule) — on heavily tied / discrete-ish samples the
    equal-count edges collapse, and an unmerged near-zero-mass bin with a
    nonzero observed count would blow the statistic up to infinity;
    dof = merged_bins - 1 - n_params.  Returns ``(stat, pvalue, dof)``.
    """
    n = len(sorted_xs)
    bins = max(min(max_bins, n // 5), n_params + 2)
    if bins - 1 - n_params <= 0 or n < bins:
        return 0.0, 1.0, 0
    # equal-count edges: the b-th edge is the (b*n/bins)-th order statistic
    edges = [sorted_xs[min(int(round(b * n / bins)), n - 1)]
             for b in range(1, bins)]
    observed = [0] * bins
    b = 0
    for x in sorted_xs:
        while b < bins - 1 and x > edges[b]:
            b += 1
        observed[b] += 1
    expected = []
    prev_f = 0.0
    for i in range(bins):
        hi_f = cdf(edges[i]) if i < bins - 1 else 1.0
        expected.append(n * max(hi_f - prev_f, 0.0))
        prev_f = hi_f
    # left-to-right merge: accumulate until the expected count clears the
    # floor; a trailing remainder folds into the last emitted bin
    merged: List[Tuple[float, float]] = []
    acc_o = acc_e = 0.0
    for o, e in zip(observed, expected):
        acc_o += o
        acc_e += e
        if acc_e >= min_expected:
            merged.append((acc_o, acc_e))
            acc_o = acc_e = 0.0
    if acc_o or acc_e:
        if merged:
            last_o, last_e = merged[-1]
            merged[-1] = (last_o + acc_o, last_e + acc_e)
        else:
            merged.append((acc_o, acc_e))
    dof = len(merged) - 1 - n_params
    if dof <= 0:
        return 0.0, 1.0, 0
    stat = sum((o - e) ** 2 / e for o, e in merged)
    return stat, chi2_pvalue(stat, dof), dof


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def fit(xs: Sequence[float], dist: str) -> FitResult:
    """Fit ONE candidate by MLE and score it (KS + chi-square)."""
    if dist not in _FITTERS:
        raise KeyError(f"unknown distribution {dist!r}; "
                       f"known: {sorted(_FITTERS)}")
    clean = [float(x) for x in xs if x > 0 and math.isfinite(x)]
    if len(clean) < 3:
        raise ValueError(f"need >= 3 positive finite samples to fit "
                         f"{dist}, got {len(clean)}")
    params, mean, variance = _FITTERS[dist](clean)
    srt = sorted(clean)
    this_cdf = lambda x: _CDFS[dist](params, x)  # noqa: E731
    d = ks_statistic(srt, this_cdf)
    c2, c2p, dof = chi_square(srt, this_cdf, _N_PARAMS[dist])
    return FitResult(dist, tuple(params), mean, variance, len(clean),
                     d, kolmogorov_pvalue(d, len(clean)), c2, c2p, dof)


def fit_all(xs: Sequence[float]) -> Dict[str, FitResult]:
    """Fit every candidate; candidates a degenerate sample breaks are
    skipped (e.g. Pareto on a sample with zeros already filtered)."""
    out: Dict[str, FitResult] = {}
    for dist in CANDIDATES:
        try:
            out[dist] = fit(xs, dist)
        except (ValueError, OverflowError, ZeroDivisionError):
            continue
    return out


def best_fit(xs: Sequence[float]) -> FitResult:
    """The candidate with the smallest KS distance (ties: more-likely
    p-value, then the simpler exponential first via CANDIDATES order)."""
    fits = fit_all(xs)
    if not fits:
        raise ValueError("no candidate distribution could be fit")
    return min(fits.values(),
               key=lambda f: (f.ks_stat, -f.ks_pvalue,
                              CANDIDATES.index(f.dist)))


def fit_report(xs: Sequence[float], label: str = "sample") -> str:
    """Human-readable table of every candidate fit, best first."""
    fits = sorted(fit_all(xs).values(), key=lambda f: f.ks_stat)
    lines = [f"{label}: n={fits[0].n if fits else 0}, "
             f"empirical mean={sum(xs) / max(len(xs), 1):.4g}"]
    for i, f in enumerate(fits):
        marker = "*" if i == 0 else " "
        lines.append(f"  {marker} {f.describe()}")
    return "\n".join(lines)


def weibull_shape_for_scv(scv: float, lo: float = 0.05, hi: float = 20.0,
                          iters: int = 80) -> float:
    """Invert the Weibull SCV(k) = Gamma(1+2/k)/Gamma(1+1/k)^2 - 1 curve.

    SCV is strictly decreasing in the shape k (k=1 is exponential,
    SCV=1), so a bisection finds the shape whose coefficient of
    variation matches an observed sample — the bridge that maps a
    lognormal/Pareto fit onto :class:`repro_torch.faults.StochasticFailures`'
    exp/weibull parameter space at matched first two moments.
    """
    if not math.isfinite(scv) or scv <= 0:
        return 1.0

    def f(k: float) -> float:
        g1 = math.gamma(1.0 + 1.0 / k)
        return math.gamma(1.0 + 2.0 / k) / (g1 * g1) - 1.0 - scv

    if f(lo) < 0:      # scv above the lo-shape curve: maximally heavy
        return lo
    if f(hi) > 0:      # scv below the hi-shape curve: nearly deterministic
        return hi
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if f(mid) > 0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
