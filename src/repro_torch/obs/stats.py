"""Shared order-statistics helpers: the ONE quantile implementation.

Before this module the repo grew quantile math wherever a percentile was
needed — ``cluster/events.py`` carried its own linear-interpolation pair
(``percentile`` / ``_percentile_sorted``) and the validate/timelapse
layers were about to add more.  The duplicated versions disagreed on edge
cases: ``q`` outside ``[0, 1]`` indexed past the end of the list (an
``IndexError`` for ``q > 1 + 1/(n-1)``) or silently *extrapolated* below
the minimum for negative ``q`` (``int()`` truncates toward zero, so the
interpolation weight went negative), and a NaN ``q`` or NaN sample
propagated into every downstream summary.

This module is the single source of truth, with the defensible contract:

* ``q`` is **clamped** to ``[0, 1]`` — ``quantile(xs, 1.5)`` is the max,
  ``quantile(xs, -2)`` the min (percentile requests out of range are a
  caller bug, but the least-surprising answer is the nearest order
  statistic, never an extrapolated value outside the sample's range);
* a NaN ``q`` or a NaN sample raises ``ValueError`` instead of silently
  poisoning the result;
* between the order statistics the estimate linearly interpolates
  (numpy's default, what the legacy implementation meant to do).

Dependency-free leaf (stdlib only), importable from every layer without
cycles.
"""
from __future__ import annotations

import math
from typing import Sequence


def quantile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile of an unsorted sample.

    ``q`` is clamped to [0, 1]; NaN ``q`` or NaN samples raise
    ``ValueError``.  An empty sample returns 0.0 (the legacy convention —
    summaries of empty runs stay well-defined).
    """
    return quantile_sorted(sorted(values), q, _validated=False)


def quantile_sorted(xs: Sequence[float], q: float,
                    _validated: bool = False) -> float:
    """:func:`quantile` over an ALREADY-sorted sequence (no re-sort).

    ``_validated=True`` skips the per-sample NaN scan for hot paths that
    already guarantee NaN-free input (note: ``sorted()`` on a list
    containing NaN does NOT raise, it silently misorders — so the scan is
    on by default).
    """
    if math.isnan(q):
        raise ValueError("quantile q must not be NaN")
    if not _validated and any(math.isnan(x) for x in xs):
        raise ValueError("quantile input contains NaN")
    if not xs:
        return 0.0
    if len(xs) == 1:
        return xs[0]
    q = min(max(q, 0.0), 1.0)
    pos = (len(xs) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
