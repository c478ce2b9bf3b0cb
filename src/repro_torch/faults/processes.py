"""Failure processes: who breaks, when, and for how long.

A *failure process* answers one question for the cluster loop: for each
device (and, on a fabric-carrying fleet, each undirected ICI link), what is
the sequence of ``(fail_time, repair_time)`` outages on the simulated
clock?  Two implementations:

* :class:`PlannedFailures` — an explicit outage list, for hand-computed
  fault-scenario tests ("device 0 dies at t=3.2 for 1 s");
* :class:`StochasticFailures` — a seeded renewal process per target:
  time-to-failure drawn from an exponential (memoryless) or Weibull
  (heavy-tailed, the MLaaS-trace shape) distribution with the configured
  MTBF, repair times exponential with the configured MTTR.

Determinism contract: every target gets its own ``random.Random`` seeded
from ``(seed, kind, key)`` via the string-seeding path (stable across
platforms and process restarts), so adding devices, reordering the fleet
spec, or changing the *link* MTBF never reshuffles another target's outage
sequence — the same property the workload generators guarantee for the job
population.

Schedules are lazy infinite iterators: the cluster loop pulls the next
outage only after the previous repair, so no horizon needs to be known up
front and a run whose makespan grows (because of the failures themselves)
keeps drawing from the same stream.

:func:`parse_failure_spec` is the CLI grammar::

    mtbf:600                          # devices: exp TTF, mean 600 s
    mtbf:600,mttr:60                  # + exp repair, mean 60 s
    mtbf:1h,mttr:2m,dist:weibull:0.7  # heavy-tailed TTF (shape k=0.7)
    mtbf:600,links:3600,link-mttr:30  # + link outages (undirected)
    mtbf:600,seed:3                   # reseed every stream
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

#: outage target kinds
DEVICE, LINK = "device", "link"


@dataclass(frozen=True)
class Outage:
    """One planned outage of one target."""

    kind: str          # DEVICE | LINK
    key: str           # device id, or canonical undirected link "a-b"
    fail_s: float      # failure instant on the simulated clock
    down_s: float      # repair duration (repair completes at fail_s+down_s)

    def __post_init__(self):
        if self.kind not in (DEVICE, LINK):
            raise ValueError(f"outage kind must be {DEVICE!r} or {LINK!r}, "
                             f"got {self.kind!r}")
        if self.down_s < 0 or self.fail_s < 0:
            raise ValueError(f"outage times must be >= 0: {self}")

    @property
    def repair_s(self) -> float:
        return self.fail_s + self.down_s


def link_key(a: int, b: int) -> str:
    """Canonical undirected link key between topology node ids."""
    return f"{min(a, b)}-{max(a, b)}"


class FailureProcess:
    """Base interface: per-target lazy outage schedules."""

    def device_schedule(self, device_id: str) -> Iterator[Tuple[float, float]]:
        """Yield ``(fail_s, repair_s)`` for one device, strictly increasing."""
        return iter(())

    def link_schedule(self, key: str) -> Iterator[Tuple[float, float]]:
        """Yield ``(fail_s, repair_s)`` for one undirected link key."""
        return iter(())

    @property
    def has_link_failures(self) -> bool:
        return False


@dataclass
class PlannedFailures(FailureProcess):
    """Deterministic outage list — the hand-computable scenario driver."""

    outages: Sequence[Outage] = ()

    def _for(self, kind: str, key: str) -> Iterator[Tuple[float, float]]:
        from repro_torch.obs.metrics import REGISTRY
        drawn = REGISTRY.counter("faults_outages_drawn_total", kind=kind)
        mine = sorted((o for o in self.outages
                       if o.kind == kind and o.key == key),
                      key=lambda o: o.fail_s)
        last = -1.0
        for o in mine:
            if o.fail_s < last:
                raise ValueError(f"overlapping outages for {kind} {key}")
            last = o.repair_s
            drawn.inc()
            yield (o.fail_s, o.repair_s)

    def device_schedule(self, device_id: str) -> Iterator[Tuple[float, float]]:
        return self._for(DEVICE, device_id)

    def link_schedule(self, key: str) -> Iterator[Tuple[float, float]]:
        return self._for(LINK, key)

    @property
    def has_link_failures(self) -> bool:
        return any(o.kind == LINK for o in self.outages)


@dataclass
class StochasticFailures(FailureProcess):
    """Seeded renewal process: MTBF/MTTR distributions per target.

    ``dist`` is ``"exp"`` or ``"weibull"``; Weibull uses ``weibull_k`` as
    the shape (k < 1 is heavy-tailed: many early failures, a long tail of
    survivors) with the scale chosen so the MEAN stays ``mtbf_s`` — so
    sweeping the shape compares tail weight at constant failure budget.
    Repairs are exponential with mean ``mttr_s``.  Link outages (optional,
    ``link_mtbf_s``) get independent streams.
    """

    mtbf_s: float = math.inf
    mttr_s: float = 60.0
    dist: str = "exp"
    weibull_k: float = 0.7
    link_mtbf_s: Optional[float] = None
    link_mttr_s: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if self.mtbf_s <= 0 or self.mttr_s < 0:
            raise ValueError("mtbf_s must be > 0 and mttr_s >= 0, got "
                             f"mtbf={self.mtbf_s} mttr={self.mttr_s}")
        if self.dist not in ("exp", "weibull"):
            raise KeyError(f"unknown TTF distribution {self.dist!r} "
                           "(expected 'exp' or 'weibull')")
        if self.dist == "weibull" and self.weibull_k <= 0:
            raise ValueError(f"weibull shape must be > 0, got {self.weibull_k}")

    def _ttf(self, rng: random.Random, mean: float) -> float:
        if self.dist == "weibull":
            # scale so E[TTF] = mean: E = scale * Gamma(1 + 1/k)
            scale = mean / math.gamma(1.0 + 1.0 / self.weibull_k)
            return rng.weibullvariate(scale, self.weibull_k)
        return rng.expovariate(1.0 / mean)

    def _renewal(self, kind: str, key: str, mtbf: float, mttr: float
                 ) -> Iterator[Tuple[float, float]]:
        if not math.isfinite(mtbf):
            return
        from repro_torch.obs.metrics import REGISTRY
        drawn = REGISTRY.counter("faults_outages_drawn_total", kind=kind)
        rng = random.Random(f"{self.seed}|{kind}|{key}")
        # per-stream constants hoisted out of the draw loop (the weibull
        # scale hides a gamma-function evaluation); the drawn sequence is
        # identical to calling _ttf per renewal
        weibull = self.dist == "weibull"
        if weibull:
            shape = self.weibull_k
            scale = mtbf / math.gamma(1.0 + 1.0 / shape)
        inv_mtbf = 1.0 / mtbf
        inv_mttr = 1.0 / mttr if mttr > 0 else None
        t = 0.0
        while True:
            t += rng.weibullvariate(scale, shape) if weibull \
                else rng.expovariate(inv_mtbf)
            down = rng.expovariate(inv_mttr) if inv_mttr is not None else 0.0
            drawn.inc()
            yield (t, t + down)
            t += down

    def device_schedule(self, device_id: str) -> Iterator[Tuple[float, float]]:
        return self._renewal(DEVICE, device_id, self.mtbf_s, self.mttr_s)

    def link_schedule(self, key: str) -> Iterator[Tuple[float, float]]:
        if self.link_mtbf_s is None:
            return iter(())
        mttr = self.link_mttr_s if self.link_mttr_s is not None else self.mttr_s
        return self._renewal(LINK, key, self.link_mtbf_s, mttr)

    @property
    def has_link_failures(self) -> bool:
        return self.link_mtbf_s is not None

    @classmethod
    def from_fit(cls, ttf_fit, mttr_s: float = 60.0,
                 **kw) -> "StochasticFailures":
        """Build a failure process from a fitted time-to-failure
        distribution (:class:`repro_torch.validate.fitting.FitResult`).

        Exponential fits map directly; everything else maps onto the
        Weibull family at *matched mean and SCV* (the two moments the
        goodput math is sensitive to), via
        :func:`repro_torch.validate.fitting.weibull_shape_for_scv`.  So a
        heavy-tailed lognormal or Pareto fit of real failure gaps still
        yields a runnable MTBF process with the right burstiness.
        """
        if ttf_fit.mean <= 0 or not math.isfinite(ttf_fit.mean):
            raise ValueError(
                f"fitted TTF mean must be positive and finite, got "
                f"{ttf_fit.mean} ({ttf_fit.dist}) — refit or fall back "
                "to an explicit mtbf_s")
        if ttf_fit.dist == "exponential":
            return cls(mtbf_s=ttf_fit.mean, mttr_s=mttr_s, dist="exp", **kw)
        from repro_torch.validate.fitting import weibull_shape_for_scv
        scv = ttf_fit.scv
        if not math.isfinite(scv) or scv <= 0:
            raise ValueError(
                f"fitted TTF SCV must be positive and finite, got {scv} "
                f"({ttf_fit.dist}: infinite-variance tail) — refit or "
                "fall back to an explicit mtbf_s")
        k = ttf_fit.params[0] if ttf_fit.dist == "weibull" \
            else weibull_shape_for_scv(scv)
        return cls(mtbf_s=ttf_fit.mean, mttr_s=mttr_s, dist="weibull",
                   weibull_k=k, **kw)


# ---------------------------------------------------------------------------
# spec grammar
# ---------------------------------------------------------------------------

_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_seconds(text: str) -> float:
    """``"600"`` | ``"600s"`` | ``"10m"`` | ``"1h"`` -> seconds."""
    text = text.strip()
    unit = 1.0
    if text and text[-1].lower() in _UNITS:
        unit = _UNITS[text[-1].lower()]
        text = text[:-1]
    try:
        value = float(text)
    except ValueError:
        raise KeyError(f"bad duration {text!r} (expected e.g. '600', '10m', "
                       "'1h')") from None
    return value * unit


def parse_failure_spec(spec: str) -> StochasticFailures:
    """Parse the CLI's ``--failures`` grammar (see module docstring)."""
    kw: Dict[str, object] = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition(":")
        if not value:
            raise KeyError(f"bad failure spec field {part!r} "
                           "(expected key:value)")
        if key == "mtbf":
            kw["mtbf_s"] = parse_seconds(value)
        elif key == "mttr":
            kw["mttr_s"] = parse_seconds(value)
        elif key == "links":
            kw["link_mtbf_s"] = parse_seconds(value)
        elif key in ("link-mttr", "link_mttr"):
            kw["link_mttr_s"] = parse_seconds(value)
        elif key == "seed":
            kw["seed"] = int(value)
        elif key == "dist":
            dist, _, shape = value.partition(":")
            kw["dist"] = dist
            if shape:
                kw["weibull_k"] = float(shape)
        else:
            raise KeyError(
                f"unknown failure spec field {key!r} (expected mtbf | mttr | "
                "links | link-mttr | dist | seed)")
    if "mtbf_s" not in kw and "link_mtbf_s" not in kw:
        raise KeyError(f"failure spec {spec!r} needs at least mtbf:<dur> "
                       "or links:<dur>")
    return StochasticFailures(**kw)
