"""Shared pathology thresholds for heat strips, link tables and the doctor.

Before this module, the camping cutoff lived twice: ``obs/timelapse.py``
marked intervals with ``!`` above a hard-coded 1.5 channel-imbalance, and
``analysis/links.py`` flagged camped fabrics above its own hard-coded 1.5
link-imbalance.  The doctor (``repro_torch.obs.doctor``) adds a third consumer,
so the cutoffs are hoisted here: one frozen :class:`Thresholds` config that
every verdict reads, guaranteeing the doctor can never disagree with the
heat strips about what counts as camped.

The module is a dependency-free leaf (stdlib only), so both ``obs`` and
``analysis`` can import it without cycles.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Thresholds:
    """Detection cutoffs shared by the renderers and the doctor detectors.

    The two imbalance indices are busiest/mean ratios (1.0 = perfectly
    balanced); the ``*_fraction`` fields are shares of the run's total
    makespan below which a pathology is not worth reporting.
    """

    #: per-interval HBM channel-imbalance above this marks the bucket as
    #: camped (an even interleave reads ~1.0; CAMPING_FRACTION=0.25
    #: subsets read >2) — the timelapse "!" marker and the camping detector
    channel_camping_imbalance: float = 1.5
    #: whole-run fabric link-imbalance above this marks the fabric camped
    #: (the links.py table verdict and the link-imbalance detector)
    link_camping_imbalance: float = 1.5
    #: exposed (non-overlapped) collective seconds / total above this
    #: trips the exposed-communication detector
    exposed_comm_fraction: float = 0.02
    #: VMEM spill bytes / total HBM traffic above this trips the detector
    spill_fraction: float = 0.01
    #: launch-overhead seconds / total above this trips the detector
    launch_overhead_fraction: float = 0.10
    #: HoL-blocked jobs / admitted jobs above this trips the detector
    hol_blocked_fraction: float = 0.05
    #: slowest/mean device-busy dilation inside a gang above this trips
    #: the straggler detector
    straggler_dilation: float = 1.2
    #: |interval - Young-Daly optimum| / optimum above this trips the
    #: checkpoint-interval detector
    checkpoint_interval_rel_error: float = 0.25
    #: SimulationCache hit rate below this (with enough lookups) trips
    #: the miss-storm detector
    cache_hit_rate_floor: float = 0.5
    #: findings recovering less than this fraction of the makespan are
    #: dropped (noise floor for the ranked table)
    min_recoverable_fraction: float = 0.005
    #: conservation-law residual (Little's law, busy-time/utilization
    #: identities — ``repro_torch.validate``) above this trips the
    #: accounting-residual detector; identities are exact, so this band
    #: only absorbs float noise on long tapes
    conservation_residual: float = 0.01


#: the one instance every renderer / detector reads by default
DEFAULT_THRESHOLDS = Thresholds()

#: legacy aliases — ``obs/timelapse.py`` and ``analysis/links.py``
#: re-export these under their historic module-level names
CAMPED_THRESHOLD = DEFAULT_THRESHOLDS.channel_camping_imbalance
LINK_CAMPING_THRESHOLD = DEFAULT_THRESHOLDS.link_camping_imbalance
