"""repro_torch.validate — real-trace ingestion, distribution fitting, and
analytic queueing cross-checks for the fleet simulator.

The validation loop mirrors the source paper's correlation methodology at
fleet scale: *ingest* a real cluster trace (Alibaba cluster-trace-gpu-v2020
schema), *fit* its arrival/service distributions with goodness-of-fit
diagnostics, *simulate* (either the trace replayed verbatim through a
table cost model, or a ``synthetic:alibaba-like`` workload refit from the
fitted distributions), and *cross-check* the resulting
:class:`~repro_torch.cluster.events.ClusterReport` against conservation laws
(Little's law per device and fleet-wide, busy-time/utilization identities)
and analytic M/G/k queueing predictions.  Conservation failures are
simulator bugs by definition; the M/G/k band is the external sanity
reference.

Entry points: ``python -m repro_torch.validate`` (standalone CLI) and the
``--validate`` flag on ``python -m repro_torch.cluster``.
"""
from repro_torch.validate.fitting import (CANDIDATES, FitResult, best_fit,
                                          chi_square, fit, fit_all, fit_report,
                                          kolmogorov_pvalue, ks_statistic,
                                          weibull_shape_for_scv)
from repro_torch.validate.ingest import (IngestStats, WorkloadProfile,
                                         alibaba_like_trace, default_profile,
                                         load_alibaba, profile_from_trace,
                                         table_cost_model)
from repro_torch.validate.queueing import (CONSERVATION_TOL, QUEUEING_MAX_UTIL,
                                           QUEUEING_TOL, Check, ValidationReport,
                                           allen_cunneen_wq, conservation_checks,
                                           erlang_c, mmk_wq, queueing_checks,
                                           validate_cluster)

__all__ = [
    "CANDIDATES", "FitResult", "best_fit", "chi_square", "fit", "fit_all",
    "fit_report", "kolmogorov_pvalue", "ks_statistic",
    "weibull_shape_for_scv",
    "IngestStats", "WorkloadProfile", "alibaba_like_trace",
    "default_profile", "load_alibaba", "profile_from_trace",
    "table_cost_model",
    "CONSERVATION_TOL", "QUEUEING_MAX_UTIL", "QUEUEING_TOL", "Check",
    "ValidationReport", "allen_cunneen_wq", "conservation_checks",
    "erlang_c", "mmk_wq", "queueing_checks", "validate_cluster",
]
