"""Engine observability of the port: metrics registry, request tracing and
per-dispatch profiling (copies of the reference's ``obs.metrics`` /
``obs.trace`` / ``obs.profile``).  The profiler feeds the online
cost-model calibration (``repro_torch.core.costmodel.CalibratedCostModel``)."""
from repro_torch.obs.metrics import (MetricsRegistry, histogram_quantile,
                                     histogram_quantiles)
from repro_torch.obs.profile import (DISPATCH_KINDS, DispatchProfiler,
                                     ProfileSample)
from repro_torch.obs.trace import PID_ENGINE, PID_REQUESTS, Tracer

__all__ = ["MetricsRegistry", "Tracer", "DispatchProfiler", "ProfileSample",
           "DISPATCH_KINDS", "PID_ENGINE", "PID_REQUESTS",
           "histogram_quantile", "histogram_quantiles"]
