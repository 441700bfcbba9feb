"""Engine observability of the port: metrics registry + request tracing
(copies of the reference's ``obs.metrics`` / ``obs.trace``)."""
from repro_torch.obs.metrics import (MetricsRegistry, histogram_quantile,
                                     histogram_quantiles)
from repro_torch.obs.trace import PID_ENGINE, PID_REQUESTS, Tracer

__all__ = ["MetricsRegistry", "Tracer", "PID_ENGINE", "PID_REQUESTS",
           "histogram_quantile", "histogram_quantiles"]
