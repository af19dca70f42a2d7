"""Port package: the serving runtime. A Session keeps factored operators
resident under a byte budget (and, on a card, their warmed solves as
CUDA graphs); a Batcher coalesces same-shape requests into one stacked
solve (deadlines, admission control, load shedding: ShedPolicy); an
Executor gives an async submit/future front end with warmup,
backoff-and-retry and a circuit breaker walking the degradation ladder;
Metrics exports counters and latency percentiles as JSON and Prometheus
text; ``faults`` makes the failure paths deterministically injectable.
"""

from .batching import Batcher, ShedPolicy
from .executor import Executor
from .faults import (DEGRADATION_LADDER, DeadlineExceeded, FaultInjector,
                     FaultPlan, FaultSpec, QuotaExceeded, RequestShed,
                     TransientDispatchError, default_plan)
from .metrics import Histogram, Metrics
from .session import Session, default_session

__all__ = ["Batcher", "Executor", "Histogram", "Metrics", "Session",
           "ShedPolicy", "default_session", "DEGRADATION_LADDER",
           "DeadlineExceeded", "FaultInjector", "FaultPlan", "FaultSpec",
           "QuotaExceeded", "RequestShed", "TransientDispatchError",
           "default_plan"]
