"""Serving, local batched route: the continuous batcher over the paged KV
pool (``batching``), the single-stream ``generate`` (``decode``), the serving
front and its overload controllers (``frontend``, ``overload``), and the
soak definition (``soak``)."""
from .batching import BatchingConfig, ContinuousBatcher, Stream
from .decode import generate
from .frontend import Request, RequestRecord, ServeFront, ServeFrontConfig
from .overload import (AdmissionConfig, AdmissionController, AdmissionError, BreakerConfig,
                       BrownoutConfig, BrownoutController, CircuitBreaker, CircuitOpen,
                       DeadlineInfeasible, QueueFull, RetryBudget, RetryBudgetConfig,
                       RetryBudgetExhausted, ServeFrontConfigError)
from .recovery import (CheckpointError, CheckpointTierMismatchError, DecodeTimeout,
                       StageLostError, Watchdog)
from .soak import SoakConfig

__all__ = [
    "BatchingConfig", "ContinuousBatcher", "Stream", "generate",
    "Request", "RequestRecord", "ServeFront", "ServeFrontConfig",
    "AdmissionConfig", "AdmissionController", "AdmissionError", "BreakerConfig",
    "BrownoutConfig", "BrownoutController", "CircuitBreaker", "CircuitOpen",
    "DeadlineInfeasible", "QueueFull", "RetryBudget", "RetryBudgetConfig",
    "RetryBudgetExhausted", "ServeFrontConfigError",
    "CheckpointError", "CheckpointTierMismatchError", "DecodeTimeout", "StageLostError",
    "Watchdog", "SoakConfig",
]
