"""Serving: the continuous batcher over the paged KV pool (``batching``), the
single-stream ``generate`` and the split ``generate_split`` (``decode``),
speculative decode across the split (``speculative``), the serving front and
its overload controllers (``frontend``, ``overload``), the deterministic
soak (``soak``), survivable decode: checkpoints, stage failover and
resume (``recovery``, ``decode.resume_split``), and disaggregated prefill /
decode with verified KV-page migration and its chaos soak (``disagg``,
``soak.run_disagg_soak``)."""
from .batching import BatchingConfig, ContinuousBatcher, Stream
from .decode import generate, generate_split, resume_split
from .disagg import (DisaggConfig, DisaggError, DisaggServer, MigrationError, MigrationLink,
                     PrefillWorkerLost, migration_wire_nbytes)
from .frontend import Request, RequestRecord, ServeFront, ServeFrontConfig
from .overload import (AdmissionConfig, AdmissionController, AdmissionError, BreakerConfig,
                       BrownoutConfig, BrownoutController, CircuitBreaker, CircuitOpen,
                       DeadlineInfeasible, QueueFull, RetryBudget, RetryBudgetConfig,
                       RetryBudgetExhausted, ServeFrontConfigError)
from .recovery import (CheckpointError, CheckpointTierMismatchError, DecodeCheckpoint,
                       DecodeTimeout, LocalRuntime, RecoveryConfig, RecoveryCounters,
                       StageFailure, StageLostError, Watchdog, runtime_plan_meta)
from .soak import DisaggSoakConfig, SoakConfig, run_disagg_soak, run_soak
from .speculative import SpecConfig, generate_speculative, resume_speculative

__all__ = [
    "BatchingConfig", "ContinuousBatcher", "Stream", "generate", "generate_split",
    "resume_split",
    "DisaggConfig", "DisaggError", "DisaggServer", "MigrationError", "MigrationLink",
    "PrefillWorkerLost", "migration_wire_nbytes", "DisaggSoakConfig", "run_disagg_soak",
    "Request", "RequestRecord", "ServeFront", "ServeFrontConfig",
    "AdmissionConfig", "AdmissionController", "AdmissionError", "BreakerConfig",
    "BrownoutConfig", "BrownoutController", "CircuitBreaker", "CircuitOpen",
    "DeadlineInfeasible", "QueueFull", "RetryBudget", "RetryBudgetConfig",
    "RetryBudgetExhausted", "ServeFrontConfigError",
    "CheckpointError", "CheckpointTierMismatchError", "DecodeCheckpoint", "DecodeTimeout",
    "LocalRuntime", "RecoveryConfig", "RecoveryCounters", "StageFailure", "StageLostError",
    "Watchdog", "runtime_plan_meta", "SoakConfig", "run_soak", "SpecConfig",
    "generate_speculative", "resume_speculative",
]
