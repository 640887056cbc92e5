"""Serving: the continuous batcher over the paged KV pool (``batching``), the
single-stream ``generate`` and the split ``generate_split`` (``decode``),
speculative decode across the split (``speculative``), the serving front and
its overload controllers (``frontend``, ``overload``), the deterministic
soak (``soak``), survivable decode: checkpoints, stage failover and
resume (``recovery``, ``decode.resume_split``), disaggregated prefill /
decode with verified KV-page migration and its chaos soak (``disagg``,
``soak.run_disagg_soak``), and the replica router with its gray-failure
plane, the simulated replica and the cluster soak (``cluster``,
``overload.StragglerDetector``, ``soak.run_cluster_soak``)."""
from .batching import BatchingConfig, ContinuousBatcher, Stream
from .cluster import (AutoscalerConfig, ClusterConfig, ClusterConfigError, ClusterFront,
                      GrayConfig, Replica, ReplicaLostError, RespawnConfig, SimReplicaConfig,
                      SimReplicaFront, drive_cluster, sim_reference_tokens)
from .decode import generate, generate_split, resume_split
from .disagg import (DisaggConfig, DisaggError, DisaggServer, MigrationError, MigrationLink,
                     PrefillWorkerLost, migration_wire_nbytes)
from .frontend import Request, RequestRecord, ServeFront, ServeFrontConfig
from .overload import (AdmissionConfig, AdmissionController, AdmissionError, BreakerConfig,
                       BrownoutConfig, BrownoutController, CircuitBreaker, CircuitOpen,
                       DeadlineInfeasible, QueueFull, RetryBudget, RetryBudgetConfig,
                       RetryBudgetExhausted, ServeFrontConfigError, StragglerConfig,
                       StragglerDetector)
from .recovery import (CheckpointError, CheckpointTierMismatchError, DecodeCheckpoint,
                       DecodeTimeout, LocalRuntime, RecoveryConfig, RecoveryCounters,
                       StageFailure, StageLostError, Watchdog, runtime_plan_meta)
from .soak import (ClusterSoakConfig, DisaggSoakConfig, SoakConfig, run_cluster_soak,
                   run_disagg_soak, run_soak)
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
    "RetryBudgetExhausted", "ServeFrontConfigError", "StragglerConfig", "StragglerDetector",
    "CheckpointError", "CheckpointTierMismatchError", "DecodeCheckpoint", "DecodeTimeout",
    "LocalRuntime", "RecoveryConfig", "RecoveryCounters", "StageFailure", "StageLostError",
    "Watchdog", "runtime_plan_meta", "SoakConfig", "run_soak", "SpecConfig",
    "generate_speculative", "resume_speculative",
    "AutoscalerConfig", "ClusterConfig", "ClusterConfigError", "ClusterFront", "GrayConfig",
    "Replica", "ReplicaLostError", "RespawnConfig", "SimReplicaConfig", "SimReplicaFront",
    "drive_cluster", "sim_reference_tokens", "ClusterSoakConfig", "run_cluster_soak",
]
