"""Pipeline-split runtime: the model cut across stage devices, packed payloads
at every cut, and the µ-batch pipeline over the stages; ring attention and
the stage x seq runtime for long contexts."""
from .ring import SplitRingRuntime, forward_sp, importance_sp, ring_attention
from .split import (PipelineConfig, SplitConfig, SplitRuntime, apply_default_codec_backend,
                    hop_payload_bytes, measure_hop_times, run_pipeline_stages,
                    run_pipeline_stages_microbatched)

__all__ = ["PipelineConfig", "SplitConfig", "SplitRuntime", "apply_default_codec_backend",
           "hop_payload_bytes", "measure_hop_times", "run_pipeline_stages",
           "run_pipeline_stages_microbatched", "SplitRingRuntime", "forward_sp",
           "importance_sp", "ring_attention"]
