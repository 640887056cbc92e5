"""Pipeline-split runtime: the model cut across stage devices, packed payloads
at every cut, the "data" and "model" mesh axes and the µ-batch pipeline over
the stages; ring attention and the stage x seq runtime for long contexts;
several processes over one mesh (``distributed``)."""
from .distributed import (build_stage_grid, initialize_distributed, make_multihost_sp_stage_mesh,
                          make_multihost_stage_mesh)
from .ring import SplitRingRuntime, forward_sp, importance_sp, ring_attention
from .split import (Mesh, PipelineConfig, SplitConfig, SplitRuntime, apply_default_codec_backend,
                    hop_payload_bytes, make_stage_mesh, measure_hop_times, run_pipeline_stages,
                    run_pipeline_stages_microbatched)

__all__ = ["Mesh", "PipelineConfig", "SplitConfig", "SplitRuntime", "make_stage_mesh",
           "apply_default_codec_backend", "hop_payload_bytes", "measure_hop_times",
           "run_pipeline_stages", "run_pipeline_stages_microbatched", "SplitRingRuntime",
           "forward_sp", "importance_sp", "ring_attention", "initialize_distributed",
           "build_stage_grid", "make_multihost_stage_mesh", "make_multihost_sp_stage_mesh"]
