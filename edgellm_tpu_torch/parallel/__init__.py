"""Pipeline-split runtime: the model cut across stage devices, packed payloads
at every cut."""
from .split import (SplitConfig, SplitRuntime, apply_default_codec_backend,
                    hop_payload_bytes, measure_hop_times, run_pipeline_stages)

__all__ = ["SplitConfig", "SplitRuntime", "apply_default_codec_backend",
           "hop_payload_bytes", "measure_hop_times", "run_pipeline_stages"]
