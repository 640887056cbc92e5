"""Sliding-window perplexity harness and sweep drivers."""
from .windowing import Chunk, sliding_windows
from .harness import (
    SweepResult,
    run_token_sweep,
    run_initial_sweep,
    run_channel_sweep,
)
from .split_eval import parse_hop_codec, run_kv_tier_eval, run_kv_tier_sweep, run_split_eval

__all__ = [
    "Chunk",
    "sliding_windows",
    "SweepResult",
    "run_token_sweep",
    "run_initial_sweep",
    "run_channel_sweep",
    "parse_hop_codec",
    "run_split_eval",
    "run_kv_tier_eval",
    "run_kv_tier_sweep",
]
