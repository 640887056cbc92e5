"""Helpers: FLOP accounting, fixed-order float sums, the CUDA kernel build."""
