"""Helpers: fixed-order float sums, the CUDA kernel build, JAX's sampling
PRNG, the clock protocol and lock contracts of the serve plane."""
