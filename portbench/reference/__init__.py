"""The plain reference that decides ``correct``: PyTorch and NumPy only. It
imports neither JAX, nor the JAX package, nor anything of the port, and
takes nothing the port made: it reads the weights and inputs the benchmark
made, and the port's outputs only to judge them."""
