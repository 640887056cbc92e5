"""PyTorch and CUDA port of ``edgellm_tpu`` for one NVIDIA H100.

The JAX package ``edgellm_tpu`` is the reference; this package computes the
same functions and keeps its sub-package and module names (``models``,
``codecs``, ``importance``, ``parallel``, ``eval``, ``run``), so each
module's counterpart is easy to find. It imports neither JAX nor any module of ``edgellm_tpu``.
Every TPU (Pallas) kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use; each has a plain
PyTorch version beside it, which is also the CPU path. Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU.

Ported so far: the importance-guided boundary-quantization perplexity sweep
(token, channel and Pythia "initial" experiments), and the real split eval
(``parallel.SplitRuntime``, ``eval.run_split_eval``: the model cut across
stages, each cut crossed as a packed wire payload).
"""

__version__ = "0.1.0"
