"""The memory-probe primitive of the window-batch preflight (PyTorch
counterpart of ``edgellm_tpu/analysis/aot.py``).

The reference compiles an entry point ahead of time and reads XLA's
``memory_analysis()`` (argument, output and temp bytes) without allocating
device memory. torch has no such analysis, so the port measures instead: it
runs the call once on the card between ``torch.cuda.reset_peak_memory_stats``
and ``torch.cuda.max_memory_allocated``, at a batch small enough to fit, and
reads the peak the caching allocator saw. The peak is absolute: it holds
what was resident before the call (the weights, the reference's argument
bytes) beside what the call allocated. A probe that runs out of memory is a
doesn't-fit verdict (``None``), read through the port's out-of-memory test.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def is_over_hbm(e: BaseException) -> bool:
    """True when a probe failed for want of device memory: the port's
    out-of-memory test (:func:`~..eval.harness.is_oom_error`)."""
    from ..eval.harness import is_oom_error

    return is_oom_error(e)


def cuda_peak_bytes(call: Callable[[], object], device="cuda") -> int:
    """Run ``call()`` once on ``device`` and return the allocator's peak of
    allocated bytes during it (resident tensors included)."""
    device = torch.device(device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    result = call()
    torch.cuda.synchronize(device)
    del result
    return int(torch.cuda.max_memory_allocated(device))


def cuda_increment_bytes(call: Callable[[], object], device="cuda") -> int:
    """Run ``call()`` once on ``device`` and return what it allocated above
    what was resident just before it: the allocator's peak during the call
    minus ``memory_allocated`` at its start (the weights, the cuBLAS
    workspace and every other resident tensor left out)."""
    device = torch.device(device)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    result = call()
    torch.cuda.synchronize(device)
    del result
    return int(torch.cuda.max_memory_allocated(device)) - int(base)


def call_total_bytes(call: Callable[[], object], device="cuda",
                     peak_reader: Optional[Callable] = None) -> Optional[int]:
    """The peak bytes of one call (``peak_reader(call)``, by default
    :func:`cuda_peak_bytes` on ``device``), or ``None`` when the call runs
    out of memory: the wb_preflight convention. Any other failure
    propagates."""
    reader = peak_reader if peak_reader is not None else (
        lambda c: cuda_peak_bytes(c, device))
    try:
        return int(reader(call))
    except Exception as e:
        if not is_over_hbm(e):
            raise
    # free outside the except block: its traceback still holds the call's tensors
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return None
