"""Sliding-window chunking with the exact HF perplexity-recipe semantics.

This is the loop header shared by every reference harness
(``Experiments/Qwen2-0.5B/main.py:151-156``,
``Experiments/Pythia-70M/initial_exp.py:98-103``, ``last_row_exp.py:85-90``):

    for begin_loc in range(0, seq_len, stride):
        end_loc = min(begin_loc + max_length, seq_len)
        trg_len = end_loc - prev_end_loc          # tokens not yet scored
        targets = inputs.clone(); targets[:, :-trg_len] = -100
        ...
        prev_end_loc = end_loc
        if end_loc == seq_len: break

The window/stride/masking details define the PPL metric; they are reproduced here
bit-for-bit (including ``num_loss_tokens = valid - batch_size``, the shift
correction of ``main.py:166-168``). Chunks keep their natural length — the tail
chunk is shorter and runs at its natural length, which is cheaper than the
masking bookkeeping padded stats would need.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One evaluation window.

    input_ids / target_ids: (1, T) arrays; target positions already scored by a
    previous window are masked to -100. ``num_loss_tokens`` is the reference's
    token-weighting factor (valid targets minus batch size, accounting for the
    internal 1-shift).
    """

    index: int
    begin: int
    end: int
    input_ids: np.ndarray
    target_ids: np.ndarray
    num_loss_tokens: int


def sliding_windows(token_ids: np.ndarray, max_length: int, stride: int) -> Iterator[Chunk]:
    """Yield evaluation chunks over a 1-D token-id array."""
    token_ids = np.asarray(token_ids).reshape(-1)
    seq_len = token_ids.shape[0]
    if seq_len < 2:
        return
    prev_end_loc = 0
    for index, begin_loc in enumerate(range(0, seq_len, stride)):
        end_loc = min(begin_loc + max_length, seq_len)
        trg_len = end_loc - prev_end_loc
        input_ids = token_ids[begin_loc:end_loc][None, :]
        target_ids = input_ids.copy().astype(np.int64)
        if trg_len < target_ids.shape[1]:
            target_ids[:, :-trg_len] = -100
        num_valid = int((target_ids != -100).sum())
        yield Chunk(
            index=index,
            begin=begin_loc,
            end=end_loc,
            input_ids=input_ids,
            target_ids=target_ids,
            num_loss_tokens=num_valid - target_ids.shape[0],
        )
        prev_end_loc = end_loc
        if end_loc == seq_len:
            break
