"""The yardstick's counts against hand counts."""
from __future__ import annotations

import pytest

from portbench.yardstick import attention as ya
from portbench.yardstick import codecs as yc
from portbench.yardstick import flops as yf
from portbench.yardstick.peaks import PEAK_BYTES_PER_S, PEAK_FLOPS, bound_s

CFG = {"hidden_size": 8, "head_dim": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
       "intermediate_size": 16, "num_hidden_layers": 3, "vocab_size": 10}


def test_causal_attention_counts_visible_pairs():
    # S = 3: pairs (0,0) (1,0) (1,1) (2,0) (2,1) (2,2) = 6; 2 products x 2 FLOPs
    nbytes, flops = ya.causal_attention_bytes_flops(b=2, s=3, h=4, kv=2, hd=8, itemsize=4)
    assert flops == 2 * 4 * 6 * 8 * 2 * 2
    # q and out (B S H hd) + k and v (B S KV hd)
    assert nbytes == 4 * (2 * 2 * 3 * 4 * 8 + 2 * 2 * 3 * 2 * 8)
    sb, _ = ya.causal_attention_bytes_flops(b=2, s=3, h=4, kv=2, hd=8, itemsize=4, stats=True)
    assert sb - nbytes == 2 * 4 * 2 * 4 * 3


def test_column_pass_and_paged_counts():
    nbytes, flops = ya.column_pass_bytes_flops(b=1, s=4, h=2, kv=1, hd=4, itemsize=2)
    assert flops == 2 * 2 * 10 * 4
    assert nbytes == 2 * (4 * 2 * 4 + 4 * 1 * 4) + 3 * 4 * 2 * 4
    nbytes, flops = ya.paged_decode_bytes_flops(live_rows=10, slots=3, h=4, kv=2, hd=8, itemsize=2)
    assert nbytes == 2 * (2 * 10 * 2 * 8 + 2 * 3 * 4 * 8)
    assert flops == 2 * 2 * 10 * 4 * 8


def test_codec_bytes():
    n, d = 6, 8
    assert yc.codec_bytes("int4_encode", n, d) == 4 * n * d + n * d // 2 + 4 * n
    assert yc.codec_bytes("int8_affine_encode", n, d, itemsize=2) == 2 * n * d + n * d + 8 * n
    assert yc.codec_bytes("int8_affine_decode", n, d) == 4 * n * d + n * d + 8 * n


def test_model_flops_by_hand():
    # q 8x8, k 8x4, v 8x4, o 8x8, three 8x16 MLP matrices: MACs a token
    macs = 64 + 32 + 32 + 64 + 3 * 128
    assert yf.weight_flops_per_token(CFG) == 2 * macs
    # s = 2 after 3 cached: pairs 2*3 + 3 = 9; QK and PV, 4 heads of 2
    assert yf.attention_flops(CFG, 2, past=3) == 2 * 2 * 4 * 2 * 9
    assert yf.unembed_flops(CFG, 5) == 2 * 8 * 10 * 5
    assert yf.prefill_flops(CFG, 4) == 3 * (2 * macs * 4 + 4 * 8 * 10) + 2 * 8 * 10
    assert yf.decode_flops(CFG, [3, 0]) == pytest.approx(
        3 * (2 * 2 * macs + 2 * 2 * 4 * 2 * ((3 + 1) + (0 + 1))) + 2 * 2 * 8 * 10)
    assert yf.split_window_flops(CFG, 4) == yf.layers_flops(CFG, 3, 4) + yf.unembed_flops(CFG, 3)


def test_sweep_chunk_flops_by_hand():
    s, tail = 4, 2
    per = yf.layers_flops(CFG, 1, s)
    # a zero ratio: the whole stats forward plus one baseline tail; then per
    # (method, nonzero ratio) the suffix after the layer plus a tail
    want = 3 * per + yf.unembed_flops(CFG, tail) + 2 * 1 * (1 * per + yf.unembed_flops(CFG, tail))
    assert yf.sweep_chunk_flops(CFG, s, tail, 2, [1], [0, 0.5]) == want
    # no zero ratio: the stats forward stops at the deepest layer
    want = 2 * per + 2 * 2 * (1 * per + yf.unembed_flops(CFG, tail))
    assert yf.sweep_chunk_flops(CFG, s, tail, 2, [1], [0.25, 0.5]) == want


def test_bound_takes_the_larger_time():
    assert bound_s(PEAK_BYTES_PER_S, 0.0, "float32") == 1.0
    assert bound_s(0.0, PEAK_FLOPS["bfloat16"] * 2, "bfloat16") == 2.0
