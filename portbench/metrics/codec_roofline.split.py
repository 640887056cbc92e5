"""The wire codecs' share of their roofline in the traced slice, in %: the
bytes every K1-K4 launch must move (yardstick/codecs.py) over HBM's peak
rate, over the device time of those launches."""

from portbench.kinds.split import CODEC_KERNELS, codec_bound_s

SOURCE = "device_trace"
LAYER = "wire codecs and split runtime (codecs/codec_kernels.py, parallel/split.py)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    dev = t.device_s(lambda n: any(k in n for k in CODEC_KERNELS))
    bound = codec_bound_s(ctx, t)
    return 100.0 * bound / dev if dev > 0 and bound > 0 else None
