"""Device milliseconds a chunk of the split's hops: the program's
``split.cross`` spans (encode, copy and decode of one cut), by timing events
on the sending device's stream, over the traced call's chunks."""

from portbench import spans

SOURCE = "program_span"
LAYER = "wire codecs and split runtime (codecs/codec_kernels.py, parallel/split.py)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    return spans.device_ms_per_chunk(t, "split.cross")
