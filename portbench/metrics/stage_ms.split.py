"""Device milliseconds a chunk of the split's stages: the program's
``split.stage`` spans (each stage's layers, a µ-batch each under a
pipeline), by timing events on the stream, over the traced call's chunks."""

from portbench import spans

SOURCE = "program_span"
LAYER = "wire codecs and split runtime (codecs/codec_kernels.py, parallel/split.py)"
MOVES = "scored_tokens_per_s"


def read(t, ctx):
    return spans.device_ms_per_chunk(t, "split.stage")
