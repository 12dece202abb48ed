"""encode_graph_share.eval: the share of the eval encodes that replayed
the encoder's CUDA graph, in percent, over the traced calls: the
program's counters `ekaid.encode.graph` and `ekaid.encode.eager`.
Nothing where the program counts neither (a program that runs every
encode eagerly, uncounted)."""

from benchlib.spans import recorded, share


def read(ctx):
    return share(recorded(ctx), "ekaid.encode.graph", "ekaid.encode.eager")
