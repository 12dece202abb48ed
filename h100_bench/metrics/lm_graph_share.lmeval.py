"""lm_graph_share.lmeval: the share of the LM's decode steps whose
forward replayed the step's CUDA graph, in percent, over the traced
calls: the program's counters `ekaid.lm.graph` and `ekaid.lm.eager`.
Nothing where the program counts neither (a program that runs every
step eagerly, uncounted)."""

from benchlib.spans import recorded, share


def read(ctx):
    return share(recorded(ctx), "ekaid.lm.graph", "ekaid.lm.eager")
