"""The LM eval step's share of the bf16 peak: the operations of the
traced calls' decodes (`benchlib.counts_lm.eval_ops`: the change
encoder, the projector, the prefill and the decode steps' forwards,
from the shapes, the steps each decode needed and the cache lengths)
over the device's busy time in the traced window, against 989 TFLOP/s.
None where the trace holds no decode of the LM."""

from benchlib.layers import mfu


def read(ctx):
    if not ctx.get("lm_decodes"):
        return None
    return mfu(ctx)
