"""The model step's share of the bf16 peak: the benchmark's own count
of the operations (`benchlib.counts.eval_ops`, from the shapes and the
steps each decode ran) of the traced calls' decodes, over the device's
busy time in the traced window, against 989 TFLOP/s."""

from benchlib.layers import mfu


def read(ctx):
    return mfu(ctx)
