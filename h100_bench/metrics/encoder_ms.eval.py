"""encoder_ms.eval: device milliseconds per eval batch outside K1 and
outside copies (the change encoder and the batch's gathers), from the
trace, over the traced batches (K1's launches)."""

from benchlib.layers import encoder_ms


def read(ctx):
    return encoder_ms(ctx)
