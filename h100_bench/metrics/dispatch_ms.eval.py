"""dispatch_ms.eval: host milliseconds per eval batch in the call to the
model's decode (the encoder's and K1's launches): the host time of the
program's span `ekaid.eval.decode` over its count, in the traced
calls."""

from benchlib.spans import recorded, span_ms


def read(ctx):
    return span_ms(recorded(ctx), "ekaid.eval.decode")
