"""fetch_wait_ms.eval: host milliseconds per eval batch blocked reading
its tokens back from the device: the host time of the program's span
`ekaid.eval.fetch` over its count, in the traced calls."""

from benchlib.spans import recorded, span_ms


def read(ctx):
    return span_ms(recorded(ctx), "ekaid.eval.fetch")
