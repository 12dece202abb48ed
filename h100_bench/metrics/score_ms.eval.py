"""score_ms.eval: host milliseconds per eval call spent scoring its
answers (ground truth, the caption metrics, accuracy): the host time of
the program's span `ekaid.eval.score` over its count, in the traced
calls."""

from benchlib.spans import recorded, span_ms


def read(ctx):
    return span_ms(recorded(ctx), "ekaid.eval.score")
