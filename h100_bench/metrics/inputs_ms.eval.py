"""inputs_ms.eval: host milliseconds per eval batch spent making its
inputs (the device image cache's host reads and uploads and the gather;
or the wait on the Loader's queue and the copy to the device): the host
time of the program's span `ekaid.eval.inputs` over the batches decoded
(the count of `ekaid.eval.decode`; the wire path's last wait, on the
end of the Loader's queue, is one span more a call), in the traced
calls."""

from benchlib.spans import recorded, span_ms


def read(ctx):
    return span_ms(recorded(ctx), "ekaid.eval.inputs",
                   per="ekaid.eval.decode")
