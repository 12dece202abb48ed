"""Milliseconds of device time a batch's prefill takes: the device time
of the kernels launched inside the program's span `ekaid.lm.prefill`
(`benchlib.launches`), over the spans. None where the trace holds no
such span."""


def read(ctx):
    p = (ctx.get("lm") or {}).get("ekaid.lm.prefill")
    if not p or not p["spans"] or p["device_s"] <= 0:
        return None
    return 1e3 * p["device_s"] / p["spans"]
