"""The LM decode steps' share of their roofline: the least time of the
traced decodes' steps (`benchlib.counts_lm.decode_bound_s`: every
weight of the LM read once a step, the latent cache at its length, at
3.35 TB/s, or the step's operations at 989 TFLOP/s where that is more)
over the device time of the kernels launched inside the program's spans
`ekaid.lm.step` (`benchlib.launches`). None where the trace holds no
such span or no decode of the LM."""


def read(ctx):
    s = (ctx.get("lm") or {}).get("ekaid.lm.step")
    if not s or not s["spans"] or s["device_s"] <= 0 \
            or not ctx.get("step_bound_s"):
        return None
    return 100.0 * ctx["step_bound_s"] / s["device_s"]
