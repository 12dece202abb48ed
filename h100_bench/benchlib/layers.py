"""The arithmetic the per-layer metric readers share. Each takes the
driver's layer record of a traced run: `summary` (a `trace.Summary` or
None) and the driver's counts of the traced part: `decodes`, and the
least time `k1_bound_s` and the operations `model_ops` of those decodes.
A reader with nothing to read returns None, and the metric is left out
of the result."""

from __future__ import annotations

from benchlib.counts import MFU_PEAK

K1 = "greedy_decode_kernel"


def k1_roofline(ctx):
    s = ctx.get("summary")
    if s is None or not ctx.get("decodes"):
        return None
    n, t = s.op_count(K1), s.op_time(K1)
    if not n or t <= 0:
        return None
    return 100.0 * (ctx["k1_bound_s"] / ctx["decodes"]) / (t / n)


def encoder_ms(ctx):
    s = ctx.get("summary")
    if s is None:
        return None
    n = s.op_count(K1)
    if not n:
        return None
    return 1e3 * s.kernel_time_excluding((K1,)) / n


def mfu(ctx):
    """The model's operations in the traced decodes over the device's
    busy time in the traced window, against the bf16 peak."""
    s = ctx.get("summary")
    if s is None or not ctx.get("model_ops") or s.busy_s <= 0:
        return None
    return 100.0 * ctx["model_ops"] / s.busy_s / MFU_PEAK


def idle_share(ctx):
    s = ctx.get("summary")
    if s is None or s.window_s <= 0 or not s.device_ops:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
