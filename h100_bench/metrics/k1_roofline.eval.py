"""K1's share of its roofline: the least time of the traced decodes
(`benchlib.counts.k1_bound`, from their rows and the steps they ran)
over K1's device time in the trace, per decode. Nothing where the trace
holds no K1 launch."""

from benchlib.layers import k1_roofline


def read(ctx):
    return k1_roofline(ctx)
