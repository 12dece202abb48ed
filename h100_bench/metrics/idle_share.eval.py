"""The device's idle share: the traced window's time with no operation
on the device, in percent."""

from benchlib.layers import idle_share


def read(ctx):
    return idle_share(ctx)
