"""Per-layer metric device_idle.train: the share of the traced window with no kernel,
copy or memset on the card."""

from harness.readers import device_idle


def read(ctx):
    return device_idle(ctx)
