"""Per-layer metric mfu.serve: the model FLOPs per second (the frozen analytic
count per iteration, over the iterations of the window after the traced
ones, on the host clock), as a share of the card's bf16 peak."""

from harness.readers import mfu


def read(ctx):
    return mfu(ctx)
