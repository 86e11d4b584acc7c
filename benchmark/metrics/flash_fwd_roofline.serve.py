"""Per-layer metric flash_fwd_roofline.serve: the flash forward launches' summed bounds
(the frozen ``fwd_bound`` at each launch's shapes and labels) over the
time the trace gives the ``flash_fwd`` kernels."""

from harness.readers import FLASH_FWD, roofline


def read(ctx):
    return roofline(ctx, FLASH_FWD, "flash_fwd_bound_s")
