"""Per-layer metric flash_bwd_roofline.train: the flash backward's summed
bounds (the frozen ``bwd_bounds``, dq, dk and dv as one function) over the
time the trace gives its three launches (prep, the fused pass, convert)."""

from harness.readers import FLASH_BWD, roofline


def read(ctx):
    return roofline(ctx, FLASH_BWD, "flash_bwd_bound_s")
