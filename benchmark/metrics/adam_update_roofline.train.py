"""Per-layer metric adam_update_roofline.train: the update's bytes (20 a
parameter with bf16 moments) at the memory's peak over the time the trace
gives ``adam_update``."""

from harness.readers import ADAM_UPDATE, roofline


def read(ctx):
    return roofline(ctx, ADAM_UPDATE, "adam_update_bound_s")
