"""Per-layer metric h2d_ms.serve: device milliseconds of host-to-device
copies per request (the service's staging of its batch)."""

from harness.readers import copy_ms_per_iteration


def read(ctx):
    return copy_ms_per_iteration(ctx, "HtoD")
