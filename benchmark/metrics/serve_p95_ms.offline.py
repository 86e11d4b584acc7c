"""Per-layer metric serve_p95_ms.offline: the 95th percentile of the
requests' latencies (from the call to ``VideoEmbedService.embed`` to its
numpy result, on the host clock) over the window after the traced
requests. The loop is closed, so the service runs at its capacity: the
tail swings with the smallest change and is no end-to-end metric here."""

from harness.readers import latency_percentile_ms


def read(ctx):
    return latency_percentile_ms(ctx, 95)
