"""The trace reading on a small fixture in Kineto's Chrome-trace layout:
the window, the card's busy time as a union of its lanes, the idle gaps
named by the host's calls, the op table, and the per-layer readers."""

import pytest

from conftest import BENCH
from frozen import trace
from harness.readers import Context

FIXTURE = BENCH / "tests" / "fixtures" / "trace_small.json"


@pytest.fixture
def win():
    return trace.window(trace.load_events(FIXTURE), "bench/window")


def test_lanes_and_categories():
    events = trace.load_events(FIXTURE)
    lanes = {e.lane for e in events}
    assert lanes == {"python3 (CPU)", "python3 (GPU 0)"}
    assert {e.cat for e in events} >= {"kernel", "gpu_memcpy", "cuda_runtime", "cpu_op"}


def test_window_busy_and_idle(win):
    assert win.seconds == pytest.approx(1e-3)
    assert len(win.device) == 5  # the kernel after the window and the projected range left out
    assert trace.busy_intervals(win) == [(1050, 1300), (1320, 1400), (1700, 1800), (1900, 1950)]
    assert trace.busy_seconds(win) == pytest.approx(480e-6)


def test_idle_gaps_named_by_the_host(win):
    gaps = trace.idle_gaps(win)
    assert [n for n, _ in gaps] == ["cudaMemcpyAsync", "host", "cudaLaunchKernel", "host",
                                    "host"]
    assert [round(s * 1e6) for _, s in gaps] == [300, 100, 50, 50, 20]


def test_device_op_table(win):
    table = dict(trace.device_op_table(win))
    assert table["nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN"] == pytest.approx(200e-6)
    assert list(table)[0].startswith("nvjet")


def test_readers(win):
    import importlib.util

    work = {"flops_per_iteration": 989e12 * 0.5, "peak_flops": 989e12,
            "flash_fwd_bound_s": 50e-6, "flash_bwd_bound_s": 20e-6, "adam_update_bound_s": 25e-6,
            "iterations": 2}
    host = {"iterations": 10, "seconds": 20.0, "latencies_ms": list(range(1, 101))}
    ctx = Context(win, work, host)

    def read(name):
        spec = importlib.util.spec_from_file_location("m", BENCH / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read(ctx)

    assert read("mfu.train") == pytest.approx(25.0)
    assert read("serve_p95_ms.offline") == pytest.approx(95.05)
    assert read("flash_fwd_roofline.train") == pytest.approx(50.0)
    assert read("flash_bwd_roofline.train") == pytest.approx(25.0)
    assert read("adam_update_roofline.train") == pytest.approx(50.0)
    assert read("device_idle.serve") == pytest.approx(52.0)
    assert read("h2d_ms.serve") == pytest.approx(0.05)


def test_a_reader_with_nothing_to_read_returns_none(win):
    ctx = Context(trace.Window(win.start_us, win.end_us, [], [], []), {"iterations": 1})
    from harness import readers

    assert readers.roofline(ctx, readers.FLASH_FWD, "flash_fwd_bound_s") is None
    assert readers.copy_ms_per_iteration(ctx, "HtoD") is None
    assert readers.device_idle(ctx) is None
    assert readers.mfu(ctx) is None
    assert readers.latency_percentile_ms(ctx, 95) is None


def test_a_trace_of_the_card_alone_is_bounded_by_its_synchronises():
    """Where only the card and the runtime calls were traced, the window
    runs from the end of the first device synchronise to the end of the
    last."""
    events = [e for e in trace.load_events(FIXTURE)
              if e.cat not in ("user_annotation", "gpu_user_annotation", "cpu_op")]
    sync = dict(cat="cuda_runtime", lane="python3 (CPU)", thread="11",
                name="cudaDeviceSynchronize")
    events += [trace.Event(start_us=990, dur_us=50, **sync),
               trace.Event(start_us=1950, dur_us=60, **sync)]
    w = trace.window(events, "bench/window")
    assert (w.start_us, w.end_us) == (1040, 2010)
    assert trace.busy_seconds(w) == pytest.approx(480e-6)
    assert [n for n, _ in trace.idle_gaps(w)][:3] == ["cudaMemcpyAsync", "host",
                                                     "cudaDeviceSynchronize"]
    with pytest.raises(ValueError):
        trace.window(events[:-2], "bench/window")
