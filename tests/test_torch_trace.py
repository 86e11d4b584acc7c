"""Port parity: the trace helpers of merlot_reserve_tpu_torch/utils/profiling.py
(``TraceEvent``, ``find_trace_files``, ``load_trace_events``,
``op_time_table``, ``trace_wall_ms``) against the JAX package's on the same
Chrome-trace files, the port's ``trace`` and ``log_compiles``, and
``scripts/profile_step_torch.py`` on the CPU at a tiny config.

Tolerances: none; rows, lanes, threads and wall times are equal.
"""

import gzip
import json
import logging

import pytest
import torch
import yaml

from merlot_reserve_tpu.utils import profiling as jprof
from merlot_reserve_tpu_torch.kernels import build
from merlot_reserve_tpu_torch.utils import profiling as tprof


def _synthetic_trace(path):
    """A jax.profiler-like dump: a device process with two threads, a host
    process, metadata, non-'X' events to skip, and repeated op names."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/device:TPU:0 (pid 1)"}},
        {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 10, "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 11, "args": {"name": "Steps"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 20, "args": {"name": "python"}},
        {"ph": "i", "name": "marker", "pid": 1, "tid": 10, "ts": 5.0},
    ]
    ops = [("fusion.1", 1, 10, 100.0, 40.0), ("convolution.3", 1, 10, 150.0, 250.5),
           ("fusion.1", 1, 10, 410.0, 39.5), ("step 0", 1, 11, 90.0, 400.0),
           ("copy.7", 1, 10, 460.0, 12.25), ("PjitFunction", 2, 20, 0.0, 520.0),
           ("fusion.1", 1, 10, 480.0, 41.0)]
    for name, pid, tid, ts, dur in ops:
        events.append({"ph": "X", "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
                       "args": {"hlo_op": name}})
    path.mkdir(parents=True, exist_ok=True)
    with gzip.open(path / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ns"}, f)


@pytest.mark.parametrize("lane_filter", [None, "tpu", "host", "nothing"])
def test_trace_helpers_match_jax_on_a_synthetic_trace(tmp_path, lane_filter):
    _synthetic_trace(tmp_path / "plugins" / "profile" / "run")
    assert tprof.find_trace_files(str(tmp_path)) == jprof.find_trace_files(str(tmp_path))
    ours, theirs = (m.load_trace_events(str(tmp_path)) for m in (tprof, jprof))
    assert [tuple(vars(e).values()) for e in ours] == [tuple(vars(e).values()) for e in theirs]
    assert len(ours) == 7 and ours[0].lane == "/device:TPU:0 (pid 1)"
    for top in (None, 2):
        assert (tprof.op_time_table(str(tmp_path), lane_filter, top)
                == jprof.op_time_table(str(tmp_path), lane_filter, top))
    assert (tprof.trace_wall_ms(ours, lane_filter)
            == jprof.trace_wall_ms(theirs, lane_filter))
    if lane_filter == "tpu":
        rows = tprof.op_time_table(ours, "tpu")
        assert rows[0]["name"] == "step 0" and rows[1]["name"] == "convolution.3"
        assert [r["name"] for r in rows].count("fusion.1") == 1
        assert tprof.trace_wall_ms(ours, "tpu") == pytest.approx(0.431)


def test_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tprof.load_trace_events(str(tmp_path))


def test_a_real_cpu_trace_reads_back(tmp_path):
    """``trace`` writes Kineto's gzipped Chrome trace; the port's helpers
    read its ops (with the lane's labels), and the JAX helpers, which glob
    the same file, count the same rows over all lanes."""
    a = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)) as prof:
        for _ in range(3):
            (a @ a).relu_()
    files = tprof.find_trace_files(str(tmp_path))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json.gz")
    events = tprof.load_trace_events(str(tmp_path))
    names = {e.name for e in events}
    assert {"aten::mm", "aten::relu_"} <= names
    # Kineto's process name (the interpreter's, "python" or "python3") with its label
    lanes = {e.lane for e in events if e.name == "aten::mm"}
    assert len(lanes) == 1 and lanes.pop().endswith(" (CPU)")
    rows = {r["name"]: r for r in tprof.op_time_table(events, "cpu", top=None)}
    assert rows["aten::mm"]["count"] == 3 and rows["aten::relu_"]["count"] == 3
    assert tprof.op_time_table(events, tprof.DEVICE_LANES) == []  # no card here
    assert tprof.trace_wall_ms(events, "cpu") > 0
    j_rows = jprof.op_time_table(str(tmp_path), None, top=None)
    assert j_rows == tprof.op_time_table(str(tmp_path), None, top=None)
    assert sum(1 for e in prof.events() if e.name == "aten::mm") == 3


def test_log_compiles_logs_kernel_builds_only_while_on(monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_compile", lambda name: build.Built(
        tmp_path / f"lib{name}.so", 0.0 if name == "adam_update" else 12.5, ""))
    caplog.set_level(logging.WARNING, logger=tprof.COMPILE_LOG.name)
    build.build(["flash_fwd"])
    assert caplog.records == []
    with tprof.log_compiles():
        build.build(["flash_fwd", "adam_update"])
        with tprof.log_compiles(False):
            build.build(["ring_fwd"])
    assert [r.getMessage() for r in caplog.records] == [
        "kernel build flash_fwd: built in 12.500 s", "kernel build adam_update: cached in 0.000 s"]
    build.build(["flash_bwd"])
    assert len(caplog.records) == 2


def test_profile_step_torch_on_the_cpu(tmp_path, capsys):
    from scripts.profile_step_torch import main

    raw = yaml.safe_load(open(tprof.__file__.replace("utils/profiling.py", "configs/base.yaml")))
    raw["model"].update(hidden_size=64, joint_num_layers=1, vit_num_layers=1, audio_num_layers=1,
                        span_num_layers=1, size_per_head=32, output_grid=[4, 4],
                        use_bfloat16=False)
    raw["data"].update(num_segments=4, seq_len=80, lang_seq_len=40, num_text_spans_to_include=8)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(raw))
    torch.manual_seed(0)
    main([f"--config={tmp_path / 'tiny.yaml'}", "--batch=2", "--unroll", "--device=cpu",
          f"--out={tmp_path / 'trace'}", "--top=5"])
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["metric"] == "profiled_step_device_wall_ms" and line["value"] > 0
    assert line["scan_layers"] is False and line["lane_filter"] is None
    assert len(line["top"]) == 5 and "ops:" in out.err
