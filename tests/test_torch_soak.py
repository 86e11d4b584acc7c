"""The convergence-soak recipes in the port: ``configs/soak_onechip.yaml``
and ``configs/soak_fused_r5.yaml`` load to the JAX package's values, and
``scripts/pretrain_torch.py`` survives a real SIGTERM: on the CPU, at tiny
widths with the soak_fused_r5 recipe's path (``scan_layers`` off, batch 2,
``--fused_data --on_device_frames``), a run preempted by SIGTERM finishes
its step, writes ``ckpt_<n>`` and ``loader_state.json``, exits with 0, and
the same command resumes at step n. Held against an uninterrupted run of
the same command: every step's records and the batch built from them with
that step's draws (``-log_batches`` digests) bit for bit, the resumed
process's first at step n; the losses before the preemption exactly and
after it within RESUME_TOL (the checkpoint's f16 round trip of the f32
parameters); the same final loader position. And bit for bit with a run
stopped at step n by ``-num_steps`` and resumed (both take that round
trip): the same final checkpoint file, byte for byte.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

import merlot_reserve_tpu as mr
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_corpus
from scripts.profile_torch_soak import parse_log, preempt_and_resume, tracked_losses

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(hidden_size=64, joint_num_layers=1, vit_num_layers=1, audio_num_layers=1,
            span_num_layers=1, size_per_head=32, output_grid=[4, 4], use_bfloat16=False)
DATA = dict(num_segments=4, seq_len=80, lang_seq_len=40, num_text_spans_to_include=8,
            text_span_budget=10, frame_buffer_size=328)
STEPS = 6
PREEMPT_AFTER = 2  # the SIGTERM goes out once step 2 is logged
# the resumed run's loss terms against the uninterrupted run's: the
# checkpoint rounds the f32 parameters to f16 at step n (1.4e-6 measured
# here on the CPU; one step moves text_to_audio by about 1.6e-4)
RESUME_TOL = 1e-5


@pytest.mark.parametrize("name", ["soak_onechip", "soak_fused_r5"])
def test_soak_configs_match_jax(name):
    j, t = mr.load_config(name), load_config(name)
    for part in ("model", "data", "device", "optimizer"):
        assert dataclasses.asdict(getattr(t, part)) == dataclasses.asdict(getattr(j, part)), part
    assert t.optimizer.num_train_steps == 1200 and t.model.hidden_size == 768
    assert t.model.scan_layers == (name == "soak_onechip")


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """The soak_fused_r5 recipe at tiny widths, and a structured corpus."""
    tmp = tmp_path_factory.mktemp("soak")
    raw = yaml.safe_load((ROOT / "merlot_reserve_tpu_torch/configs/soak_fused_r5.yaml").read_text())
    raw["model"].update(TINY)
    raw["data"].update(DATA)
    raw["optimizer"].update(num_train_steps=STEPS, num_warmup_steps=1)
    (tmp / "tiny.yaml").write_text(yaml.safe_dump(raw))
    cfg = load_config(str(tmp / "tiny.yaml"))
    assert not cfg.model.scan_layers
    for i in range(2):
        write_synthetic_corpus(str(tmp / f"fold{i:05d}.tfrecord"), cfg, num_records=8, seed=i,
                               structured=True)
    return tmp


def _command(recipe, out, steps):
    return [sys.executable, str(ROOT / "scripts" / "pretrain_torch.py"), str(recipe / "tiny.yaml"),
            "-train_fns", str(recipe / "fold*.tfrecord"), "-output_dir", str(out),
            "-num_steps", str(steps), "-batch_size", "2", "-seed", "3", "-log_every", "0",
            "-log_batches", "--device", "cpu", "--fused_data", "--on_device_frames"]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, env=_env(), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_pretrain_script_survives_sigterm_and_resumes(recipe, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "preempted"
    run = preempt_and_resume(_command(recipe, out, STEPS), str(out), PREEMPT_AFTER, timeout=600)
    assert "signal 15: checkpointing and exiting after the current step" in run["first"]
    n = run["stopped"]
    assert run["checkpoints"] == [n] and PREEMPT_AFTER < n < STEPS, (run["checkpoints"],
                                                                     run["first"][-2000:])
    assert f"resumed from step {n} (msgpack)" in run["second"]
    (l1, _, o1), (l2, _, o2) = parse_log(run["first"]), parse_log(run["second"])
    # the uninterrupted run of the same command
    straight = _run(_command(recipe, tmp_path / "straight", STEPS))
    l3, _, o3 = parse_log(straight)
    assert sorted(o3["batches"]) == sorted(l3) == list(range(STEPS))
    # each step's records, and the batch built from them with that step's
    # draws, bit for bit: the resumed process's first step is step n
    assert sorted(o1["batches"]) == sorted(l1) == list(range(n))
    assert sorted(o2["batches"]) == sorted(l2) == list(range(n, STEPS))
    for s in range(STEPS):
        assert (o1["batches"] if s < n else o2["batches"])[s] == o3["batches"][s], s
    # the losses as the runs' trackers hold them (f32): before the
    # preemption exactly, after the resume within the checkpoint's f16
    # round trip of the f32 parameters
    got, want = tracked_losses(str(out)), tracked_losses(str(tmp_path / "straight"))
    assert sorted(got) == sorted(want) == list(range(STEPS))
    for s in range(n):
        assert got[s] == want[s], s
    gap = max(abs(got[s][k] - want[s][k]) for s in range(n, STEPS) for k in got[s])
    assert gap <= RESUME_TOL, gap
    assert (out / "loader_state.json").read_text() == \
        (tmp_path / "straight" / "loader_state.json").read_text()
    # and bit for bit with a run stopped at step n by -num_steps and resumed
    # by the same command (both take that round trip at step n)
    ref = tmp_path / "planned"
    planned = _run(_command(recipe, ref, n))
    _run(_command(recipe, ref, STEPS))
    assert (out / f"ckpt_{STEPS}").read_bytes() == (ref / f"ckpt_{STEPS}").read_bytes()
    assert (out / "loader_state.json").read_text() == (ref / "loader_state.json").read_text()
    assert parse_log(planned)[0] == {s: l1[s] for s in range(n)}


def test_soak_tool_preempts_and_reports_on_the_cpu(recipe, tmp_path, capsys):
    """scripts/profile_torch_soak.py end to end at the tiny recipe: the
    corpus, the SIGTERM, the restart, the windowed table and its JSON."""
    from scripts.profile_torch_soak import main

    main(["--config", str(recipe / "tiny.yaml"), "--recipe", "soak_fused_r5", "--steps",
          str(STEPS), "--preempt_at", "3", "--records", "2", "--log_every", "0",
          "--device", "cpu", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    line = json.loads(out.strip().splitlines()[-1])
    assert 2 < line["preempted_at"] < STEPS and line["steps"] == STEPS
    assert line["loader_state"]["records_consumed"] == 2 * line["preempted_at"]
    assert len(line["windows"]) == 1 and len(line["first_losses"]) == STEPS
    assert line["write_s"] > 0 and line["load_s"] > 0
    assert "| 0-50 (preempted inside) |" in out
