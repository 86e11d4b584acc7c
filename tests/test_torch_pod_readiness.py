"""Pod readiness on one card: the stand-in rank (``parallel.distributed.
initialize_standin``, torch's fake process group) against real ranks and the
JAX package, at the tiny widths of ``tests/test_torch_distributed.py``
(hidden 64, 2 layers a tower, f32 compute, bf16 gradients), on the CPU.

(a) Every rank of real gloo jobs at dp2 x tp2, dp2 x pp2 and dp4 with
    ZeRO-1 (``tests/_torch_dist_worker.py``, one job of four processes)
    issues, in one train step, exactly the collectives that a stand-in of
    that rank records: op, axis, dtype, purpose and bytes, counted.
(b) A stand-in's per-rank bytes of f32 masters and of each Adam moment equal
    the per-device bytes of the JAX package's ``state_shardings(mesh,
    state, zero1=True)`` over ``scripts/pod_readiness.py``'s abstract train
    state, on the 8 virtual CPU devices, at dp8, dp4 x tp2 and dp2 x pp2 x
    tp2; its bf16 compute copies half the per-device bytes of
    ``param_shardings`` without ZeRO-1. The only difference allowed is the
    alignment padding of the port's flat buffers of the entries outside
    ZeRO-1 (each entry starts on 256 elements), computed here. Under the
    scan layout the JAX rules read tp on the stacked tower leaves, so they
    leave the towers' stacked qkv and attn_proj whole on a tp rank (ZeRO-1
    then splits them over dp) where the port splits each layer over tp
    (ROADMAP Queue 3): dp4 x tp2 is compared in the unrolled layout, and at
    dp2 x pp2 x tp2 (scan, as ``pod_readiness.py`` forces) the masters and
    moments agree (dp = tp = 2 halves them either way) while the compute
    copies differ by those leaves' tp share, computed here.
(c) The training loop, every checkpoint save and the peer ring refuse a
    stand-in.
(d) ``scripts/audit_comm_torch.py``'s table at dp2 x tp2 is (a)'s rank 0.
(e) Every committed row of ``docs/pod_readiness_results_torch.jsonl``
    (stand-in ranks on the H100) lies within 25% of ``estimate_train_hbm``
    for its layout, as ``tests/test_memory.py`` holds the JAX rows.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data.dummy import make_dummy_batch as jax_make_dummy_batch
from merlot_reserve_tpu.parallel import make_mesh as jax_make_mesh
from merlot_reserve_tpu.parallel.sharding import param_shardings as jax_param_shardings
from merlot_reserve_tpu.parallel.sharding import state_shardings as jax_state_shardings
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer
from merlot_reserve_tpu_torch.parallel import distributed, readiness
from merlot_reserve_tpu_torch.parallel.mesh import make_mesh
from merlot_reserve_tpu_torch.training.trainer import create_distributed_train_state

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "_torch_dist_worker.py"
ROWS = ROOT / "docs" / "pod_readiness_results_torch.jsonl"
WORLD = 4
BATCH = 4
MODEL = dict(hidden_size=64, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
             span_num_layers=2, size_per_head=32, output_grid=(4, 4), use_bfloat16=False)
DATA = dict(num_segments=4, num_segment_groups=2, seq_len=80, lang_seq_len=40,
            num_text_spans_to_include=8)
PIPELINE = dict(pipeline_axis="pp", pipeline_microbatches=2)
JOBS = {"dp2_tp2": dict(mesh=dict(dp=2, tp=2)),
        "dp2_pp2": dict(mesh=dict(dp=2, pp=2), model=PIPELINE),
        "dp4_zero1": dict(mesh=dict(dp=4))}
ROW_TOL = 0.25


def _config(**model):
    cfg = load_config("base", **MODEL).replace_data(**DATA)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))


def _kinds(records):
    """Per (op, axis, dtype, purpose, bytes): how many."""
    return Counter((r["op"], r["axis"], r["dtype"], r["what"], r["bytes"]) for r in records)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_records(tmp_path_factory):
    """Every rank's records of one train step of each job's layout, from
    four real gloo processes."""
    tmp = tmp_path_factory.mktemp("pod")
    cfg = _config()
    start = MerlotReservePretrainer(cfg, device="cpu", seed=0).state_dict()
    cases = {k: dict(v, kind="records") for k, v in JOBS.items()}
    job = {"model": MODEL, "data": DATA, "optimizer": {}, "bf16_grads": True, "params": start,
           "batch": make_dummy_batch(cfg, BATCH, seed=0), "split_at": None, "gumbel": None,
           "cases": cases, "out": str(tmp / "out.pt")}
    torch.save(job, tmp / "job.pt")
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen([sys.executable, str(WORKER), str(tmp / "job.pt")],
                                      env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    deadline = time.time() + 300
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.time(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(o[-3000:] for o in outs)
    return {k: v["records"] for k, v in torch.load(tmp / "out.pt", weights_only=False).items()}


def _standin_records(name, rank):
    case = JOBS[name]
    layout = readiness.Layout(name, case["mesh"], BATCH)
    role = readiness.run_role(_config(**case.get("model", {})), layout, rank,
                              BATCH // case["mesh"]["dp"], steps=1, device="cpu",
                              keep_records=True)
    assert not distributed.is_initialized()
    return role["records"][0]


@pytest.mark.parametrize("name", sorted(JOBS))
def test_standin_collectives_equal_a_real_ranks(gloo_records, name):
    torch.set_num_threads(1)
    for rank in range(WORLD):
        real = gloo_records[name][rank]
        assert real, (name, rank)
        assert _kinds(_standin_records(name, rank)) == _kinds(real), (name, rank)


def _jax_device_bytes(cfg_j, mesh):
    """Per-device bytes of the f32 params, mu and nu of the JAX train state
    under ``state_shardings(zero1=True)``, and of the params without ZeRO-1."""
    from scripts.pod_readiness import abstract_train_state

    batch = jax_make_dummy_batch(cfg_j, batch_size=2, seed=0, num_text_spans=8)
    state = abstract_train_state(cfg_j, batch)
    shardings = jax_state_shardings(mesh, state, zero1=True)

    def nbytes(leaves, sh):
        return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
                   for x, s in zip(jax.tree_util.tree_leaves(leaves),
                                   jax.tree_util.tree_leaves(sh)))

    out = {"masters": nbytes(state.params, shardings.params)}
    adam = state.opt_state[0]
    adam_sh = shardings.opt_state[0]
    out["mu"] = nbytes(adam.mu, adam_sh.mu)
    out["nu"] = nbytes(adam.nu, adam_sh.nu)
    whole = jax_param_shardings(mesh, state.params, zero1_dp=False)
    out["params_f32"] = nbytes(state.params, whole)
    # the scan layout's known difference (ROADMAP Queue 3): the JAX rules
    # leave the towers' stacked qkv and attn_proj whole on a tp rank (their
    # per-layer tp rule does not match a 4-d leaf), the port splits each
    # layer's over tp
    tp = mesh.shape.get("tp", 1)
    out["towers_stacked_tp_f32"] = sum(
        int(np.prod(x.shape)) * x.dtype.itemsize * (tp - 1) // tp
        for path, x in jax.tree_util.tree_flatten_with_path(state.params)[0]
        if x.ndim == 4 and "joint_transformer" not in jax.tree_util.keystr(path)
        and any(k in jax.tree_util.keystr(path) for k in ("'qkv'", "'attn_proj'")))
    return out


@pytest.mark.parametrize("name,axes,model", [
    ("dp8", dict(dp=8), {}),
    ("dp4xtp2", dict(dp=4, tp=2), dict(scan_layers=False)),
    ("dp2pp2tp2", dict(dp=2, pp=2, tp=2), dict(scan_layers=True, **PIPELINE)),
])
def test_standin_state_bytes_equal_the_jax_shardings(cpu_devices, name, axes, model):
    cfg_j = mr.load_config("base", **MODEL, **model).replace_data(**DATA)
    jax_bytes = _jax_device_bytes(cfg_j, jax_make_mesh(**axes, devices=cpu_devices[:8]))
    cfg = _config(**model)
    distributed.initialize_standin(8, 0, device="cpu")
    try:
        state = create_distributed_train_state(
            cfg, MerlotReservePretrainer(cfg, device="cpu", seed=0), make_mesh(**axes))
        got = state.optimizer.held_bytes()
    finally:
        distributed.shutdown()
    # the port's only extra: its flat buffers' alignment padding (f32 masters, bf16 copies)
    assert got["masters"] == jax_bytes["masters"] + got["master_padding"], (got, jax_bytes)
    assert got["mu"] == jax_bytes["mu"] and got["nu"] == jax_bytes["nu"], (got, jax_bytes)
    stacked = jax_bytes["towers_stacked_tp_f32"] if cfg.model.scan_layers else 0
    assert (got["compute_copies"]
            == (jax_bytes["params_f32"] - stacked) // 2 + got["compute_padding"]), (got, jax_bytes)


def test_standin_is_refused_where_a_real_job_is_expected(tmp_path):
    from merlot_reserve_tpu_torch.ops.ring_attention import PeerRing
    from merlot_reserve_tpu_torch.training.pretrain import run_pretraining
    from merlot_reserve_tpu_torch.utils import checkpoint as ck

    cfg = _config()
    distributed.initialize_standin(2, 0, device="cpu")
    try:
        assert distributed.is_standin() and distributed.backend() == "fake"
        mesh = make_mesh(dp=2)
        state = create_distributed_train_state(
            cfg, MerlotReservePretrainer(cfg, device="cpu", seed=0), mesh)
        with pytest.raises(RuntimeError, match="stand-in"):
            run_pretraining(cfg, iter([]), num_steps=1, device="cpu", mesh=mesh)
        with pytest.raises(RuntimeError, match="stand-in"):
            ck.save_checkpoint(state, str(tmp_path / "msgpack"))
        with pytest.raises(RuntimeError, match="stand-in"):
            ck.AsyncCheckpointer().save(state, str(tmp_path / "async"))
        with pytest.raises(RuntimeError, match="stand-in"):
            ck.save_checkpoint_sharded(state, str(tmp_path / "sharded"))
        with pytest.raises(RuntimeError, match="stand-in"):
            PeerRing(make_mesh(sp=2), "sp", 1, 2, 8, torch.bfloat16, "cpu")
        # a stand-in's all_gather_object is its own object for every rank;
        # the fake group takes the ring's hop, a receive and Ulysses' exchange
        from merlot_reserve_tpu_torch.parallel import comm

        x = torch.ones(4)
        with comm.recording() as recs:
            assert comm.all_gather_object({"a": 1}, mesh, "dp") == [{"a": 1}] * 2
            comm.exchange(x, torch.empty(4), mesh, "dp", 1, 1, what="sp")
            comm.recv(torch.empty(4), mesh, "dp", 1)
            comm.all_to_all(torch.ones(2, 3), mesh, "dp")
        assert [r["op"] for r in recs] == ["all-gather-object", "send", "recv", "recv",
                                           "all-to-all"]
    finally:
        distributed.shutdown()
    assert not distributed.is_standin() and list(tmp_path.iterdir()) == []


def test_audit_script_prints_the_real_ranks_table(gloo_records, capsys):
    from merlot_reserve_tpu_torch.parallel import comm
    from scripts.audit_comm_torch import main

    main(["base", "--dp", "2", "--tp", "2", "--tiny", "--batch", str(BATCH)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = comm.summarize_records(gloo_records["dp2_tp2"][0])
    assert {k: v for k, v in printed.items() if k not in ("layout", "intra_inter")} == \
        json.loads(json.dumps(want))
    assert printed["layout"]["standin"] and printed["intra_inter"]["inter"]["count"] == 0


def _rows():
    return [json.loads(line) for line in ROWS.read_text().splitlines() if line.strip()]


def test_committed_rows_within_25pct_of_the_planner():
    """Worst error reached at commit: stated in PERF.md section 5."""
    from scripts.pod_readiness_torch import config

    rows = _rows()
    assert len(rows) >= 12
    assert {r["config"] for r in rows} == {"base", "large"}
    assert {r["remat"] for r in rows} == {True, False}
    keys = {r["layout"] for r in rows}
    assert {"dp8", "dp4xsp2", "longvideo", "dp4xtp2", "dp2pp2tp2", "dp16", "dcn16",
            "dcn16tp2", "dp64"} <= keys
    worst = 0.0
    for r in rows:
        assert r["standin"] and r["compile"] == "clean" and "H100" in r["card"], r["name"]
        assert r["power_limit"].endswith("W") and "NCCL" in r["nccl_buffers"]
        layout = readiness.LAYOUTS[r["layout"]]
        cfg = readiness.layout_config(config(r["config"], False, False, r["remat"]), layout)
        got = readiness.plan(cfg, layout, r["batch"])["total"] / 2 ** 30
        # the row carries the committed planner (fit_memory_model_torch.py --write-planner)
        assert abs(r["planner_total_gib"] - got) < 6e-4, (r["name"], r["planner_total_gib"], got)
        err = abs(got - r["measured_gib"]) / r["measured_gib"]
        worst = max(worst, err)
        assert err <= ROW_TOL, (r["name"], round(got, 2), r["measured_gib"], round(err, 3))
    print(f"worst planner error over {len(rows)} stand-in rows: {worst:.3f}")


@pytest.mark.parametrize("impl", ["gspmd", "ulysses"])
def test_planner_refuses_an_sp_family_no_row_measures(impl):
    from merlot_reserve_tpu_torch.parallel import memory

    with pytest.raises(ValueError, match="stand-in row"):
        memory.estimate_train_hbm(load_config("base"), 16, zero1_dp=4, sp=2, sp_impl=impl)


def test_planner_dcn_and_segment_sp_move_no_byte():
    from merlot_reserve_tpu_torch.parallel import memory

    cfg = load_config("base")
    for layout in (dict(zero1_dp=8), dict(zero1_dp=4, tp=2), dict()):
        plain = memory.estimate_train_hbm(cfg, 8, **layout)
        assert memory.estimate_train_hbm(cfg, 8, dcn=2, segment_sp=2, **layout) == plain
    with pytest.raises(ValueError, match="does not divide"):
        memory.estimate_train_hbm(cfg, 8, zero1_dp=8, segment_sp=3)
