"""Port parity across processes: the distributed training step
(``training.trainer.create_distributed_train_state`` on a process mesh of
``parallel.distributed``) in four gloo processes on the CPU, against the
JAX package's single-device ``train_step`` on the same global batch and
weights, at the tiny widths of ``tests/test_distributed_equivalence.py``
(hidden 64, 2 layers per tower, seq_len 80, f32 compute, bf16 gradients).

The workers (``tests/_torch_dist_worker.py``, started with torchrun's
environment, one torch thread each) import no JAX: the parent runs JAX's
step once, with the draws (``split_at``, ``gumbel``) that the port is
handed too, and compares.

Tolerances, as JAX's own equivalence tests hold its layouts: every loss
term within 1e-4 of JAX's, every parameter after one step within 5e-3
(bf16 gradients summed in another order). Checkpoints: bit for bit (f32
parameters after the f16 round trip of the file, bf16 moments by their
bits). The zero-shot evaluation: metrics and rows equal.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data.dummy import make_dummy_batch as jax_make_dummy_batch
from merlot_reserve_tpu.models import MerlotReservePretrainer as JaxPretrainer
from merlot_reserve_tpu.training import optimization as jopt
from merlot_reserve_tpu.training.trainer import train_step as jax_train_step
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_finetune_corpus
from merlot_reserve_tpu_torch.finetune import models as heads
from merlot_reserve_tpu_torch.finetune.data import finetune_batches
from merlot_reserve_tpu_torch.models.model import MerlotReserve
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer, batch_to_tensors
from merlot_reserve_tpu_torch.parallel.memory import param_count
from merlot_reserve_tpu_torch.training.trainer import create_train_state, train_step
from merlot_reserve_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from merlot_reserve_tpu_torch.utils.weights import flax_from_state_dict, state_dict_from_flax
from merlot_reserve_tpu_torch.zero_shot import zero_shot_qa_eval

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "_torch_dist_worker.py"
WORLD = 4
BATCH, SPANS = 4, 16
MODEL = dict(hidden_size=64, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
             span_num_layers=2, size_per_head=32, output_grid=(4, 4), use_bfloat16=False)
DATA = dict(num_segments=4, num_segment_groups=2, seq_len=80, lang_seq_len=40,
            num_text_spans_to_include=8)
OPTIMIZER = dict(num_warmup_steps=0)  # the first update moves the weights
METRIC_TOL, PARAM_TOL = 1e-4, 5e-3
ZERO_SHOT = dict(model=dict(MODEL), data=dict(lang_seq_len=48, num_segments=7), task="vcr",
                 batch=2, temperature=10.0)

PIPELINE = dict(pipeline_axis="pp", pipeline_microbatches=2)
LAYOUTS = {
    "dp2": dict(mesh=dict(dp=2), zero1=False),
    "dp4_zero1": dict(mesh=dict(dp=4)),
    "dp2_tp2": dict(mesh=dict(dp=2, tp=2)),
    "dp2_sp2_ring_flash": dict(mesh=dict(dp=2, sp=2),
                               model=dict(joint_attention_impl="ring:flash")),
    "dp2_sp2_ulysses": dict(mesh=dict(dp=2, sp=2), model=dict(joint_attention_impl="ulysses")),
    "dp2_pp2": dict(mesh=dict(dp=2, pp=2), model=PIPELINE),
}
AUDITS = {
    "dp2_zero1": dict(mesh=dict(dp=2)),
    "sp2_ring_flash_forward": dict(mesh=dict(sp=2), kind="forward_audit",
                                   model=dict(joint_attention_impl="ring:flash")),
    "sp2_ulysses_forward": dict(mesh=dict(sp=2), kind="forward_audit",
                                model=dict(joint_attention_impl="ulysses")),
    "sp2_ring_rdma": dict(mesh=dict(sp=2), kind="rdma_forward",
                          model=dict(joint_attention_impl="ring:rdma")),
}


def _configs(**model):
    jcfg = mr.load_config("base", **MODEL).replace_data(**DATA)
    tcfg = load_config("base", **MODEL).replace_data(**DATA)
    return [dataclasses.replace(c, optimizer=dataclasses.replace(c.optimizer, **OPTIMIZER),
                                model=dataclasses.replace(c.model, **model))
            for c in (jcfg, tcfg)]


def _jax_draws(batch, cfg):
    """JAX's draws for ``batch`` from its content keys: (split_at for the
    audio2text and text2audio streams, gumbel), global."""
    data = cfg.data
    towers = {"flat": {"audio2text/text_ptr": jnp.asarray(batch["audio2text/text_ptr"])}}
    keys = JaxPretrainer.content_keys(None, towers)
    spg = data.num_segments_per_group
    probs = np.array([0.1 / (spg - 1)] * (spg - 1) + [0.9])
    split_at = [torch.tensor(np.asarray(1 + jax.random.choice(
        keys[i], a=spg, shape=[BATCH * data.num_segment_groups], p=probs))) for i in (0, 1)]
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(key=keys[2], shape=[BATCH, SPANS],
                                                  dtype=jnp.float32, minval=0.0, maxval=1.0)))
    return split_at, torch.tensor(np.asarray(gumbel))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(job_path: Path, world: int, timeout: float = 300.0):
    """Start ``world`` workers as torchrun would, wait for all of them."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen([sys.executable, str(WORKER), str(job_path)], env=env,
                                      cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.time(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, "\n".join(o[-3000:] for o in outs)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's single-device step, the one-process references, and every
    case of the job run once in four gloo workers."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("dist")
    jcfg, tcfg = _configs()
    batch = jax_make_dummy_batch(jcfg, batch_size=BATCH, seed=0, num_text_spans=SPANS)
    params = jax.tree.map(np.asarray, JaxPretrainer.from_config(jcfg).init_params(batch))
    j_state = jopt.construct_train_state(jcfg.optimizer, JaxPretrainer.from_config(jcfg),
                                         params)
    j_state, j_info = jax.jit(jax_train_step, static_argnums=2)(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()}, True)
    jax_ref = ({k: float(v) for k, v in j_info.items()},
               state_dict_from_flax(jax.tree.map(np.asarray, j_state.params)))
    split_at, gumbel = _jax_draws(batch, jcfg)
    start = state_dict_from_flax(params)

    # the one-process port: a checkpoint after one step
    one = create_train_state(tcfg, _port_model(tcfg, start))
    one, _ = train_step(one, batch_to_tensors(batch, "cpu"), True, split_at, gumbel)
    save_checkpoint(one, str(tmp / "one_process"))

    # zero-shot: records, a pretrained tree, one process's evaluation
    zcfg = load_config("base", **ZERO_SHOT["model"]).replace_data(**ZERO_SHOT["data"])
    records = write_synthetic_finetune_corpus(str(tmp / "zs.tfrecord"), zcfg, ZERO_SHOT["task"],
                                              num_records=5, seed=2)
    pretrained = MerlotReserve(zcfg, device="cpu", seed=3).state_dict()
    zs_batches = finetune_batches([records], zcfg, f"{ZERO_SHOT['task']}_zero_shot",
                                  ZERO_SHOT["batch"], is_training=False, repeat=False,
                                  return_ids=True)
    zs_one = zero_shot_qa_eval(heads.MerlotReserveVCRZeroShot(zcfg, device="cpu"),
                               flax_from_state_dict(pretrained, MODEL["size_per_head"]),
                               zs_batches, ZERO_SHOT["task"], temperature=ZERO_SHOT["temperature"])

    cases = dict(LAYOUTS, **AUDITS)
    cases["ckpt_dp2"] = dict(mesh=dict(dp=2), kind="checkpoint", dir=str(tmp / "dp2"),
                             one_process_dir=str(tmp / "one_process"))
    cases["zero_shot_dp2"] = dict(mesh=dict(dp=2), kind="zero_shot")
    job = {"model": MODEL, "data": DATA, "optimizer": OPTIMIZER, "bf16_grads": True,
           "params": start, "batch": batch, "split_at": split_at, "gumbel": gumbel,
           "cases": cases, "out": str(tmp / "out.pt"),
           "zero_shot": dict(ZERO_SHOT, records=records, params=pretrained)}
    torch.save(job, tmp / "job.pt")
    t0 = time.time()
    _launch(tmp / "job.pt", WORLD)
    results = torch.load(tmp / "out.pt", weights_only=False)
    results["_seconds"] = time.time() - t0
    return {"jax": jax_ref, "results": results, "tmp": tmp, "tcfg": tcfg, "start": start,
            "zero_shot_one": zs_one}


def _port_model(cfg, state_dict):
    model = MerlotReservePretrainer(cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model


def _grads(summary, what):
    """{op: (count, dtypes)} of the records that move ``what``."""
    return {op: (v["what"].get(what, 0), v["dtypes"]) for op, v in summary.items()
            if isinstance(v, dict) and v["what"].get(what, 0)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_matches_jax_single_device(run, layout):
    metrics, params = run["jax"]
    res = run["results"][layout]
    for k, v in metrics.items():
        assert abs(res["metrics"][k] - v) < METRIC_TOL, (k, res["metrics"][k], v)
    assert sorted(res["params"]) == sorted(params)
    worst = max((res["params"][n] - params[n]).abs().max().item() for n in params)
    assert worst < PARAM_TOL, worst
    # the step moved the weights (warmup 0), and the update ran once
    assert max((res["params"][n] - run["start"][n]).abs().max().item() for n in params) > 1e-5
    assert res["count"] == 1


@pytest.mark.parametrize("layout", ["dp2_pp2", "dp2_sp2_ring_flash", "dp2_sp2_ulysses"])
def test_replicas_over_sp_and_pp_stay_equal(run, layout):
    """The entries that every sp rank or pp stage holds (the towers and
    heads; outside the split encoder) keep equal masters and moments, bit
    for bit, after one step and after two: each takes the first rank's
    reduced gradient."""
    for shared, unequal in run["results"][layout]["replicas"]:
        assert shared > 0 and unequal == [], (shared, unequal)


def test_comm_audit_dp_moves_the_gradient_reduce_and_nothing_more(run):
    """dp without ZeRO-1: the parameters' traffic is one all-reduce of the
    bf16 gradients over dp, two bytes a parameter; no parameter is
    gathered. The rest is the loss's (the targets, the draws, the metrics)."""
    summary = run["results"]["dp2"]["comm"]
    assert _grads(summary, "grads") == {"all-reduce": (1, summary["all-reduce"]["dtypes"])}
    assert summary["all-reduce"]["dtypes"].get("bfloat16") == 1
    assert summary["all-reduce"]["what_bytes"]["grads"] == 2 * param_count(run["tcfg"])
    assert _grads(summary, "params") == {}
    assert "all-to-all" not in summary and "send" not in summary
    assert set(summary["all-gather"]["what"]) <= {"loss", "draws"}


def test_comm_audit_zero1_adds_one_bf16_param_all_gather(run):
    plain, zero = run["results"]["dp2"]["comm"], run["results"]["dp2_zero1"]["comm"]
    assert _grads(plain, "params") == {}
    assert zero["all-gather"]["what"]["params"] == 1
    # in this f32-compute model the only bf16 tensors moved are the casts
    assert zero["all-gather"]["dtypes"]["bfloat16"] == 1
    params_gathers = [1 for op, v in zero.items() if isinstance(v, dict)
                      for w, n in v["what"].items() if w == "params"]
    assert params_gathers == [1]
    # the gradients move once each way: one bf16 reduce-scatter onto the
    # shards, one bf16 all-reduce of the entries no dim of which divides
    assert zero["reduce-scatter"]["what"]["grads"] == 1
    assert zero["all-reduce"]["what"]["grads"] == 1
    # the masters' and moments' bytes per rank fall with dp
    nbytes = {k: run["results"][k]["state_bytes"] for k in ("dp2", "dp2_zero1", "dp4_zero1")}
    assert nbytes["dp4_zero1"] < nbytes["dp2_zero1"] < 0.55 * nbytes["dp2"]
    assert nbytes["dp4_zero1"] < 0.3 * nbytes["dp2"]


def test_comm_audit_ring_sends_n_minus_one_per_layer(run):
    """A ring of n ranks: n - 1 sends of K/V per joint layer in the forward
    and no all-to-all; the training step's backward walks the ring again
    (n hops of the dk/dv accumulators, n - 1 of K/V)."""
    n, layers = 2, MODEL["joint_num_layers"]
    fwd = run["results"]["sp2_ring_flash_forward"]["comm"]
    assert fwd["send"]["count"] == (n - 1) * layers == fwd["send"]["what"]["sp"]
    assert "all-to-all" not in fwd
    step = run["results"]["dp2_sp2_ring_flash"]["comm"]
    assert step["send"]["what"]["sp"] == ((n - 1) + n + (n - 1)) * layers
    assert "all-to-all" not in step


def test_comm_audit_ulysses_trades_by_all_to_all_and_sends_nothing(run):
    layers = MODEL["joint_num_layers"]
    fwd = run["results"]["sp2_ulysses_forward"]["comm"]
    assert fwd["all-to-all"]["count"] == 4 * layers  # q, k, v in, the output back
    assert "send" not in fwd
    step = run["results"]["dp2_sp2_ulysses"]["comm"]
    assert step["all-to-all"]["count"] == 8 * layers and "send" not in step


def test_ring_rdma_across_processes_runs_forward_and_refuses_grad(run):
    """ring:rdma runs the forward across processes (on the CPU its plain
    version, the lax ring); under grad it refuses and names the ring that
    trains, whose backward the forward-only kernel lacks."""
    res = run["results"]["sp2_ring_rdma"]
    assert res["losses"] and all(np.isfinite(v) for v in res["losses"].values())
    refused = res["refused"]
    assert refused and "forward-only" in refused and "ring:flash" in refused


def _one_process_state(run):
    tcfg = run["tcfg"]
    return create_train_state(tcfg, _port_model(tcfg, run["start"]))


def _assert_same_state(whole, state, step):
    opt = state.optimizer
    assert whole["step"] == state.step == step and whole["count"] == opt.count
    for name, p in state.model.named_parameters():
        assert torch.equal(whole["params"][name].view(torch.int32),
                           p.detach().view(torch.int32)), name
        for moment in ("mu", "nu"):
            got = whole[moment][name].view(torch.int16)
            assert torch.equal(got, getattr(opt, moment)[name].view(torch.int16)), (moment, name)


def test_checkpoint_written_at_dp2_resumes_on_one_process_bit_for_bit(run):
    """The dp2 state written after one step, read back by one process,
    equals it as dp2 reads it back: f32 parameters (after the file's f16
    round trip) and bf16 moments bit for bit, count and step."""
    res = run["results"]["ckpt_dp2"]
    assert Path(res["file"]).name == "ckpt_1"
    state = load_checkpoint(str(run["tmp"] / "dp2"), state=_one_process_state(run))
    _assert_same_state(res["resumed"], state, 1)


def test_one_process_checkpoint_resumes_at_dp2_bit_for_bit(run):
    res = run["results"]["ckpt_dp2"]
    state = load_checkpoint(str(run["tmp"] / "one_process"), state=_one_process_state(run))
    _assert_same_state(res["from_one_process"], state, 1)


def test_zero_shot_qa_eval_at_dp2_counts_as_one_process(run):
    res = run["results"]["zero_shot_dp2"]
    metrics, rows = run["zero_shot_one"]
    assert res["metrics"] == metrics and res["rows"] == rows
    assert metrics["n"] == 5  # 3 batches of 2: the last one's 'pad' row, rank 1's, skipped
    assert res["comm"]["all-gather-object"]["count"] == 1
