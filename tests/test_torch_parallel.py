"""Port parity, one process: the sharding rules (parallel/sharding.py)
against the JAX package's on the same tree and mesh shapes, the batch
helpers, the parameter count and the memory planner (parallel/memory.py),
the collective recorder (parallel/comm.py) and the launcher
(utils/launch.py).

Tolerances: the specs equal JAX's entry for entry; ``param_count`` equals
the port model's count and the JAX model tree's exactly, and the JAX
package's own ``param_count`` (a coarse estimate, its docstring) within
2%; the planner within 3% of each of the five peaks it is fit on (it fits
all five within 2.1%, PERF.md).
"""

import json
import socket

import jax
import numpy as np
import pytest
import torch

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data.dummy import make_dummy_batch as jax_make_dummy_batch
from merlot_reserve_tpu.models import MerlotReservePretrainer as JaxPretrainer
from merlot_reserve_tpu.parallel import make_mesh as jax_make_mesh
from merlot_reserve_tpu.parallel import memory as jax_memory
from merlot_reserve_tpu.parallel import sharding as jax_sharding
from merlot_reserve_tpu.training.optimization import construct_train_state
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer
from merlot_reserve_tpu_torch.parallel import comm, distributed, memory, sharding
from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh, make_mesh
from merlot_reserve_tpu_torch.utils.launch import TorchrunLauncher

TINY = dict(hidden_size=64, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, size_per_head=32, output_grid=(4, 4), use_bfloat16=False)
DATA = dict(num_segments=4, num_segment_groups=2, seq_len=80, lang_seq_len=40,
            num_text_spans_to_include=8)
MESHES = {"dp4": dict(dp=4), "dp2_tp2": dict(dp=2, tp=2), "dp2_pp2": dict(dp=2, pp=2),
          "dp2_tp2_pp2": dict(dp=2, tp=2, pp=2)}


@pytest.fixture(scope="module")
def jax_state():
    cfg = mr.load_config("base", **TINY).replace_data(**DATA)
    model = JaxPretrainer.from_config(cfg)
    batch = jax_make_dummy_batch(cfg, batch_size=2, seed=0, num_text_spans=16)
    return construct_train_state(cfg.optimizer, model, model.init_params(batch))


@pytest.fixture(scope="module")
def port_model():
    return MerlotReservePretrainer(load_config("base", **TINY).replace_data(**DATA),
                                   device="meta")


def _specs(tree):
    paths, leaves, _ = jax_sharding._tree_paths(tree)
    return {p: tuple(s.spec) for p, s in zip(paths, leaves)}


@pytest.mark.parametrize("zero1", [True, False])
@pytest.mark.parametrize("layout", sorted(MESHES))
def test_specs_match_jax(jax_state, port_model, cpu_devices, layout, zero1):
    axes = MESHES[layout]
    n = int(np.prod(list(axes.values())))
    jmesh = jax_make_mesh(devices=cpu_devices[:n], **axes)
    mesh = make_mesh(devices=["cpu"] * n, **axes)
    j_params = _specs(jax_sharding.param_shardings(jmesh, jax_state.params, zero1_dp=zero1))
    assert sharding.param_shardings(mesh, port_model, zero1_dp=zero1) == j_params
    j_opt = jax_sharding.opt_state_shardings(jmesh, jax_state.opt_state, zero1=zero1)
    port_opt = sharding.opt_state_shardings(mesh, port_model, zero1=zero1)
    assert port_opt["mu"] == _specs(j_opt[0].mu) and port_opt["nu"] == _specs(j_opt[0].nu)
    j_state = jax_sharding.state_shardings(jmesh, jax_state, zero1=zero1)
    port_state = sharding.state_shardings(mesh, port_model, zero1=zero1)
    assert port_state["params"] == _specs(j_state.params)
    assert port_state["opt_state"]["mu"] == _specs(j_state.opt_state[0].mu)
    assert port_state["step"] == tuple(j_state.step.spec)
    # something is split in every layout
    assert any(s for s in j_params.values()) or not zero1


def test_layout_reads_the_tp_rule_per_layer(port_model):
    """Under the scan layout without pp the JAX rules match the per-layer
    patterns against the stacked leaf; the port's layout takes Megatron's
    split per layer there, as the JAX rules do under pp."""
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    plan = sharding.ShardPlan.build(mesh, port_model, zero1=True)
    jax_rule = sharding.param_shardings(mesh, port_model, zero1_dp=True)
    qkv = "joint_transformer/layers/attention_layer/qkv/kernel"
    out = "joint_transformer/layers/mlp_layer/out/kernel"
    # JAX's rule leaves the stacked qkv to ZeRO-1 (its layer axis over dp)
    assert jax_rule[qkv] == ("dp", None, None, None)
    assert plan.specs[qkv] == (None, None, "tp", None)
    assert jax_rule[out] == ("tp", None) and plan.specs[out] == (None, "tp", None)
    name = "joint_transformer.layers.1.attention_layer.qkv.weight"
    assert plan.tp_kind[name] == "qkv"
    assert plan.tp_kind["token_encoder.Embed_0.weight"] == "vocab"


def test_plan_slices_and_joins_back(port_model):
    """Every tp share joins back to the whole tensor, and every ZeRO-1 leaf
    maps to its entries and back, bit for bit."""
    model = MerlotReservePretrainer(load_config("base", **TINY).replace_data(**DATA),
                                    device="cpu", seed=1)
    named = {n: p.detach() for n, p in model.named_parameters()}
    for tp in (2,):
        mesh = make_mesh(dp=2, tp=tp, devices=["cpu"] * 2 * tp)
        plan = sharding.ShardPlan.build(mesh, model, zero1=True)
        split = [n for n, k in plan.tp_kind.items() if k]
        assert len(split) == 4 * 8 + 1  # 4 kernels x 8 layers, and the vocabulary
        for n in split:
            parts = [plan.tp_slice(n, named[n], i, tp) for i in range(tp)]
            assert torch.equal(plan.tp_join(n, parts), named[n]), n
        q = plan.tp_slice("joint_transformer.layers.0.attention_layer.qkv.weight",
                          named["joint_transformer.layers.0.attention_layer.qkv.weight"], 1, tp)
        assert q.shape == (3 * 32, 64)  # head 1 of each of q, k and v
    mesh = make_mesh(dp=2, devices=["cpu"] * 2)
    plan = sharding.ShardPlan.build(mesh, model, zero1=True)
    assert plan.zero_leaves()
    for path in plan.zero_leaves():
        back = plan.leaf_entries(path, plan.leaf_tensor(path, named))
        assert all(torch.equal(back[n], named[n]) for n in plan.leaves[path].names)
        assert plan.leaf_tensor(path, named).shape[0] % 2 == 0


def test_form_global_batch_with_one_process():
    batch = {"a": torch.arange(6).reshape(3, 2), "b": np.zeros((3, 4))}
    assert sharding.form_global_batch(None, batch) is batch
    mesh = make_mesh(dp=2, devices=["cpu"] * 2)  # virtual ranks: one process
    assert sharding.form_global_batch(mesh, batch) is batch
    assert sharding.data_shard(mesh) == (0, 1) == sharding.data_shard(None)
    local = sharding.local_rows(mesh, batch)
    assert local.keys() == batch.keys() and all(local[k] is batch[k] for k in batch)


@pytest.mark.parametrize("name", ["base", "large", "tiny"])
def test_param_count_matches_the_models(name, jax_state):
    cfg = load_config("base", **TINY) if name == "tiny" else load_config(name)
    model = MerlotReservePretrainer(cfg, device="meta")
    assert memory.param_count(cfg) == sum(p.numel() for p in model.parameters())
    if name == "tiny":
        leaves = jax.tree_util.tree_leaves(jax_state.params)
        assert memory.param_count(cfg) == sum(int(np.prod(x.shape)) for x in leaves)
    else:
        approx = jax_memory.param_count(mr.load_config(name))
        assert abs(approx - memory.param_count(cfg)) / memory.param_count(cfg) < 0.02


def test_planner_against_the_measured_peaks():
    errors = memory.fit_errors()
    assert set(errors) == set(memory.MEASURED_PEAKS)
    assert all(abs(e) < 0.03 for e in errors.values()), errors


def test_planner_knobs_are_monotone():
    cfg = load_config("base")
    est = memory.estimate_train_hbm
    base = est(cfg, 8)["total"]
    assert est(cfg, 4)["total"] < base < est(cfg, 16)["total"]
    assert est(cfg, 8, remat=True, tower_remat=True)["total"] < base
    assert est(cfg, 8, flash=False)["total"] > base
    split = est(cfg, 8, zero1_dp=2)
    assert est(cfg, 8, zero1_dp=8)["state_bytes"] < split["state_bytes"]
    assert est(cfg, 8, zero1_dp=8)["activation_bytes"] == split["activation_bytes"]
    assert est(cfg, 8, tp=4)["state_bytes"] < est(cfg, 8, tp=2)["state_bytes"]
    assert est(cfg, 8, pp=4)["total"] < est(cfg, 8, pp=2)["total"]
    assert est(cfg, 8, sp=4)["activation_bytes"] < est(cfg, 8, sp=2)["activation_bytes"]
    assert memory.fits_h100(cfg, 8) and not memory.fits_h100(cfg, 32)
    assert memory.fits_h100(cfg, 32, hbm_bytes=1e15)


def test_plan_memory_script(capsys):
    from scripts.plan_memory_torch import main

    main(["base", "--batch", "8", "16", "--calibration"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["batch"] for x in lines[:2]] == [8, 16]
    assert lines[0]["fits"] and lines[0]["params"] == memory.param_count(load_config("base"))
    assert [x["point"] for x in lines[2:]] == list(memory.MEASURED_PEAKS)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_comm_recorder_counts_a_hand_made_step(monkeypatch):
    """A job of one gloo process: make_mesh() is a process mesh of one rank,
    and every collective of a hand-made step is recorded with its op,
    dtype, bytes, axis, what and ranks."""
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.initialize(device="cpu") == torch.device("cpu")
    try:
        assert distributed.backend() == "gloo"
        mesh = make_mesh()
        assert mesh.is_process_mesh and mesh.coords == (0, 0, 0, 0, 0)
        assert mesh.group_ranks("dp") == [0] and mesh.size(("dcn", "dp")) == 1
        w = torch.ones(4, 3, requires_grad=True)

        def step():
            with activate_mesh(mesh):
                rows = comm.gather_rows(w * 2.0, mesh, ("dcn", "dp"), what="loss")
                loss = comm.reduce_from_parallel(rows.sum(), mesh, "tp")
                g, = torch.autograd.grad(loss, [w])
                comm.all_reduce(g.to(torch.bfloat16), mesh, "dp", what="grads")
                comm.all_gather(torch.zeros(5, dtype=torch.int32), mesh, "sp", what="sp")

        records = comm.collective_records(step)
        ops = [(r["op"], r["dtype"], r["bytes"], r["axis"], r["what"]) for r in records]
        assert ops == [("all-gather", "float32", 48, "dcn+dp", "loss"),
                       ("all-reduce", "float32", 4, "tp", "tp"),
                       ("reduce-scatter", "float32", 48, "dcn+dp", "loss"),
                       ("all-reduce", "bfloat16", 24, "dp", "grads"),
                       ("all-gather", "int32", 20, "sp", "sp")]
        assert all(r["ranks"] == [0] for r in records)
        summary = comm.summarize_records(records)
        assert summary["all-reduce"]["count"] == 2 and summary["total_count"] == 5
        assert summary["all-gather"]["what_bytes"] == {"loss": 48, "sp": 20}
        assert summary["total_bytes"] == 48 + 4 + 48 + 24 + 20
        assert comm.split_intra_inter(records) == {"intra": {"count": 5, "bytes": 144},
                                                   "inter": {"count": 0, "bytes": 0}}
        assert comm.collective_summary(step)["total_count"] == 5
        # nothing is recorded outside a recorder
        step()
        assert comm._RECORDS is None
    finally:
        distributed.shutdown()
    assert distributed.process_count() == 1


def test_split_intra_inter_by_node():
    records = [{"op": "all-reduce", "bytes": 8, "ranks": [0, 1]},
               {"op": "all-reduce", "bytes": 4, "ranks": [1, 2]},
               {"op": "send", "bytes": 2, "ranks": [3, 2]}]
    assert comm.split_intra_inter(records, local_world_size=2) == {
        "intra": {"count": 2, "bytes": 10}, "inter": {"count": 1, "bytes": 4}}


def test_initialize_needs_torchrun_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed.initialize(device="cpu")
    assert not distributed.is_initialized()


def test_torchrun_commands_dry_run():
    one = TorchrunLauncher(nproc_per_node=8, dry_run=True)
    cmd = one.pretrain_command("configs/base.yaml", output_dir="out")
    assert cmd[1:] == ["-m", "torch.distributed.run", "--nproc_per_node=8", "--nnodes=1",
                       "--standalone", "scripts/pretrain_torch.py", "configs/base.yaml",
                       "-distributed", "-output_dir", "out"]
    two = TorchrunLauncher(nproc_per_node=8, nnodes=2, rdzv_endpoint="node0:29500",
                           dry_run=True)
    nodes = two.node_commands("configs/base.yaml", "out", ["-num_steps", "10"])
    assert len(nodes) == 2 and "--node_rank=1" in nodes[1]
    assert all("--rdzv_endpoint=node0:29500" in c and "--rdzv_backend=c10d" in c for c in nodes)
    assert nodes[0].endswith("-distributed -output_dir out -num_steps 10")
    assert two.launch_training("configs/base.yaml", "out", node_rank=0) == 0
    assert two.issued_commands == [nodes[0].replace(" -num_steps 10", "")]


def test_planner_divides_state_under_zero1_only_off_tp_and_pp():
    """ZeRO-1 divides only the entries without a tp or pp share, as the
    sharding rules' precedence says."""
    cfg = load_config("base")
    tp = memory.estimate_train_hbm(cfg, 8, tp=2)["state_bytes"]
    tp_zero = memory.estimate_train_hbm(cfg, 8, tp=2, zero1_dp=4)["state_bytes"]
    plain = memory.estimate_train_hbm(cfg, 8, zero1_dp=4)["state_bytes"]
    assert tp_zero < tp and plain < memory.estimate_train_hbm(cfg, 8, zero1_dp=2)["state_bytes"]


def test_row_shard_draws_are_the_global_batchs_rows():
    """Under a process mesh each data-parallel rank's device-builder draws
    are its rows of the global batch's: every kind of draw."""
    from merlot_reserve_tpu_torch.data.device_builder import BuilderDraws, RowShardDraws

    logits = torch.log(torch.tensor([0.2, 0.3, 0.5]))
    high = torch.tensor([[3, 5, 1, 2]] * 2)
    draws = [lambda d, b: d.uniform("u", (b, 4), -1.0, 1.0),
             lambda d, b: d.gumbel("g", (b, 5)),
             lambda d, b: d.permutation("p", (b, 6)),
             lambda d, b: d.categorical("c", logits, (b, 3)),
             lambda d, b: d.randint("r", high if b == 2 else torch.cat([high, high]))]
    whole = BuilderDraws(7, 3, "cpu")
    ranks = [RowShardDraws(7, 3, "cpu", i, 2) for i in range(2)]
    for draw in draws:
        assert torch.equal(torch.cat([draw(r, 2) for r in ranks]), draw(whole, 4))
