"""Per-rank sharded checkpoints (``utils.checkpoint.sharded_manager``,
``save_checkpoint_sharded``, ``load_checkpoint_sharded`` on
``torch.distributed.checkpoint``) and f32 Adam under ZeRO-1, in two gloo
processes on the CPU (``tests/_torch_dist_worker.py``) at the tiny widths
of tests/test_torch_distributed.py.

Checked, bit for bit: a sharded checkpoint written at world 1, dp 2 and
tp 2, and at dp 2 with f32 Adam, reads back as the state that was saved
(f32 masters and moments, bf16 moments, each by its bits), where the
msgpack file of the same state reads back as that state with every f32
leaf through f16 (the released checkpoints' format); it resumes at
another layout (world 1 to dp 2, dp 2 to tp 2, dp 2 to one
process outside any job) as the state it was; each rank's file holds only
the shares it owns; nothing is gathered to write it; ``run_pretraining``
on two processes checkpoints so and resumes from it. f32 Adam at dp 2 under
ZeRO-1: its loss terms within 1e-4 and parameters within 5e-3 of one
process's f32-Adam step (test_torch_distributed.py's limits: bf16 gradients
summed in another order).
"""

import dataclasses
import time

import pytest
import torch
import torch.distributed.checkpoint as dcp

from merlot_reserve_tpu.data.dummy import make_dummy_batch as jax_make_dummy_batch
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer, batch_to_tensors
from merlot_reserve_tpu_torch.training.trainer import create_train_state, train_step
from merlot_reserve_tpu_torch.utils import checkpoint as ck
from test_torch_distributed import (BATCH, DATA, MODEL, METRIC_TOL, OPTIMIZER, PARAM_TOL, SPANS,
                                    _configs, _jax_draws, _launch, _port_model)

WORLD = 2
F32_ADAM = dict(use_bfloat16_adam=False, do_bias_correction=True)
LAYOUTS = {"world1": dict(dp=1), "dp2": dict(dp=2), "tp2": dict(tp=2)}
READS = {"world1": [], "dp2": ["world1"], "tp2": ["dp2"]}  # earlier cases' checkpoints


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("sharded")
    jcfg, tcfg = _configs()
    batch = jax_make_dummy_batch(jcfg, batch_size=BATCH, seed=0, num_text_spans=SPANS)
    split_at, gumbel = _jax_draws(batch, jcfg)
    start = MerlotReservePretrainer(tcfg, device="cpu", seed=0).state_dict()
    cases = {name: dict(mesh=mesh, kind="sharded_checkpoint", dir=str(tmp / name),
                        read=[str(tmp / r) for r in READS[name]])
             for name, mesh in LAYOUTS.items()}
    cases["dp2_f32_adam"] = dict(mesh=dict(dp=2), kind="sharded_checkpoint",
                                 dir=str(tmp / "dp2_f32_adam"), read=[], optimizer=F32_ADAM)
    cases["dp2_zero1_f32_adam"] = dict(mesh=dict(dp=2), optimizer=F32_ADAM)
    cases["dp2_loop"] = dict(mesh=dict(dp=2), kind="loop", dir=str(tmp / "loop"))
    job = {"model": MODEL, "data": DATA, "optimizer": OPTIMIZER, "bf16_grads": True,
           "params": start, "batch": batch, "split_at": split_at, "gumbel": gumbel,
           "cases": cases, "out": str(tmp / "out.pt")}
    torch.save(job, tmp / "job.pt")
    t0 = time.time()
    _launch(tmp / "job.pt", WORLD)
    results = torch.load(tmp / "out.pt", weights_only=False)
    results["_seconds"] = time.time() - t0
    return {"results": results, "tmp": tmp, "tcfg": tcfg, "start": start, "batch": batch,
            "split_at": split_at, "gumbel": gumbel}


def _assert_same(a, b):
    assert a["step"] == b["step"] and a["count"] == b["count"]
    for kind in ("params", "mu", "nu"):
        assert sorted(a[kind]) == sorted(b[kind])
        for name, t in a[kind].items():
            u = b[kind][name]
            bits = {4: torch.int32, 2: torch.int16}[t.element_size()]
            assert t.dtype == u.dtype and torch.equal(t.contiguous().view(bits),
                                                      u.contiguous().view(bits)), (kind, name)


def _via_f16(whole):
    """``whole`` as the msgpack file stores it: every f32 leaf through f16."""
    def cast(d):
        return {n: t.half().float() if t.dtype == torch.float32 else t for n, t in d.items()}

    return dict(whole, **{kind: cast(whole[kind]) for kind in ("params", "mu", "nu")})


@pytest.mark.parametrize("layout", sorted(LAYOUTS) + ["dp2_f32_adam"])
def test_sharded_resume_is_the_saved_state_bit_for_bit(run, layout):
    res = run["results"][layout]
    _assert_same(res["resumed"], res["saved"])
    assert res["resumed"]["step"] == 1 and res["resumed"]["count"] == 1
    moments = next(iter(res["saved"]["nu"].values())).dtype
    assert moments == (torch.float32 if layout == "dp2_f32_adam" else torch.bfloat16)
    if layout == "dp2_f32_adam":  # moments that f16 would flush to 0 come back
        assert any(((t > 0) & (t < 2.0 ** -24)).any() for t in res["saved"]["nu"].values())
    # the msgpack file, the released checkpoints' format, rounds f32 to f16
    _assert_same(res["msgpack"], _via_f16(res["saved"]))


@pytest.mark.parametrize("source,target", [("world1", "dp2"), ("dp2", "tp2")])
def test_sharded_checkpoint_resumes_at_another_layout(run, source, target):
    written = run["results"][source]["resumed"]
    read = run["results"][target]["read"][str(run["tmp"] / source)]
    _assert_same(read, written)


@pytest.mark.parametrize("source", ["dp2", "tp2"])
def test_sharded_checkpoint_resumes_in_one_process(run, source):
    """Outside any job, in a plain one-process state: the whole state, as
    the layout that wrote it reads it back."""
    tcfg = run["tcfg"]
    state = create_train_state(tcfg, _port_model(tcfg, run["start"]))
    assert ck.load_checkpoint_sharded(str(run["tmp"]), state) is None  # none directly there
    ck.load_checkpoint_sharded(str(run["tmp"] / source), state)
    opt = state.optimizer
    _assert_same({"params": dict(state.model.named_parameters()), "mu": opt.mu, "nu": opt.nu,
                  "count": opt.count, "step": state.step},
                 run["results"][source]["resumed"])
    assert ck.latest_checkpoint(str(run["tmp"] / source)) == ("sharded", 1)
    # and back out of one process: whole entries, read back the same
    out = run["tmp"] / f"{source}_one_process"
    assert ck.save_checkpoint_sharded(state, str(out)) == 1
    again = create_train_state(tcfg, _port_model(tcfg, run["start"]))
    ck.load_checkpoint_sharded(str(out), again)
    _assert_same({"params": dict(again.model.named_parameters()), "mu": again.optimizer.mu,
                  "nu": again.optimizer.nu, "count": again.optimizer.count, "step": again.step},
                 run["results"][source]["resumed"])


def _files_by_key(directory):
    meta = dcp.FileSystemReader(directory).read_metadata()
    out = {}
    for index, info in meta.storage_data.items():
        out.setdefault(index.fqn, set()).add(info.relative_path)
    return out


def test_each_rank_writes_only_its_shares(run):
    """dp 2: each rank's file holds its own ZeRO-1 shards (``#dp<rank>``)
    of params, mu and nu and nothing else but, on rank 0, the entries no
    dim of which splits; tp 2: each rank its own tp shares (``#tp<rank>``),
    rank 0 the entries that tp does not split."""
    for layout, split in (("dp2", "#dp"), ("tp2", "#tp")):
        files = _files_by_key(str(run["tmp"] / layout / "1"))
        assert all(len(f) == 1 for f in files.values())
        by_rank = {r: {k for k, f in files.items() if f == {f"__{r}_0.distcp"}}
                   for r in range(WORLD)}
        assert set().union(*by_rank.values()) == set(files)
        assert by_rank[1] and all(f"{split}1" in k for k in by_rank[1])
        assert not any(f"{split}1" in k for k in by_rank[0])
        assert any(f"{split}0" in k for k in by_rank[0])
        kinds = {k.split("/")[0] for k in files}
        assert kinds == {"params", "mu", "nu"}
    # world 1 wrote whole entries and leaves only
    files = _files_by_key(str(run["tmp"] / "world1" / "1"))
    assert not any("#" in k for k in files) and set().union(*files.values()) == {"__0_0.distcp"}


def test_f32_adam_under_zero1_matches_one_process(run):
    res = run["results"]["dp2_zero1_f32_adam"]
    tcfg = run["tcfg"]
    cfg = dataclasses.replace(tcfg, optimizer=dataclasses.replace(tcfg.optimizer, **F32_ADAM))
    state = create_train_state(cfg, _port_model(cfg, run["start"]))
    assert next(iter(state.optimizer.mu.values())).dtype == torch.float32
    state, info = train_step(state, batch_to_tensors(run["batch"], "cpu"), True,
                             run["split_at"], run["gumbel"])
    for k, v in info.items():
        assert abs(res["metrics"][k] - float(v)) < METRIC_TOL, k
    params = dict(state.model.named_parameters())
    worst = max((res["params"][n] - params[n].detach()).abs().max().item() for n in params)
    assert worst < PARAM_TOL and res["count"] == 1
    moved = max((params[n].detach() - run["start"][n]).abs().max().item() for n in params)
    assert moved > 1e-5


def test_run_pretraining_checkpoints_per_rank_and_resumes(run):
    """Two processes: ``run_pretraining`` with an ``output_dir`` writes the
    sharded ``<step>/`` directories (no ``ckpt_<step>`` file), and a second
    run resumes from the newest and logs only the step after it."""
    res = run["results"]["dp2_loop"]
    listing, logged = res["first"]
    assert listing == ["1", "2", "run"] and logged == [0, 1]
    listing, logged = res["second"]
    assert listing == ["1", "2", "3", "run"] and logged == [2]
    assert res["step"] == 3 and res["count"] == 3
    assert ck.latest_checkpoint(str(run["tmp"] / "loop")) == ("sharded", 3)
