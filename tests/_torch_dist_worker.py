"""One rank of the port's multi-process CPU tests (tests/test_torch_distributed.py).

Started as a plain process with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT); joins the job over
gloo through ``parallel.distributed.initialize(device="cpu")`` and runs the
cases of the job file given as its argument (a ``torch.save``d dict), each
on a process mesh over the first ranks of the job. Rank 0 writes every
case's result to the file's ``out`` path. Imports torch and the port only.
A case is a train step (the default), a forward's collectives
(``forward_audit``), a checkpoint round trip (``checkpoint``), a per-rank
sharded checkpoint round trip (``sharded_checkpoint``), ``run_pretraining``
saving and resuming per rank (``loop``), a zero-shot
evaluation (``zero_shot``), ``ring:rdma``'s forward and its refusal under
grad (``rdma_forward``), sequence-parallel attention on this rank's shard
(``sp_attention``), a transformer encoder's forward (``encoder``) or every
rank's collective records of one train step (``records``).

    python tests/_torch_dist_worker.py JOB.pt
"""

import dataclasses
import hashlib
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from merlot_reserve_tpu_torch import load_config  # noqa: E402
from merlot_reserve_tpu_torch.models.pretrainer import (  # noqa: E402
    MerlotReservePretrainer,
    batch_to_tensors,
    loss_fn_given_preds,
)
from merlot_reserve_tpu_torch.parallel import comm, distributed  # noqa: E402
from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh, make_mesh  # noqa: E402
from merlot_reserve_tpu_torch.parallel.sharding import local_rows  # noqa: E402
from merlot_reserve_tpu_torch.training.trainer import (  # noqa: E402
    create_distributed_train_state,
    train_step,
)


def make_config(job, model_overrides, optimizer_overrides=None):
    cfg = load_config("base", **job["model"]).replace_data(**job["data"])
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model_overrides))
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, **dict(job["optimizer"], **(optimizer_overrides or {}))))


def full_model(cfg, state_dict):
    model = MerlotReservePretrainer(cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model


def run_step(job, case, mesh):
    """One distributed train step of ``case`` -> (metrics, whole params,
    comm summary, update count, this rank's state bytes, the replicas'
    verdict after it and after a second step)."""
    cfg = make_config(job, case.get("model", {}), case.get("optimizer"))
    state = create_distributed_train_state(cfg, full_model(cfg, job["params"]), mesh,
                                           zero1=case.get("zero1", True),
                                           use_bfloat16_grads=job["bf16_grads"])
    batch = local_rows(mesh, batch_to_tensors(job["batch"], "cpu"))
    with activate_mesh(mesh), comm.recording() as records:
        state, info = train_step(state, batch, job["bf16_grads"], job["split_at"], job["gumbel"])
    summary = comm.summarize_records(records)
    whole = state.optimizer.full_state()
    out = ({k: float(v) for k, v in info.items()}, whole["params"], summary,
           state.optimizer.inner.count, state_bytes(state))
    replicas = [replicas_unequal(state, mesh)]
    with activate_mesh(mesh):
        state, _ = train_step(state, batch, job["bf16_grads"], job["split_at"], job["gumbel"])
    replicas.append(replicas_unequal(state, mesh))
    return out + (replicas,)


def replicas_unequal(state, mesh):
    """Over sp and pp: (the number of masters this rank shares with the
    other ranks of its line, the keys among them whose f32 master, mu or nu
    differs from another rank's in any bit), gathered from every rank."""
    inner = state.optimizer.inner
    digest = {k: hashlib.sha1(b"".join(
        d[k].detach().contiguous().view(torch.int16 if d[k].element_size() == 2
                                        else torch.int32).numpy().tobytes()
        for d in (inner.params, inner.mu, inner.nu))).hexdigest() for k in inner.params}
    shared, unequal = 0, []
    for axis in ("sp", "pp"):
        if mesh.shape.get(axis, 1) == 1:
            continue
        lines = [None] * mesh.shape[axis]
        torch.distributed.all_gather_object(lines, digest, group=mesh.group(axis))
        keys = set.intersection(*[set(x) for x in lines])
        shared += len(keys)
        unequal += sorted(k for k in keys if len({x[k] for x in lines}) > 1)
    every = [None] * mesh.size(mesh.axis_names)
    torch.distributed.all_gather_object(every, (shared, unequal),
                                        group=mesh.group(mesh.axis_names))
    return min(n for n, _ in every), sorted({k for _, u in every for k in u})


def state_bytes(state):
    """Bytes of this rank's f32 masters and bf16 moments."""
    inner = state.optimizer.inner
    return sum(t.numel() * t.element_size()
               for d in (inner.params, inner.mu, inner.nu) for t in d.values())


def records(job, case, mesh):
    """Every rank's collective records of one train step, in rank order
    (gathered to each rank)."""
    cfg = make_config(job, case.get("model", {}))
    state = create_distributed_train_state(cfg, full_model(cfg, job["params"]), mesh,
                                           zero1=case.get("zero1", True),
                                           use_bfloat16_grads=job["bf16_grads"])
    batch = local_rows(mesh, batch_to_tensors(job["batch"], "cpu"))
    with activate_mesh(mesh), comm.recording() as recs:
        train_step(state, batch, job["bf16_grads"], job["split_at"], job["gumbel"])
    every = [None] * mesh.size(mesh.axis_names)
    torch.distributed.all_gather_object(every, list(recs), group=mesh.group(mesh.axis_names))
    return {"records": every}


def forward_audit(job, case, mesh):
    """The collectives of one forward (no grad) of the full model on this
    rank's rows."""
    cfg = make_config(job, case.get("model", {}))
    model = full_model(cfg, job["params"])
    batch = local_rows(mesh, batch_to_tensors(job["batch"], "cpu"))
    with torch.no_grad(), activate_mesh(mesh), comm.recording() as records:
        model(batch, split_at=job["split_at"], gumbel=job["gumbel"])
    return {"comm": comm.summarize_records(records)}


def rdma_forward(job, case, mesh):
    """The full model's forward under ``ring:rdma`` without grad (its
    losses), and the message of its refusal under grad."""
    cfg = make_config(job, case.get("model", {}))
    model = full_model(cfg, job["params"])
    batch = local_rows(mesh, batch_to_tensors(job["batch"], "cpu"))
    with torch.no_grad(), activate_mesh(mesh):
        preds = model(batch, split_at=job["split_at"], gumbel=job["gumbel"])
        _, losses = loss_fn_given_preds(preds)
    out = {"losses": {k: float(v) for k, v in losses.items()}, "refused": None}
    try:
        with activate_mesh(mesh):
            model(batch, split_at=job["split_at"], gumbel=job["gumbel"])
    except NotImplementedError as e:
        out["refused"] = str(e)
    return out


def _rank_rows(x, mesh, axis):
    """This rank's rows (dim 1) of a global [B, L, ...] tensor along ``axis``."""
    n, r = mesh.size(axis), mesh.axis_index(axis)
    lloc = x.shape[1] // n
    return x[:, r * lloc:(r + 1) * lloc].contiguous()


def sp_attention(job, case, mesh):
    """``sequence_parallel_attention`` with ``case['impl']`` on this rank's
    shard of each of ``case['inputs']`` (global q, k, v, is_valid,
    segment_ids); the ranks' outputs gathered into the global [B, L, H, D];
    and the refusal under grad."""
    from merlot_reserve_tpu_torch.ops.ring_attention import sequence_parallel_attention

    outs = {}
    for name, inputs in case["inputs"].items():
        q, k, v, valid, seg = (_rank_rows(torch.as_tensor(x), mesh, "sp") for x in inputs)
        with torch.no_grad():
            out = sequence_parallel_attention(mesh, q, k, v, valid, seg, impl=case["impl"])
        outs[name] = comm.all_gather(out, mesh, "sp", 1)
    try:
        q.requires_grad_(True)
        sequence_parallel_attention(mesh, q, k, v, valid, seg, impl=case["impl"])
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    return {"outs": outs, "refused": refused}


def encoder(job, case, mesh):
    """A ``TransformerEncoder`` built from ``case['kwargs']`` with
    ``case['state']``, run without grad on the global ``case['x']`` and its
    labels under this mesh (the encoder splits the sequence over the ranks
    and gathers it back), ``case['batches']`` times (default once): the
    first output, and the collectives of all the runs."""
    from merlot_reserve_tpu_torch.models.layers import TransformerEncoder

    enc = TransformerEncoder(generator=torch.Generator().manual_seed(0), **case["kwargs"])
    enc.load_state_dict(case["state"])
    outs = []
    with torch.no_grad(), activate_mesh(mesh), comm.recording() as records:
        for _ in range(case.get("batches", 1)):
            outs.append(enc(torch.as_tensor(case["x"]), **{k: torch.as_tensor(v)
                                                           for k, v in case["inputs"].items()}))
    return {"seq": outs[0]["seq"], "comm": comm.summarize_records(records)}


def checkpoint(job, case, mesh):
    """A checkpoint written at this layout after one step, read back into a
    fresh state of the layout; and the one-process checkpoint read into
    this layout. Each as the whole state every rank gathers."""
    from merlot_reserve_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg = make_config(job, case.get("model", {}))

    def fresh():
        return create_distributed_train_state(cfg, full_model(cfg, job["params"]), mesh)

    state = fresh()
    batch = local_rows(mesh, batch_to_tensors(job["batch"], "cpu"))
    with activate_mesh(mesh):
        state, _ = train_step(state, batch, job["bf16_grads"], job["split_at"], job["gumbel"])
    written = save_checkpoint(state, case["dir"])
    torch.distributed.barrier(group=mesh.group(mesh.axis_names))  # the file is written
    resumed = load_checkpoint(case["dir"], state=fresh())
    from_one = load_checkpoint(case["one_process_dir"], state=fresh())
    out = {}
    for name, st in (("resumed", resumed), ("from_one_process", from_one)):
        whole = st.optimizer.full_state()
        out[name] = {"params": whole["params"], "mu": whole["mu"], "nu": whole["nu"],
                     "count": whole["count"], "step": st.step}
    out["file"] = written
    return out


def _whole(state):
    whole = state.optimizer.full_state()
    return {"params": whole["params"], "mu": whole["mu"], "nu": whole["nu"],
            "count": whole["count"], "step": state.step}


def sharded_checkpoint(job, case, mesh):
    """After one step: a per-rank sharded checkpoint written through an
    async ``sharded_manager`` and the msgpack file of the same state, each
    read back into a fresh state of this layout; and the sharded
    checkpoints of other layouts (``read``) read into this one. Each as
    the whole state every rank gathers."""
    from merlot_reserve_tpu_torch.utils import checkpoint as ck

    cfg = make_config(job, case.get("model", {}), case.get("optimizer"))

    def fresh():
        return create_distributed_train_state(cfg, full_model(cfg, job["params"]), mesh)

    state = fresh()
    batch = local_rows(mesh, batch_to_tensors(job["batch"], "cpu"))
    with activate_mesh(mesh):
        state, _ = train_step(state, batch, job["bf16_grads"], job["split_at"], job["gumbel"])
    with ck.sharded_manager(case["dir"]) as manager:
        manager.save(state)
    ck.save_checkpoint(state, case["dir"] + "_msgpack")
    torch.distributed.barrier(group=mesh.group(mesh.axis_names))  # the file is written
    out = {"saved": _whole(state),
           "resumed": _whole(ck.load_checkpoint_sharded(case["dir"], fresh())),
           "msgpack": _whole(ck.load_checkpoint(case["dir"] + "_msgpack", state=fresh())),
           "read": {d: _whole(ck.load_checkpoint_sharded(d, fresh())) for d in case["read"]}}
    return out


def loop(job, case, mesh):
    """``run_pretraining`` on this process mesh with an ``output_dir``: two
    steps saving every step, then a second run that resumes to three; the
    directory's listings and the steps each run logged."""
    import itertools

    from merlot_reserve_tpu_torch.training.pretrain import run_pretraining

    cfg = make_config(job, case.get("model", {}))
    batch = local_rows(mesh, batch_to_tensors(job["batch"], "cpu"))
    out, logged = {}, []
    run_pretraining(cfg, itertools.repeat(batch), num_steps=2, output_dir=case["dir"],
                    device="cpu", mesh=mesh, save_every=1, log_every=0,
                    log_fn=lambda s, m: logged.append(s))
    torch.distributed.barrier(group=mesh.group(mesh.axis_names))
    out["first"] = (sorted(os.listdir(case["dir"])), list(logged))
    logged.clear()
    state = run_pretraining(cfg, itertools.repeat(batch), num_steps=3, output_dir=case["dir"],
                            device="cpu", mesh=mesh, log_every=0,
                            log_fn=lambda s, m: logged.append(s))
    torch.distributed.barrier(group=mesh.group(mesh.axis_names))
    out["second"] = (sorted(os.listdir(case["dir"])), list(logged))
    out["step"], out["count"] = state.step, state.optimizer.count
    return out


def zero_shot(job, case, mesh):
    """zero_shot_qa_eval of the job's zero-shot head over its records, on
    this rank's rows of every batch."""
    from merlot_reserve_tpu_torch.finetune import models as heads
    from merlot_reserve_tpu_torch.finetune.data import finetune_batches
    from merlot_reserve_tpu_torch.utils.weights import flax_from_state_dict
    from merlot_reserve_tpu_torch.zero_shot import zero_shot_qa_eval

    zs = job["zero_shot"]
    cfg = load_config("base", **zs["model"]).replace_data(**zs["data"])
    cls = {"vcr": heads.MerlotReserveVCRZeroShot, "tvqa": heads.MerlotReserveTVQAZeroShot}
    params = flax_from_state_dict(zs["params"], zs["model"]["size_per_head"])
    batches = finetune_batches([zs["records"]], cfg, f"{zs['task']}_zero_shot", zs["batch"],
                               is_training=False, repeat=False, return_ids=True)
    with comm.recording() as records:
        metrics, rows = zero_shot_qa_eval(cls[zs["task"]](cfg, device="cpu"), params, batches,
                                          zs["task"], temperature=zs["temperature"], mesh=mesh)
    return {"metrics": metrics, "rows": rows, "comm": comm.summarize_records(records)}


def main(path):
    torch.set_num_threads(1)
    job = torch.load(path, weights_only=False)
    distributed.initialize(device="cpu")
    rank = distributed.process_index()
    results = {}
    for name, case in job["cases"].items():
        m = case["mesh"]
        n = m.get("dp", 1) * m.get("tp", 1) * m.get("sp", 1) * m.get("pp", 1)
        mesh = make_mesh(ranks=range(n), **m)
        if mesh.coords is None:
            continue
        kind = case.get("kind", "step")
        if kind == "step":
            metrics, params, summary, count, nbytes, replicas = run_step(job, case, mesh)
            out = {"metrics": metrics, "params": params, "comm": summary, "count": count,
                   "state_bytes": nbytes, "replicas": replicas}
        else:
            out = {"forward_audit": forward_audit, "checkpoint": checkpoint,
                   "sharded_checkpoint": sharded_checkpoint, "loop": loop,
                   "zero_shot": zero_shot, "rdma_forward": rdma_forward,
                   "sp_attention": sp_attention, "encoder": encoder,
                   "records": records}[kind](job, case, mesh)
        if rank == 0:
            results[name] = out
    if rank == 0:
        torch.save(results, job["out"])
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
