"""Port parity: the ring kernel across processes, ``ring:rdma`` on a process
mesh (``ops.ring_attention._process_attention``), in gloo processes on the
CPU (tests/_torch_dist_worker.py, one torch thread each), where it runs its
plain version: the lax ring, whose hops go through ``torch.distributed``.

Held against the JAX package's ``ring_flash_attention_rdma``
(``_rdma_ring_kernel`` in Pallas interpret mode) on a 1 x n CPU mesh at
sp 2 and sp 4, as tests/test_ring_attention.py runs it, on labels that
cross the shards (packed segments, padding across a shard boundary, a tail
of padding, a shard that holds no valid key); and a 2-layer
``TransformerEncoder`` with ``attention_impl="ring:rdma"`` under sp 2
against JAX's under an sp 2 mesh, with one host barrier of its ranks per
forward in the comm audit. Also: the ring refuses gradients, and
``parallel.distributed.initialize`` raises for a card that does not exist
and puts ranks that share a card on gloo.

Tolerance: f32, atol 2e-5 on valid rows, as the JAX package's ring tests
(partial softmaxes merged in another order); the encoder 3e-5 and rtol
1e-5, as tests/test_torch_ring_attention.py holds its encoder.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from merlot_reserve_tpu.models import layers as jlayers
from merlot_reserve_tpu.ops import attention as jattn
from merlot_reserve_tpu.ops import ring_attention as jring
from merlot_reserve_tpu.parallel.mesh import Mesh as JaxMesh
from merlot_reserve_tpu.parallel.mesh import activate_mesh as jax_activate_mesh
from merlot_reserve_tpu_torch.models import layers as tlayers
from merlot_reserve_tpu_torch.parallel import distributed
from merlot_reserve_tpu_torch.utils.weights import load_flax_params
from test_torch_distributed import _launch

WORLD = 4
ATOL = 2e-5
ENC_ATOL, ENC_RTOL = 3e-5, 1e-5
B, L, H, D = 2, 64, 4, 16
CASES = ("packed", "blind_shard")
SPS = (2, 4)
ENCODER = dict(hidden_size=64, num_layers=2, size_per_head=16, rotary_hsize=8)
ENCODER_BATCHES = 2


def _inputs(name):
    """(q, k, v [B, L, H, D] f32, is_valid [B, L] int32, segment_ids [B, L]
    int32); shards are 32 rows at sp 2, 16 at sp 4."""
    rng = np.random.RandomState(11 if name == "packed" else 12)
    q, k, v = (rng.randn(B, L, H, D).astype(np.float32) for _ in range(3))
    valid = np.ones((B, L), np.int32)
    seg = np.zeros((B, L), np.int32)
    if name == "packed":  # three videos, boundaries inside shards
        seg[:, 21:] = 1
        seg[:, 45:] = 2
        valid[0, 30:34] = 0  # padding across the boundary of shards 1 and 2
        valid[:, 58:] = 0  # a padded tail
        seg[1, 50:] = -1  # padding as prepare_multimodal_inputs marks it
        valid[1, 50:] = 0
    else:  # every key of rank 1's shard at sp 4 is invalid
        seg[:, 40:] = 1
        valid[:, 16:32] = 0
    return q, k, v, valid, seg


def _encoder_inputs():
    rng = np.random.RandomState(6)
    x = rng.randn(B, L, ENCODER["hidden_size"]).astype(np.float32)
    coords = np.broadcast_to(np.arange(L, dtype=np.float32)[None, :, None], (B, L, 1)).copy()
    valid = np.ones((B, L), bool)
    valid[0, 50:] = False
    segs = np.sort(rng.randint(0, 2, (B, L)), -1).astype(np.int32)
    return x, dict(rotary_coords=coords, is_valid=valid, segment_ids=segs)


@pytest.fixture(scope="module")
def run(tmp_path_factory, cpu_devices):
    """JAX's side in this process (one compile of each shape), the port's in
    WORLD gloo processes, one job."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("ring_procs")
    jax_out = {}
    for n in SPS:
        mesh = JaxMesh(np.asarray(cpu_devices[:n]), axis_names=("sp",))
        for name in CASES:
            q, k, v, valid, seg = _inputs(name)
            jax_out[(n, name)] = np.asarray(jring.sequence_parallel_attention(
                mesh, *map(jnp.asarray, (q, k, v, valid, seg)), impl="rdma", interpret=True))
    x, inputs = _encoder_inputs()
    jenc = jlayers.TransformerEncoder(attention_impl="ring:rdma", seq_shard_axis="sp", **ENCODER)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       **{k_: jnp.asarray(v_) for k_, v_ in inputs.items()})
    old, jattn._FORCE_INTERPRET = jattn._FORCE_INTERPRET, True
    try:
        with jax_activate_mesh(JaxMesh(np.asarray(cpu_devices[:2]), axis_names=("sp",))):
            jax_enc = np.asarray(jax.jit(lambda p, x_: jenc.apply(
                p, x_, **{k_: jnp.asarray(v_) for k_, v_ in inputs.items()})["seq"])(
                    params, jnp.asarray(x)))
    finally:
        jattn._FORCE_INTERPRET = old
    kwargs = dict(ENCODER, attention_impl="ring:rdma", seq_shard_axis="sp")
    tenc = tlayers.TransformerEncoder(generator=torch.Generator().manual_seed(0), **kwargs)
    load_flax_params(tenc, params["params"])
    cases = {f"sp{n}": dict(mesh=dict(sp=n), kind="sp_attention", impl="rdma",
                            inputs={name: _inputs(name) for name in CASES}) for n in SPS}
    cases["encoder_sp2"] = dict(mesh=dict(sp=2), kind="encoder", kwargs=kwargs,
                                state=tenc.state_dict(), x=x, inputs=inputs,
                                batches=ENCODER_BATCHES)
    job = {"cases": cases, "out": str(tmp / "out.pt")}
    torch.save(job, tmp / "job.pt")
    _launch(tmp / "job.pt", WORLD)
    return {"port": torch.load(tmp / "out.pt", weights_only=False), "jax": jax_out,
            "jax_encoder": jax_enc}


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("n", SPS)
def test_rdma_across_processes_matches_jax_rdma_kernel(run, n, name):
    """Each rank's shard of ``sequence_parallel_attention(process mesh,
    impl="rdma")``, gathered, against JAX's rdma kernel on valid rows."""
    got = run["port"][f"sp{n}"]["outs"][name].numpy()
    rows = _inputs(name)[3] > 0
    np.testing.assert_allclose(got[rows], run["jax"][(n, name)][rows], atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", SPS)
def test_rdma_across_processes_refuses_gradients(run, n):
    refused = run["port"][f"sp{n}"]["refused"]
    assert refused and "forward-only" in refused and "ring:flash" in refused


def test_encoder_ring_rdma_across_processes_matches_jax_under_sp2(run):
    """Two layers of ``TransformerEncoder(attention_impl="ring:rdma",
    seq_shard_axis="sp")``, each rank holding half the sequence, against
    JAX's under an sp 2 mesh (its rdma kernel in interpret mode)."""
    x, inputs = _encoder_inputs()
    valid = inputs["is_valid"]
    got = run["port"]["encoder_sp2"]["seq"].numpy()
    np.testing.assert_allclose(got[valid], run["jax_encoder"][valid], atol=ENC_ATOL,
                               rtol=ENC_RTOL)


def test_encoder_ring_rdma_barriers_its_ranks_once_per_batch(run):
    """Each forward of the ``ring:rdma`` encoder on a process mesh meets its
    sp ranks at one host barrier (``comm.barrier``, in the audit) before its
    first ring: ranks that reach a batch more than the ring kernel's wait
    limit apart do not make their neighbours trap."""
    audit = run["port"]["encoder_sp2"]["comm"]
    assert audit["barrier"]["count"] == ENCODER_BATCHES
    assert audit["barrier"]["axes"] == {"sp": ENCODER_BATCHES}
    assert audit["barrier"]["what"] == {"sp": ENCODER_BATCHES}
    assert audit["barrier"]["bytes"] == 0


def _job_env(monkeypatch, local_rank, local_world):
    for key, value in dict(RANK=local_rank, WORLD_SIZE=local_world, LOCAL_RANK=local_rank,
                           LOCAL_WORLD_SIZE=local_world, MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=1).items():
        monkeypatch.setenv(key, str(value))


@pytest.mark.parametrize("device,local_rank", [("cuda:3", 0), ("cuda", 2)])
def test_initialize_refuses_a_card_that_does_not_exist(monkeypatch, device, local_rank):
    """With one card visible: a card named past it, or a local rank past it,
    raises before any process group starts."""
    _job_env(monkeypatch, local_rank, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: pytest.fail("group started"))
    with pytest.raises(RuntimeError, match="does not exist"):
        distributed.initialize(device=device)


def test_initialize_puts_ranks_that_share_a_card_on_gloo(monkeypatch):
    """``device="cuda:0"`` with two local ranks: both on cuda:0 and gloo
    (NCCL refuses two ranks on one card); a card per rank stays on NCCL."""
    started = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: started.append((backend, kw.get("device_id"))))
    try:
        _job_env(monkeypatch, 1, 2)
        assert distributed.initialize(device="cuda:0") == torch.device("cuda", 0)
        assert distributed._Job.shared_card
        _job_env(monkeypatch, 1, 2)
        assert distributed.initialize(device="cuda") == torch.device("cuda", 1)
        assert not distributed._Job.shared_card
    finally:
        distributed.shutdown()
    assert started == [("gloo", None), ("nccl", torch.device("cuda", 1))]
