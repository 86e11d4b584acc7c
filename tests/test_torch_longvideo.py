"""Port parity: the long-video pretraining recipe of merlot_reserve_tpu_torch
(configs/soak_longvideo.yaml, segment sharding, remat and ring:flash
training under a mesh) against the JAX package.

The training step is the recipe cut to a tiny size: hidden 64 (one head of
64), 2 layers per tower, a 4x4 grid, 8 segments in 2 groups, seq_len 160
(40 rows per rank), 8 spans drawn, batch 2, f32. Both remat knobs,
segment_shard_axis="sp" and joint attention "ring:flash" over a 1 x 4 sp
mesh: the port's over 4 CPU ranks in one process, JAX's over 4 virtual CPU
devices with its Pallas kernels in interpret mode (make_jit_train_step).
Both draws are JAX's, injected into the port. Tolerances as
tests/test_torch_training.py's f32 step: losses within 2e-6, every
parameter within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data.dummy import make_dummy_batch as jax_make_dummy_batch
from merlot_reserve_tpu.models import MerlotReservePretrainer as JaxPretrainer
from merlot_reserve_tpu.ops import attention as jattn
from merlot_reserve_tpu.parallel import mesh as jmesh
from merlot_reserve_tpu.training import optimization as jopt
from merlot_reserve_tpu.training.trainer import make_jit_train_step
from merlot_reserve_tpu_torch import kernels, load_config
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer, batch_to_tensors
from merlot_reserve_tpu_torch.ops import ring_attention as tring
from merlot_reserve_tpu_torch.parallel import mesh as tmesh
from merlot_reserve_tpu_torch.training.pretrain import config_mesh
from merlot_reserve_tpu_torch.training.trainer import create_train_state, train_step
from merlot_reserve_tpu_torch.utils.weights import load_flax_params, state_dict_from_flax

TINY = dict(hidden_size=64, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, output_grid=(4, 4), use_bfloat16=False,
            joint_attention_impl="ring:flash", seq_shard_axis="sp", segment_shard_axis="sp")
DATA = dict(num_segments=8, num_segment_groups=2, seq_len=160, lang_seq_len=40,
            num_text_spans_to_include=8)
BATCH, SPANS = 2, 16


def test_soak_longvideo_config_matches_jax():
    j, t = mr.load_config("soak_longvideo"), load_config("soak_longvideo")
    for part in ("model", "data", "device", "optimizer"):
        assert dataclasses.asdict(getattr(t, part)) == dataclasses.asdict(getattr(j, part)), part
    m = t.model
    assert m.gradient_checkpoint and m.tower_gradient_checkpoint
    assert (m.joint_attention_impl, t.data.seq_len, t.data.num_segments) == ("flash", 2560, 80)


def test_soak_longvideo_builds_a_pretrainer():
    """The recipe's knobs, with the sequence-parallel overrides, build a
    pretrainer in the port (at narrow widths: the knobs are the point)."""
    cfg = load_config("soak_longvideo", joint_attention_impl="ring:flash",
                      seq_shard_axis="sp", segment_shard_axis="sp", **{
                          k: v for k, v in TINY.items() if k.endswith(("_size", "_layers"))})
    model = MerlotReservePretrainer(cfg, device="cpu")
    assert model.joint_transformer.remat_saves == ()
    assert model.vision_encoder.transformer.remat_saves == ()
    assert model.joint_transformer.attention_impl == "ring:flash"


def _jax_spec(mesh, dim0, extra_axis):
    """The axes JAX's rows_anchor shards dim 0 over, read off the output of
    a jitted call under ``mesh`` (None: no sharding constraint)."""
    x = jnp.zeros((dim0, 3))
    if mesh is None:
        out = jax.jit(lambda a: jmesh.rows_anchor(a, extra_axis=extra_axis))(x)
    else:
        with jmesh.activate_mesh(mesh):
            out = jax.jit(lambda a: jmesh.rows_anchor(a, extra_axis=extra_axis))(x)
    spec = out.sharding.spec if isinstance(out.sharding, NamedSharding) else ()
    if not spec or spec[0] is None:
        return None
    axes = spec[0]
    return (axes,) if isinstance(axes, str) else tuple(axes)


@pytest.mark.parametrize("layout,dim0,extra_axis", [
    (None, 8, "sp"),  # no mesh: nothing to shard
    (dict(sp=4), 8, "sp"),  # dim 0 over the batch axes and sp
    (dict(sp=4), 6, "sp"),  # 6 rows do not divide over sp: dp_anchor
    (dict(sp=4), 8, None),  # no extra axis: dp_anchor
    (dict(sp=4), 8, "cp"),  # an axis the mesh lacks: dp_anchor
    (dict(sp=4), 8, "pp"),  # a size-1 axis: dp_anchor
    (dict(dp=2, sp=4), 8, "sp"),
    (dict(dp=2, sp=4), 4, "sp"),  # dp divides, dp x sp does not: dp_anchor
    (dict(dp=2, sp=4), 3, "sp"),  # not even dp divides: nothing
    (dict(dp=2, sp=4), 8, "dp"),  # dp as the extra axis: dp_anchor
])
def test_rows_anchor_fallbacks_match_jax(cpu_devices, layout, dim0, extra_axis):
    """rows_anchor returns its inputs, and row_shard_axes names the split
    that JAX's rows_anchor constrains dim 0 to, fallbacks included."""
    j_mesh = t_mesh = None
    if layout is not None:
        n = int(np.prod(list(layout.values())))
        j_mesh = jmesh.make_mesh(devices=cpu_devices[:n], **layout)
        t_mesh = tmesh.make_mesh(devices=["cpu"] * n, **layout)
    axes = tmesh.row_shard_axes(t_mesh, dim0, extra_axis)
    # JAX's output spec leaves out the axes of size 1 (dcn, and dp at 1)
    split = tuple(a for a in axes or () if t_mesh.shape[a] > 1) or None
    assert split == _jax_spec(j_mesh, dim0, extra_axis)
    a, b = torch.zeros(dim0, 3), torch.ones(dim0)
    with tmesh.activate_mesh(t_mesh):
        assert tmesh.rows_anchor(a, extra_axis=extra_axis) is a
        out = tmesh.rows_anchor(a, b, extra_axis=extra_axis)
        assert tmesh.dp_anchor(a) is a  # rows_anchor without an extra axis
    assert out[0] is a and out[1] is b


def test_rows_anchor_refuses_a_split_across_cards():
    """Every rank runs on the tensors' device in one process: a row split
    over ranks on another device raises, as sequence_parallel_attention
    does; a split that falls back to nothing does not."""
    mesh = tmesh.Mesh(np.array(["cpu", "meta"], dtype=object).reshape(1, 2), ("dp", "sp"))
    with tmesh.activate_mesh(mesh):
        with pytest.raises(NotImplementedError, match="several cards"):
            tmesh.rows_anchor(torch.zeros(4, 3), extra_axis="sp")
        a = torch.zeros(3, 3)  # 3 rows do not split over sp: no split
        assert tmesh.rows_anchor(a, extra_axis="sp") is a


def _configs():
    jcfg = mr.load_config("soak_longvideo", **TINY).replace_data(**DATA)
    tcfg = load_config("soak_longvideo", **TINY).replace_data(**DATA)
    return [dataclasses.replace(c, optimizer=dataclasses.replace(c.optimizer, num_warmup_steps=0))
            for c in (jcfg, tcfg)]


def _jax_draws(batch, cfg):
    """JAX's draws for ``batch`` from its content keys: (split_at of the
    audio2text and text2audio streams, gumbel)."""
    data = cfg.data
    towers = {"flat": {"audio2text/text_ptr": jnp.asarray(batch["audio2text/text_ptr"])}}
    keys = JaxPretrainer.content_keys(None, towers)
    spg = data.num_segments_per_group
    probs = np.array([0.1 / (spg - 1)] * (spg - 1) + [0.9])
    rows = BATCH * data.num_segment_groups
    split_at = [np.asarray(1 + jax.random.choice(keys[i], a=spg, shape=[rows], p=probs))
                for i in (0, 1)]
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(key=keys[2], shape=[BATCH, SPANS],
                                                  dtype=jnp.float32, minval=0.0, maxval=1.0)))
    return [torch.tensor(s) for s in split_at], torch.tensor(np.asarray(gumbel))


def test_long_video_train_step_matches_jax_on_a_mesh(cpu_devices, monkeypatch):
    jcfg, tcfg = _configs()
    batch = jax_make_dummy_batch(jcfg, batch_size=BATCH, seed=0, num_text_spans=SPANS)
    j_model = JaxPretrainer.from_config(jcfg)
    params = jax.tree.map(np.asarray, j_model.init_params(batch))

    monkeypatch.setattr(jattn, "_FORCE_INTERPRET", True)
    j_state = jopt.construct_train_state(jcfg.optimizer, j_model, params)
    step, j_state = make_jit_train_step(jmesh.make_mesh(devices=cpu_devices[:4], sp=4), j_state)
    j_state, j_info = step(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, False)
    j_params = state_dict_from_flax(jax.tree.map(np.asarray, j_state.params))

    model = MerlotReservePretrainer(tcfg, device="cpu")
    load_flax_params(model, params)
    state = create_train_state(tcfg, model)
    mesh = tmesh.make_mesh(sp=4, devices=["cpu"] * 4)
    split_at, gumbel = _jax_draws(batch, jcfg)
    calls = []
    real = tring._ring_flash_forward

    def counted(*args):
        calls.append(len(args[0]))
        return real(*args)

    before = dict(kernels.LAUNCHES)
    with tmesh.activate_mesh(mesh), monkeypatch.context() as m:
        m.setattr(tring, "_ring_flash_forward", counted)
        state, info = train_step(state, batch_to_tensors(batch, "cpu"), use_bfloat16_grads=False,
                                 split_at=split_at, gumbel=gumbel)
    assert dict(kernels.LAUNCHES) == before
    # each joint layer's ring in the forward and again in its recompute
    assert calls == [4] * (2 * tcfg.model.joint_num_layers)
    for k, v in j_info.items():
        assert abs(float(info[k]) - float(v)) <= 2e-6, k
    start = state_dict_from_flax(params)
    for name, p in model.named_parameters():
        assert not torch.equal(p.detach(), start[name]) or name == "contrastive_scales"
        assert (p.detach() - j_params[name]).abs().max().item() <= 1e-5, name


def test_config_mesh_follows_the_device_section():
    cfg = load_config("soak_longvideo")
    cfg = dataclasses.replace(cfg, device=dataclasses.replace(cfg.device, sp=4, dp=2))
    mesh = config_mesh(cfg, torch.device("cpu"))
    assert mesh.shape == {"dcn": 1, "dp": 2, "sp": 4, "pp": 1, "tp": 1}
    assert mesh.distinct_devices() == [torch.device("cpu")]
