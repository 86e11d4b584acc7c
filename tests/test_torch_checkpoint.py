"""Port parity: merlot_reserve_tpu_torch's checkpoints (utils/msgpack.py,
utils/checkpoint.py) against flax's msgpack and the JAX package's
utils/checkpoint.py, in both directions.

The JAX package writes flax-msgpack files only with flax's
``flax_use_orbax_checkpointing`` off (under flax 0.12 its default writes an
orbax directory); the tests set it off around the JAX writes.

Tolerances:
  * the codec, the parameters read across (f16 in the file, as both
    packages store them), mu, nu, the anchor and the counts: bit for bit;
  * the step after a restore, JAX against the port: as
    tests/test_torch_training.py holds one f32 train_step (losses within
    2e-6, every parameter within 1e-5).
"""

import contextlib
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from merlot_reserve_tpu.models import MerlotReservePretrainer as JaxPretrainer
from merlot_reserve_tpu.training import optimization as jopt
from merlot_reserve_tpu.training.trainer import train_step as jax_train_step
from merlot_reserve_tpu.utils import checkpoint as jck
from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors
from merlot_reserve_tpu_torch.training.trainer import create_train_state, train_step
from merlot_reserve_tpu_torch.utils import checkpoint as tck
from merlot_reserve_tpu_torch.utils import msgpack
from merlot_reserve_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_pretrainer import jax_draws
from test_torch_training import _configs, _port_model


@contextlib.contextmanager
def flax_msgpack_writer():
    """flax's legacy msgpack checkpoint writer, for the JAX package's writes."""
    old = flax.config.flax_use_orbax_checkpointing
    flax.config.update("flax_use_orbax_checkpointing", False)
    try:
        yield
    finally:
        flax.config.update("flax_use_orbax_checkpointing", old)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

_LEAVES = {
    "f32": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
    "f16": (np.arange(6, dtype=np.float32) / 3).astype(np.float16),
    "bf16": jnp.asarray(np.linspace(-3, 3, 9), jnp.bfloat16),
    "int32": np.arange(-5, 5, dtype=np.int32).reshape(2, 5),
    "scalar_0d": np.asarray(7, np.int32),
    "empty": np.zeros((0, 3), np.float32),
}


@pytest.mark.parametrize("kind", sorted(_LEAVES))
def test_codec_reads_and_writes_flax_msgpack_leaves(kind):
    leaf = _LEAVES[kind]
    tree = {"outer": {"inner": {"leaf": leaf}, "n": 3}, "step": -40000, "x": 1.5,
            "s": "name", "none": None, "flag": True, "big": 2 ** 40, "empty_map": {}}
    raw = serialization.msgpack_serialize(tree)
    dec = msgpack.unpackb(raw)
    t = dec["outer"]["inner"]["leaf"]
    assert isinstance(t, torch.Tensor) and tuple(t.shape) == tuple(np.shape(leaf))
    assert t.dtype == msgpack.DTYPES[str(np.asarray(leaf).dtype)]
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(leaf, np.float32))
    assert {k: dec[k] for k in ("step", "x", "s", "none", "flag", "big", "empty_map")} == {
        "step": -40000, "x": 1.5, "s": "name", "none": None, "flag": True, "big": 2 ** 40,
        "empty_map": {}}
    assert dec["outer"]["n"] == 3
    # the port writes the same bytes, and flax restores them
    assert msgpack.packb(dec) == raw
    back = serialization.msgpack_restore(msgpack.packb(dec))["outer"]["inner"]["leaf"]
    assert back.dtype == np.asarray(leaf).dtype
    np.testing.assert_array_equal(np.asarray(back, np.float32), np.asarray(leaf, np.float32))


def test_codec_reads_numpy_scalars_and_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    big = np.arange(100, dtype=np.float32).reshape(10, 10)
    tree = {"w": {"kernel": big}, "scalar": np.float32(2.5)}
    raw = serialization.msgpack_serialize(tree)
    dec = msgpack.unpackb(raw)
    assert torch.equal(dec["w"]["kernel"], torch.from_numpy(big))
    assert dec["scalar"].dim() == 0 and float(dec["scalar"]) == 2.5  # ext 3, a 0-d tensor
    chunked = msgpack.packb({"w": {"kernel": dec["w"]["kernel"]}})
    assert chunked == serialization.msgpack_serialize({"w": {"kernel": big}})
    np.testing.assert_array_equal(serialization.msgpack_restore(chunked)["w"]["kernel"], big)


def test_codec_rejects_malformed_input():
    with pytest.raises(msgpack.MsgpackError, match="truncated"):
        msgpack.unpackb(serialization.msgpack_serialize({"a": np.ones(4, np.float32)})[:-3])
    with pytest.raises(msgpack.MsgpackError, match="trailing"):
        msgpack.unpackb(serialization.msgpack_serialize({"a": 1}) + b"\x00")
    with pytest.raises(msgpack.MsgpackError, match="key"):
        msgpack.packb({1: 2})


# ---------------------------------------------------------------------------
# train states across the packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stepped():
    """A JAX train state one f32 step past init (so mu, nu and the counts
    are not zero), its batch and the draws the port needs to replay it."""
    jcfg, tcfg = _configs({"num_warmup_steps": 0})
    from merlot_reserve_tpu.data.dummy import make_dummy_batch as jax_make_dummy_batch

    batch = jax_make_dummy_batch(jcfg, batch_size=2, seed=0, num_text_spans=16)
    j_model = JaxPretrainer.from_config(jcfg)
    params = jax.tree.map(np.asarray, j_model.init_params(batch))
    j_state = jopt.construct_train_state(jcfg.optimizer, j_model, params)
    step = jax.jit(jax_train_step, static_argnums=2)
    bd = {k: jnp.asarray(v) for k, v in batch.items()}
    j_state, _ = step(j_state, bd, False)
    return jcfg, tcfg, j_model, params, batch, step, j_state


def _f16(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32).astype(np.float16)
                        .astype(np.float32), tree)


def _assert_port_state_equals_jax(state, j_state, params_via_f16=True):
    """Bit for bit: params (after the f16 round trip), mu, nu, counts, step."""
    j_params = _f16(j_state.params) if params_via_f16 else jax.tree.map(np.asarray,
                                                                        j_state.params)
    expect = state_dict_from_flax(j_params)
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach().view(torch.int32), expect[name].view(torch.int32)), name
    adam = j_state.opt_state[0]
    for ours, theirs in ((state.optimizer.mu, adam.mu), (state.optimizer.nu, adam.nu)):
        theirs = state_dict_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32), theirs))
        for name, t in ours.items():
            assert t.dtype == torch.bfloat16  # bits: nu's sign bit is a mantissa bit
            assert torch.equal(t.view(torch.int16),
                               theirs[name].bfloat16().view(torch.int16)), name
    assert state.optimizer.count == int(adam.count) == int(j_state.opt_state[2].count)
    assert state.step == int(j_state.step)


def _next_steps_agree(stepped, state, j_state):
    jcfg, _, _, _, batch, step, _ = stepped
    bd = {k: jnp.asarray(v) for k, v in batch.items()}
    j_state, j_info = step(j_state, bd, False)
    split_at, gumbel = jax_draws(batch, jcfg)
    state, info = train_step(state, batch_to_tensors(batch, "cpu"), use_bfloat16_grads=False,
                             split_at=split_at, gumbel=gumbel)
    for k, v in j_info.items():
        assert abs(float(info[k]) - float(v)) <= 2e-6, k
    j_sd = state_dict_from_flax(jax.tree.map(np.asarray, j_state.params))
    for name, p in state.model.named_parameters():
        assert (p.detach() - j_sd[name]).abs().max().item() <= 1e-5, name


def test_jax_checkpoint_restores_into_the_port(stepped, tmp_path):
    jcfg, tcfg, j_model, params, _, _, j_state = stepped
    with flax_msgpack_writer():
        path = jck.save_checkpoint(j_state, str(tmp_path))
    assert os.path.basename(path) == "ckpt_1" and os.path.isfile(path)
    state = create_train_state(tcfg, _port_model(tcfg, params))
    assert tck.load_checkpoint(str(tmp_path), state=state) is state
    _assert_port_state_equals_jax(state, j_state)
    # the JAX package's own restore of its file, and the next step on both sides
    j_restored = jck.load_checkpoint(str(tmp_path), state=jopt.construct_train_state(
        jcfg.optimizer, j_model, params))
    _next_steps_agree(stepped, state, j_restored)


def test_port_checkpoint_restores_into_jax(stepped, tmp_path):
    jcfg, tcfg, j_model, params, batch, _, _ = stepped
    state = create_train_state(tcfg, _port_model(tcfg, params))
    split_at, gumbel = jax_draws(batch, jcfg)
    state, _ = train_step(state, batch_to_tensors(batch, "cpu"), use_bfloat16_grads=False,
                          split_at=split_at, gumbel=gumbel)
    tck.save_checkpoint(state, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["ckpt_1"]
    # the JAX package reads the port's file into a TrainState of its own
    j_state = jck.load_checkpoint(str(tmp_path), state=jopt.construct_train_state(
        jcfg.optimizer, j_model, params))
    assert isinstance(j_state.opt_state[1], type(jopt.construct_train_state(
        jcfg.optimizer, j_model, params).opt_state[1]))
    tck.load_checkpoint(str(tmp_path), state=state)  # the port's params, f16-rounded too
    _assert_port_state_equals_jax(state, j_state, params_via_f16=False)
    for name, p in dict(state.model.named_parameters()).items():
        assert p.detach().half().float().equal(p.detach()), name
    _next_steps_agree(stepped, state, j_state)


def test_raw_tree_keys_and_dtypes_match_the_jax_file(stepped, tmp_path):
    """The port's tree has the JAX file's keys, shapes and dtypes, leaf for
    leaf, as read off a file the JAX package wrote."""
    _, tcfg, _, params, _, _, j_state = stepped
    with flax_msgpack_writer():
        jck.save_checkpoint(j_state, str(tmp_path / "jax"))
    state = create_train_state(tcfg, _port_model(tcfg, params))
    tck.load_checkpoint(str(tmp_path / "jax"), state=state)
    tck.save_checkpoint(state, str(tmp_path / "port"))

    def layout(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(layout(v, f"{prefix}/{k}"))
                out[f"{prefix}/{k}"] = "{}" if not v else "dict"
            else:
                out[f"{prefix}/{k}"] = (tuple(v.shape), v.dtype) if hasattr(v, "shape") else v
        return out

    with open(tmp_path / "jax" / "ckpt_1", "rb") as f:
        jax_raw = msgpack.unpackb(f.read())
    port_raw = msgpack.load(tmp_path / "port" / "ckpt_1")
    assert layout(port_raw) == layout(jax_raw)
    qkv = ("joint_transformer", "layers", "attention_layer", "qkv", "kernel")
    assert layout(port_raw)["/opt_state/0/mu/" + "/".join(qkv)] == ((2, 128, 6, 64),
                                                                     torch.bfloat16)
    assert layout(port_raw)["/params/" + "/".join(qkv)] == ((2, 128, 6, 64), torch.float16)


def test_orbax_directory_is_refused_with_the_flag_named(stepped, tmp_path):
    _, tcfg, _, params, _, _, j_state = stepped
    old = flax.config.flax_use_orbax_checkpointing
    flax.config.update("flax_use_orbax_checkpointing", True)
    try:
        jck.save_checkpoint(j_state, str(tmp_path))
    finally:
        flax.config.update("flax_use_orbax_checkpointing", old)
    assert os.path.isdir(tmp_path / "ckpt_1")
    with pytest.raises(ValueError, match="flax_use_orbax_checkpointing"):
        tck.load_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# files and the asynchronous writer
# ---------------------------------------------------------------------------


@pytest.fixture
def small_state():
    _, tcfg = _configs()
    from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer

    return create_train_state(tcfg, MerlotReservePretrainer(tcfg, device="cpu"))


def test_save_keeps_the_newest_and_overwrites_later_steps(small_state, tmp_path):
    state, d = small_state, str(tmp_path)
    for step in (1, 2, 3, 10):
        state.step = step
        tck.save_checkpoint(state, d, keep=3)
    assert sorted(os.listdir(d)) == ["ckpt_10", "ckpt_2", "ckpt_3"]
    state.step = 4
    with pytest.raises(FileExistsError):
        tck.save_checkpoint(state, d, overwrite=False)
    tck.save_checkpoint(state, d)  # overwrite: the later ckpt_10 goes
    assert sorted(os.listdir(d)) == ["ckpt_2", "ckpt_3", "ckpt_4"]
    assert int(tck.load_checkpoint(d)["step"]) == 4
    assert int(tck.load_checkpoint(d, step=2)["step"]) == 2
    with pytest.raises(FileNotFoundError):
        tck.load_checkpoint(d, step=7)
    assert tck.load_checkpoint(str(tmp_path / "none")) is None
    assert tck.load_checkpoint(str(tmp_path / "none"), state=state) is state


def test_no_optimizer_and_bf16_weights(small_state, tmp_path):
    state = small_state
    state.step = 5
    tck.save_checkpoint(state, str(tmp_path), no_optimizer=True)
    tree = tck.load_checkpoint(str(tmp_path), use_bfloat16_weights=True)
    assert tree["opt_state"] is None and int(tree["step"]) == 5
    sd = state_dict_from_flax(tree["params"], dtype=None)
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    for name, p in state.model.named_parameters():
        assert torch.equal(sd[name], p.detach().half().float().bfloat16()), name


def test_async_checkpointer_writes_the_state_as_it_was_at_save(small_state, tmp_path):
    state = small_state
    state.step = 7
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    ckpt = tck.AsyncCheckpointer()
    ckpt.save(state, str(tmp_path))
    with torch.no_grad():  # the next step's in-place update, right after save
        for p in state.model.parameters():
            p.add_(1.0)
    state.step = 8
    ckpt.wait()
    tree = tck.load_checkpoint(str(tmp_path))
    assert int(tree["step"]) == 7
    sd = state_dict_from_flax(tree["params"])
    for name, p in before.items():
        assert torch.equal(sd[name], p.half().float()), name


def test_async_checkpointer_raises_the_writers_error_at_wait(small_state, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ckpt = tck.AsyncCheckpointer()
    ckpt.save(small_state, str(blocker))
    with pytest.raises(OSError):
        ckpt.wait()
    ckpt.wait()  # the error is raised once
