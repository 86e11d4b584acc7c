"""Port parity: TFRecords to a training step. The fused data+train step
(training/trainer.make_fused_data_train_step) against the JAX package's
make_jit_fused_data_train_step, and the resume of a fused run, at tiny
widths (hidden 128, 2 layers per tower, 4 segments, seq_len 80, batch 2).

Tolerances, those of tests/test_torch_training.py's f32 train_step (one
Adam step from the same weights, warmup 0): losses within 2e-6, every
parameter within 1e-5 absolute after the update. The JAX step returns the
updated state, not the gradients; the update is where they show. Both
sides see the same draws: the builder's through ``JaxDraws`` for JAX's key
``fold_in(PRNGKey(data_seed), step)``, the model's from JAX's content keys.
A resumed fused run builds the same batch at each step, bit for bit.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data.device_builder import DeviceExampleBuilder as JaxDeviceBuilder
from merlot_reserve_tpu.data.device_builder import stack_raw_examples
from merlot_reserve_tpu.data.pretrain_pipeline import PretrainExampleBuilder as JaxHostBuilder
from merlot_reserve_tpu.data.pretrain_pipeline import parse_segment_record as jax_parse
from merlot_reserve_tpu.data.synthetic import write_synthetic_corpus as jax_write_corpus
from merlot_reserve_tpu.data.tfrecord import read_records
from merlot_reserve_tpu.models import MerlotReservePretrainer as JaxPretrainer
from merlot_reserve_tpu.parallel import make_mesh as jax_make_mesh
from merlot_reserve_tpu.training import optimization as jopt
from merlot_reserve_tpu.training.trainer import make_jit_fused_data_train_step
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.device_builder import DeviceExampleBuilder
from merlot_reserve_tpu_torch.data.loader import DevicePretrainLoader
from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_corpus
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer
from merlot_reserve_tpu_torch.training.pretrain import run_pretraining
from merlot_reserve_tpu_torch.training.trainer import (
    create_train_state,
    make_fused_data_train_step,
)
from merlot_reserve_tpu_torch.utils.weights import flax_from_state_dict, state_dict_from_flax
from test_torch_data_device import JaxDraws
from _torch_jax_native import use_jax_native


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library():
    """The JAX side decodes through its own native library, built once and
    loaded here (tests/_torch_jax_native.py), never through a PIL fallback."""
    use_jax_native()


TINY = dict(hidden_size=128, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, output_grid=(4, 4), use_bfloat16=False)
DATA = dict(num_segments=4, seq_len=80, lang_seq_len=40, num_text_spans_to_include=8,
            text_span_budget=10, frame_buffer_size=328)
SEED = 7


def configs(**optimizer):
    return [dataclasses.replace(c.replace_data(**DATA), optimizer=dataclasses.replace(
        c.optimizer, **optimizer)) for c in (mr.load_config("base", **TINY),
                                              load_config("base", **TINY))]


def expected_init_losses(cfg, batch_size):
    """ln N per head at init: each side's number of candidates."""
    d = cfg.data
    audio_spans = d.num_segments * d.num_audio_subsegments
    targets = int(audio_spans * d.mask_rate) * d.num_text2audio_seqs
    return {"imgs_to_audio": math.log(batch_size * d.num_segments),
            "text_to_audio": (math.log(batch_size * audio_spans)
                              + math.log(batch_size * targets)) / 2,
            "stuff_to_span": math.log(batch_size * d.num_text_spans_to_include)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Training steps of tiny models on one intra-op thread: under the tier-1
    command's 6 worker processes on 8 cores, torch's default of a thread
    per core made these steps 60-100x slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    _, tcfg = configs()
    d = tmp_path_factory.mktemp("train")
    paths = [str(d / f"s{i}.tfrecord") for i in range(2)]
    for i, p in enumerate(paths):
        write_synthetic_corpus(p, tcfg, num_records=4, seed=i)
    return paths


def _model_draws(batch, cfg):
    """JAX's content-key draws of the pretrainer for ``batch``."""
    data = cfg.data
    keys = JaxPretrainer.content_keys(
        None, {"flat": {"audio2text/text_ptr": jnp.asarray(batch["audio2text/text_ptr"])}})
    spg = data.num_segments_per_group
    B, spans = batch["text_spans"].shape[:2]
    probs = np.array([0.1 / (spg - 1)] * (spg - 1) + [0.9])
    split_at = [torch.tensor(np.asarray(1 + jax.random.choice(
        keys[i], a=spg, shape=[B * data.num_segment_groups], p=probs))) for i in (0, 1)]
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(keys[2], [B, spans], jnp.float32)))
    return split_at, torch.tensor(np.asarray(gumbel))


def test_fused_step_matches_jax(tmp_path):
    """One fused step (host-decoded images ride along) from the same weights
    and raw batch: JAX's jitted step against the port's."""
    jcfg, tcfg = configs(num_warmup_steps=0)
    path = str(tmp_path / "c.tfrecord")
    jax_write_corpus(path, jcfg, num_records=2, seed=0)
    jb, hb = JaxDeviceBuilder(jcfg), JaxHostBuilder(jcfg)
    raws, images = [], []
    for i, r in enumerate(read_records(path)):
        segs = jax_parse(r, 4)
        raws.append(jb.host_prepare(segs))
        images.append(np.stack([hb.decode_image(s, np.random.default_rng(i)) for s in segs]))
    raw = stack_raw_examples(raws)
    raw["images"] = np.stack(images).reshape(2, -1, 768)

    model = MerlotReservePretrainer(tcfg, device="cpu", seed=0)
    params = flax_from_state_dict({k: v.detach() for k, v in model.state_dict().items()},
                                  tcfg.model.size_per_head)
    j_state = jopt.construct_train_state(jcfg.optimizer, JaxPretrainer.from_config(jcfg), params)
    mesh = jax_make_mesh(dp=1, devices=jax.devices("cpu")[:1])
    step_fn, j_state = make_jit_fused_data_train_step(mesh, j_state, jb, data_seed=SEED,
                                                      donate=False, use_bfloat16_grads=False)
    j_state, j_info = step_fn(j_state, {k: jnp.asarray(v) for k, v in raw.items()})

    state = create_train_state(tcfg, model)
    builder = DeviceExampleBuilder(tcfg)
    raw_t = {k: torch.from_numpy(v) for k, v in raw.items()}
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), jnp.uint32(0))
    batch = builder.build_batch({k: v for k, v in raw_t.items() if k != "images"},
                                JaxDraws(key, 2, jcfg))
    split_at, gumbel = _model_draws({k: v.numpy() for k, v in batch.items()}, jcfg)
    step = make_fused_data_train_step(builder, data_seed=SEED, use_bfloat16_grads=False)
    state, info = step(state, raw_t, split_at=split_at, gumbel=gumbel,
                       draws=JaxDraws(key, 2, jcfg))
    assert state.step == 1
    for k, v in j_info.items():
        assert abs(float(info[k]) - float(v)) <= 2e-6, (k, float(info[k]), float(v))
    want = state_dict_from_flax(jax.tree.map(np.asarray, j_state.params))
    for name, p in state.model.named_parameters():
        err = (p.detach() - want[name]).abs().max().item()
        assert err <= 1e-5, (name, err)


def _recording(builder):
    """Wraps builder.build_batch to keep every batch it builds."""
    built = []
    inner = builder.build_batch

    def build_batch(raw, draws):
        out = inner(raw, draws)
        built.append((draws.step, {k: v.clone() for k, v in out.items()}))
        return out

    builder.build_batch = build_batch
    return built


def test_fused_run_resumes_with_the_same_batches(corpus, tmp_path):
    """A fused run (frames on the device) checkpointed after step 0 and
    resumed to 2 builds the uninterrupted run's batch at step 1, bit for
    bit: the loader's position comes back from its sidecar, the builder's
    draws from the step."""
    _, tcfg = configs()

    def run(num_steps, output_dir):
        loader = DevicePretrainLoader(corpus, tcfg, 2, seed=3, num_workers=1, prefetch=1,
                                      fused=True, on_device_frames=True)
        built = _recording(loader._dev_builder)
        run_pretraining(tcfg, loader, num_steps=num_steps, output_dir=output_dir, device="cpu",
                        save_every=1, log_every=0, fused_builder=loader._dev_builder,
                        data_seed=SEED)
        return built

    whole = run(2, str(tmp_path / "whole"))
    run(1, str(tmp_path / "split"))
    resumed = run(2, str(tmp_path / "split"))
    assert [s for s, _ in whole] == [0, 1] and [s for s, _ in resumed] == [1]
    for (_, want), (_, got) in zip(whole[1:], resumed):
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert not torch.equal(whole[0][1]["text2audio"], whole[1][1]["text2audio"])
