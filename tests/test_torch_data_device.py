"""Port parity: the port's device data plane (ops/masking_device.py,
ops/vision_train.py, data/device_builder.py, DevicePretrainLoader) against
the JAX package's on the CPU, at tiny widths (4 segments, seq_len 80, a 4x4
grid, 328-pixel frame buffers).

Every random number of the port's builder goes through one sampler. Here it
is ``JaxDraws``, which returns the JAX package's draws for the same key tree
(``jax.random`` vmapped over the per-example keys equals the per-key calls),
so each stage is held against JAX on the same inputs and draws:
  * integers (token streams, pointers, span tables, row lengths, offsets,
    placements, the flip's pixels) exactly;
  * floats (audio clips, window times) within 1e-6; the frame resize's
    patches in [0, 1] within 2e-6: its two products sum in another order
    (XLA's dot against torch's bmm), and its weights take sin and cos,
    whose f32 results may differ in the last bit (measured 4.8e-7).
The port's own sampler (``BuilderDraws``) cannot give JAX's bits; it is
held by distribution: over 256 examples, the span-length histogram of its
batches against JAX's builder under JAX's own keys, within the JAX
package's budgets (device_builder.py:29-36 there): KL at most 0.02 nats and
mean span length within 0.5 tokens.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.data.device_builder import DeviceExampleBuilder as JaxDeviceBuilder
from merlot_reserve_tpu.data.masking import _WEIGHTS_V2
from merlot_reserve_tpu.data.pretrain_pipeline import parse_segment_record as jax_parse
from merlot_reserve_tpu.data.synthetic import write_synthetic_corpus as jax_write_corpus
from merlot_reserve_tpu.data.tfrecord import read_records
from merlot_reserve_tpu.ops import masking_device as jdev
from merlot_reserve_tpu.ops import vision_train as jvt
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.data.debug import kl_divergence, span_length_histogram
from merlot_reserve_tpu_torch.data.device_builder import (
    BuilderDraws,
    DeviceExampleBuilder,
    stack_raw_examples,
)
from merlot_reserve_tpu_torch.data.loader import DevicePretrainLoader
from merlot_reserve_tpu_torch.data.pretrain_pipeline import parse_segment_record
from merlot_reserve_tpu_torch.ops import masking_device as tdev
from merlot_reserve_tpu_torch.ops import vision_train as tvt
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
FLOAT_TOL = 1e-6
RESIZE_TOL = 2e-6
KL_BUDGET = 0.02
MEAN_BUDGET = 0.5


def configs():
    return (mr.load_config("base", **TINY).replace_data(**DATA),
            load_config("base", **TINY).replace_data(**DATA))


class JaxDraws:
    """The JAX package's builder draws for batch key ``key``, site by site:
    the key tree of merlot_reserve_tpu/data/device_builder.build_batch
    (split per example, split in 8, fold_in per stream and group)."""

    def __init__(self, key, batch: int, cfg):
        self.cfg = cfg
        self.kb = jax.random.split(key, batch)
        self.k8 = jax.vmap(lambda k: jax.random.split(k, 8))(self.kb)
        self.device = torch.device("cpu")

    @staticmethod
    def _t(x):
        return torch.from_numpy(np.array(x))

    @staticmethod
    def _fold(keys, i):
        return jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)

    def _t2a_keys(self, i):
        return jax.vmap(lambda k: jax.random.split(k, 3))(self._fold(self.k8[:, 2], i))

    def _select_key(self, kind, i, g):
        k = self._t2a_keys(i)[:, 2] if kind == "t2a" else self._fold(self.k8[:, 4], i)
        return self._fold(k, g)

    def _rt_keys(self, i):
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(self._fold(self.k8[:, 7], i))
        kseg = jax.vmap(lambda k: jax.random.split(k, 2))(ks[:, 0])
        return kseg[:, 0], kseg[:, 1], ks[:, 1]

    def _frame_keys(self):
        S = self.cfg.data.num_segments
        ks = jax.vmap(lambda k: jax.random.split(k, S))(self._fold(self.kb, 0x46524D))
        return jax.vmap(jax.vmap(lambda k: jax.random.split(k, 4)))(ks)

    def uniform(self, site, shape, low=0.0, high=1.0):
        d = self.cfg.data
        if site == "audio":
            return self._t(jax.vmap(lambda k: jax.vmap(lambda kk: jax.random.uniform(
                kk, (shape[2],)))(jax.random.split(k, shape[1])))(self.k8[:, 0]))
        m = re.fullmatch(r"t2a(\d+)/(reassign|increase)", site)
        if m:
            keys = self._t2a_keys(int(m[1]))[:, 0 if m[2] == "reassign" else 1]
            return self._t(jax.vmap(jax.random.uniform)(keys))
        m = re.fullmatch(r"(t2a|a2t)(\d+)/select(\d+)/segments", site)
        if m:
            return self._t(jax.vmap(lambda k: jax.random.uniform(
                k, (shape[1],), minval=-1e5, maxval=1e5))(
                    self._select_key(m[1], int(m[2]), int(m[3]))))
        m = re.fullmatch(r"a2t(\d+)/coin", site)
        if m:
            return self._t(jax.vmap(lambda k: jax.random.uniform(k, (shape[1],)))(
                self._fold(self.k8[:, 3], int(m[1]))))
        if site == "matching":
            return self._t(jax.vmap(jax.random.uniform)(self.k8[:, 5]))
        which = {"frames/mult": 0, "frames/off_y": 2, "frames/off_x": 3}[site]
        lo, hi = ((d.random_scale_min, d.random_scale_max) if site == "frames/mult"
                  else (0.0, 1.0))
        return self._t(jax.vmap(jax.vmap(lambda k: jax.random.uniform(
            k, (), minval=lo, maxval=hi)))(self._frame_keys()[:, :, which]))

    def gumbel(self, site, shape):
        m = re.fullmatch(r"(t2a|a2t)(\d+)/select(\d+)/gumbel", site)
        if m:
            keys = self._fold(self._select_key(m[1], int(m[2]), int(m[3])), 1)
        else:
            keys = self._rt_keys(int(re.fullmatch(r"rt(\d+)/mask", site)[1]))[2]
        return self._t(jax.vmap(lambda k: -jnp.log(-jnp.log(jax.random.uniform(
            k, (shape[1],), minval=1e-20, maxval=1.0))))(keys))

    def permutation(self, site, shape):
        keys = self.k8[:, 1] if site == "targets" else self.k8[:, 6]
        return self._t(jax.vmap(lambda k: jax.random.permutation(k, shape[-1]))(keys)).long()

    def categorical(self, site, logits, shape):
        keys = self._rt_keys(int(re.fullmatch(r"rt(\d+)/lengths", site)[1]))[0]
        w = jnp.log(jnp.asarray(_WEIGHTS_V2, jnp.float32))
        return self._t(jax.vmap(lambda k: jax.random.categorical(
            k, w[None].repeat(shape[1], 0), axis=-1))(keys)).long()

    def randint(self, site, high):
        m = re.fullmatch(r"rt(\d+)/offset", site)
        if m:
            return self._t(jax.vmap(lambda k, h: jax.random.randint(k, (), 0, h))(
                self._rt_keys(int(m[1]))[1], jnp.asarray(high.numpy(), jnp.int32))).long()
        return self._t(jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (), 0, 6)))(
            self._frame_keys()[:, :, 1])).long()


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    jcfg, _ = configs()
    path = str(tmp_path_factory.mktemp("device") / "c.tfrecord")
    jax_write_corpus(path, jcfg, num_records=8, seed=0)
    return list(read_records(path))


@pytest.fixture(scope="module")
def builders():
    jcfg, tcfg = configs()
    return JaxDeviceBuilder(jcfg), DeviceExampleBuilder(tcfg)


@pytest.fixture(scope="module")
def raw_batch(records, builders):
    """(JAX raw dict, port raw dict) of 3 records with their frames."""
    jb, tb = builders
    raws_j, raws_t = [], []
    for r in records[:3]:
        sj, st = jax_parse(r, 4), parse_segment_record(r, 4)
        raws_j.append({**jb.host_prepare(sj), **jb.host_prepare_frames(sj)})
        raws_t.append({**tb.host_prepare(st), **tb.host_prepare_frames(st)})
    return raws_j, raws_t


def test_host_prepare_matches_jax(raw_batch):
    for rj, rt in zip(*raw_batch):
        assert rj.keys() == rt.keys()
        for k in rj:
            assert rt[k].dtype == rj[k].dtype, k
            np.testing.assert_array_equal(rt[k], rj[k], err_msg=k)


def _assert_same(got, want, tol=FLOAT_TOL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _ragged_inputs(seed, B=8, n=12, L=40):
    rng = np.random.default_rng(seed)
    lengths = np.zeros((B, n), np.int32)
    for b in range(B):
        cuts = np.sort(rng.integers(0, L - rng.integers(0, 6) + 1, n - 1))
        lengths[b] = np.diff(np.concatenate([[0], cuts, [cuts[-1]]]))
        lengths[b, rng.integers(0, n, 3)] = 0
    masked = rng.uniform(size=(B, n)) < 0.3
    cent = np.sort(rng.uniform(0, 20, (B, L)), -1).astype(np.float32)
    ase = np.stack([np.arange(n) * 1.6, np.arange(n) * 1.6 + 1.7], -1).astype(np.float32)
    return lengths, masked, cent, np.broadcast_to(ase, (B, n, 2)).copy()


def test_ragged_primitives_match_jax():
    """value_rowids, the donation and widening passes (coins from JAX's
    keys), per-row min/max, token assignment and audio placement."""
    lengths, masked, cent, ase = _ragged_inputs(0)
    B, n = lengths.shape
    L = cent.shape[1]
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    coins = np.asarray(jax.vmap(jax.random.uniform)(keys))
    t = {k: torch.from_numpy(v) for k, v in
         dict(lengths=lengths, masked=masked, cent=cent, ase=ase, coins=coins).items()}

    _assert_same(tdev.value_rowids(t["lengths"], L),
                 jax.vmap(lambda r: jdev.value_rowids(r, L))(lengths), what="value_rowids")
    for rtl in (True, False):
        _assert_same(tdev.shift_row_lengths(t["lengths"], t["masked"], rtl),
                     jax.vmap(lambda r, m: jdev.shift_row_lengths(r, m, rtl))(lengths, masked),
                     what=f"shift {rtl}")
    _assert_same(tdev.reassign_empty_tokens(t["lengths"], t["masked"], t["coins"]),
                 jax.vmap(jdev.reassign_empty_tokens)(lengths, masked, keys), what="reassign")
    _assert_same(tdev.increase_textmask(t["lengths"], t["masked"], t["cent"], t["ase"],
                                        t["coins"], 0.125),
                 jax.vmap(lambda r, m, c, a, k: jdev.increase_textmask(r, m, c, a, k, 0.125))(
                     lengths, masked, cent, ase, keys), what="increase")
    for got, want in zip(tdev._row_min_max(t["cent"], t["lengths"], L),
                         jax.vmap(lambda c, r: jdev._row_min_max(c, r, L))(cent, lengths)):
        _assert_same(got, want, tol=0, what="row min/max")

    audio_cent = np.sort(np.random.default_rng(2).uniform(0, 20, (B, 5)), -1).astype(np.float32)
    _assert_same(tdev.assign_tokens_to_audio(t["cent"], torch.from_numpy(audio_cent)),
                 jax.vmap(jdev.assign_tokens_to_audio)(cent, audio_cent), what="assign")
    gaps_keys = jax.random.split(jax.random.PRNGKey(3), 64)
    gaps = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (4,)))(gaps_keys))
    _assert_same(tdev.place_audio_subsegments(torch.from_numpy(gaps), 188, 3, 60),
                 jax.vmap(lambda k: jdev.place_audio_subsegments(k, 188, 3, 60))(gaps_keys),
                 what="placement")


def test_rawtext_segmentation_matches_jax():
    B, desired, budget = 16, 80, 10
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    n_tok = np.random.default_rng(5).integers(20, 1024, B).astype(np.int32)
    n_tok[:3] = (1, 60, 1024)
    tokens = np.zeros((B, 1024), np.int32)
    want = jax.vmap(lambda k, n: jdev.convert_rawtext_into_fake_segments(
        k, jnp.asarray(tokens[0]), n, desired, budget))(keys, n_tok)
    rows = tdev.rawtext_max_rows(desired, budget)
    k1k2 = jax.vmap(jax.random.split)(keys)
    w = jnp.log(jnp.asarray(_WEIGHTS_V2, jnp.float32))
    cats = jax.vmap(lambda k: jax.random.categorical(k, w[None].repeat(rows, 0), axis=-1))(
        k1k2[:, 0])
    got = tdev.convert_rawtext_into_fake_segments(
        torch.from_numpy(np.asarray(cats)), torch.from_numpy(n_tok), desired, budget,
        lambda wig: torch.from_numpy(np.asarray(jax.vmap(
            lambda k, h: jax.random.randint(k, (), 0, h))(k1k2[:, 1], wig.int().numpy()))))
    for g, wnt, name in zip(got, want, ("lengths", "offset", "l_sel")):
        _assert_same(g, wnt, what=name)


def _select_draws_from(keys, n, rows):
    def per_group(g):
        kg = jax.vmap(lambda k: jax.random.fold_in(k, g))(keys)
        seg = jax.vmap(lambda k: jax.random.uniform(k, (n,), minval=-1e5, maxval=1e5))(kg)
        gum = jax.vmap(lambda k: -jnp.log(-jnp.log(jax.random.uniform(
            jax.random.fold_in(k, 1), (rows,), minval=1e-20, maxval=1.0))))(kg)
        return torch.from_numpy(np.array(seg)), torch.from_numpy(np.array(gum))
    return per_group


@pytest.mark.parametrize("case", ["t2a", "a2t", "plain", "overflow"])
def test_mask_tokens_and_select_match_jax(case):
    """mask_tokens (spans, rewrites, grouped streams) and select_tokens'
    budget subsample, with JAX's draws. 'overflow' has rows longer than
    max_row and a stream whose last row is full with padding after it: the
    dropped scatter writes of device_builder_longtail's case."""
    B, n, L, max_row = 8, 12, 40, 8
    lengths, masked, _, _ = _ragged_inputs(6, B, n, L)
    if case == "overflow":
        lengths[:] = 0
        lengths[:, 0], lengths[:, 5], lengths[:, -1] = 12, 3, max_row  # sum < L
    rng = np.random.default_rng(7)
    tokens = rng.integers(10, 900, (B, L)).astype(np.int32)
    do_span = rng.uniform(size=(B, n)) < 0.5
    kw = dict(max_row=max_row, text_span_start_counter=5, text_span_len=15, num_groups=2)
    if case == "t2a":
        kw.update(do_audio_mask=True, padded_seq_len=20)
    elif case == "a2t":
        kw.update(padded_seq_len=20, audio_token_length=6)
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    a2t = case == "a2t"
    want_spans, want_streams = jax.jit(jax.vmap(lambda k, t, r, m, s: jdev.mask_tokens(
        k, t, r, m, do_audio_span=s if a2t else None, **kw)))(keys, tokens, lengths, masked,
                                                               do_span)
    got_spans, got_streams = tdev.mask_tokens(
        torch.from_numpy(tokens), torch.from_numpy(lengths), torch.from_numpy(masked),
        do_audio_span=torch.from_numpy(do_span) if a2t else None,
        select_draws=_select_draws_from(keys, n, (n // 2) * max_row), **kw)
    _assert_same(got_spans, want_spans, what="spans")
    for (gt, gv), (wt, wv) in zip(got_streams, want_streams):
        _assert_same(gt, wt, what="stream")
        _assert_same(gv, wv, what="valid")


def test_augment_frames_matches_jax():
    """flip_if_vertical (exact) and the resize with explicit draws: all six
    kernels, scales up and down, crops, a portrait frame and a frame that
    fills the buffer."""
    fb = 64
    rng = np.random.default_rng(9)
    sizes = [(30, 50), (50, 30), (56, 56), (20, 60), (40, 20), (33, 47)]
    frames = np.zeros((len(sizes), fb, fb, 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        frames[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    hw = np.asarray(sizes, np.int32)
    draws = {"mult": np.asarray([1.0, 1.3, 0.7, 1.05, 2.0, 1.1], np.float32),
             "kernel": np.arange(6, dtype=np.int32),
             "off_y": np.asarray([0, 5, 0, 2, 9, 1], np.float32),
             "off_x": np.asarray([0, 3, 0, 7, 0, 4], np.float32)}
    grid = (2, 3)
    want = jax.jit(lambda f, s, d: jvt.augment_frames(jax.random.PRNGKey(0), f, s, grid,
                                                      (1.0, 1.0), draws=d))(
        jnp.asarray(frames), jnp.asarray(hw), {k: jnp.asarray(v) for k, v in draws.items()})
    tf = torch.from_numpy(frames)
    got = tvt.augment_frames(tf, torch.from_numpy(hw), grid,
                             {k: torch.from_numpy(v) for k, v in draws.items()})
    _assert_same(got, want, tol=RESIZE_TOL, what="patches")
    assert float(got.abs().max()) > 0.1
    flipped = jax.jit(jax.vmap(jvt.flip_if_vertical))(jnp.asarray(frames, jnp.float32),
                                                      hw[:, 0], hw[:, 1])
    mine = tvt.flip_if_vertical(tf, torch.from_numpy(hw[:, 0]), torch.from_numpy(hw[:, 1]))
    _assert_same(mine[0].float(), flipped[0], tol=0, what="flip")
    _assert_same(mine[1], flipped[1], what="h")
    _assert_same(mine[2], flipped[2], what="w")


def test_build_batch_matches_jax(builders, raw_batch):
    """The whole builder, frames included, on the same raw batch and draws."""
    jb, tb = builders
    raw = stack_raw_examples(raw_batch[0])
    key = jax.random.PRNGKey(3)
    want = jax.device_get(jb.build_batch(key, jax.tree.map(jnp.asarray, raw)))
    got = tb.build_batch({k: torch.from_numpy(v) for k, v in stack_raw_examples(
        raw_batch[1]).items()}, JaxDraws(key, 3, jb.cfg))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == {np.dtype("int32"): torch.int32,
                                np.dtype("float32"): torch.float32}[want[k].dtype], k
        _assert_same(got[k], want[k], tol=RESIZE_TOL if k == "images" else FLOAT_TOL, what=k)


def _span_lengths(table):
    return span_length_histogram(np.asarray(table).reshape(-1, np.asarray(table).shape[-1]))


def test_builder_draws_match_jax_in_distribution(builders, records):
    """The port's own sampler against JAX's keys: span-length histogram over
    256 examples (the 8 records, 32 draws each)."""
    jb, tb = builders
    raws = [jb.host_prepare(jax_parse(r, 4)) for r in records] * 4
    raw = stack_raw_examples(raws)
    raw_t = {k: torch.from_numpy(v) for k, v in raw.items()}
    build = jax.jit(jb.build_batch)
    h_jax, h_port = None, None
    for step in range(8):
        tj = jax.device_get(build(jax.random.PRNGKey(100 + step),
                                  jax.tree.map(jnp.asarray, raw))["text_spans"])
        tt = tb.build_batch(raw_t, BuilderDraws(0, step, "cpu"))["text_spans"]
        h_jax = _span_lengths(tj) if h_jax is None else h_jax + _span_lengths(tj)
        h_port = _span_lengths(tt) if h_port is None else h_port + _span_lengths(tt)

    def mean(h):
        return sum(k * v for k, v in h.items()) / sum(h.values())

    assert sum(h_port.values()) > 3000
    assert kl_divergence(h_jax, h_port) <= KL_BUDGET
    assert abs(mean(h_jax) - mean(h_port)) <= MEAN_BUDGET


def test_builder_draws_are_a_function_of_seed_and_step(builders, raw_batch):
    _, tb = builders
    raw = {k: torch.from_numpy(v) for k, v in stack_raw_examples(raw_batch[1]).items()}
    a = tb.build_batch(raw, BuilderDraws(7, 3, "cpu"))
    b = tb.build_batch(raw, BuilderDraws(7, 3, "cpu"))
    c = tb.build_batch(raw, BuilderDraws(7, 4, "cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["text2audio"], c["text2audio"])


@pytest.mark.parametrize("fused,frames", [(False, False), (True, True), (True, False)])
def test_device_loader(tmp_path, fused, frames):
    """DevicePretrainLoader: with fused=False it yields assembled batches on
    its device with the host loader's keys; with fused=True raw host arrays
    and no device call: frames as uint8 buffers, or the host-decoded
    images beside the raw arrays."""
    from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_corpus

    _, tcfg = configs()
    path = str(tmp_path / "c.tfrecord")
    write_synthetic_corpus(path, tcfg, num_records=2, seed=1)
    loader = DevicePretrainLoader([path], tcfg, batch_size=2, seed=0, num_workers=1,
                                  repeat=False, fused=fused, on_device_frames=frames,
                                  device="cpu")
    batch = next(iter(loader))
    if fused:
        assert all(isinstance(v, np.ndarray) for v in batch.values())
        if frames:
            assert batch["frames_u8"].shape == (2, 4, 328, 328, 3)
            assert batch["frames_u8"].dtype == np.uint8 and "images" not in batch
        else:
            assert batch["images"].shape == (2, 4 * 16, 768) and "frames_u8" not in batch
            assert batch["tok_ids"].dtype == np.int32
    else:
        assert batch["images"].shape == (2, 4 * 16, 768)
        assert batch["text2audio"].dtype == torch.int32
        assert batch["text_spans"].shape == (2, 3 * 2 + 10, 15)
