"""Port parity: ``dataset_creation/frame_embedder.py`` (MobileNetV2, the
state_dict loader, the preprocessing, the embedder) and its use by
``dataset_creation/filters.py`` against the JAX package's flax model.

Both packages load one seeded state_dict in torchvision's format (its key
names and shapes, batch norm's ``num_batches_tracked`` included), written
with ``torch.save``; the JAX side through its ``load_torch_mobilenet_v2``.
Tolerances: features and logits on [4, 82, 114, 3] inputs within 1e-4
relative to their largest magnitude (f32 convolutions summed in another
order; measured 3e-7 and 9e-7); ``preprocess_frames`` within 1e-6 (the same
f32 operations; measured equal); the static-video decisions equal, and
their mean cosines within 1e-5. One JAX compile (the 80-class model at
batch 4) serves every case.
"""

import numpy as np
import pytest
import torch

from merlot_reserve_tpu.dataset_creation import filters as jfilters
from merlot_reserve_tpu.dataset_creation import frame_embedder as J
from merlot_reserve_tpu_torch.dataset_creation import filters
from merlot_reserve_tpu_torch.dataset_creation.frame_embedder import (
    IR_SETTING,
    MobileNetV2,
    MobileNetV2Embedder,
    load_torch_mobilenet_v2,
    preprocess_frames,
)

NUM_CLASSES = 80
REL_TOL = 1e-4
PRE_TOL = 1e-6


def torchvision_state_dict(seed=0, num_classes=NUM_CLASSES, classifier="classifier.1"):
    """torchvision mobilenet_v2's state_dict layout (features.0 the stem,
    features.N.conv.* the blocks, features.18 the head, classifier.1),
    values drawn with numpy."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def bn(prefix, ch):
        sd[f"{prefix}.weight"] = t(rng.random(ch) + 0.5)
        sd[f"{prefix}.bias"] = t(rng.standard_normal(ch) * 0.1)
        sd[f"{prefix}.running_mean"] = t(rng.standard_normal(ch) * 0.1)
        sd[f"{prefix}.running_var"] = t(rng.random(ch) + 0.5)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    def conv(key, cout, cin, k):
        # He-scaled, so that the features depend on the input
        sd[key] = t(rng.standard_normal((cout, cin, k, k)) * np.sqrt(2.0 / (cin * k * k)))

    conv("features.0.0.weight", 32, 3, 3)
    bn("features.0.1", 32)
    cin, feat = 32, 1
    for expand, cout, n_blocks, _ in IR_SETTING:
        for _ in range(n_blocks):
            p, hid = f"features.{feat}.conv", cin * expand
            i = 0
            if expand != 1:
                conv(f"{p}.0.0.weight", hid, cin, 1)
                bn(f"{p}.0.1", hid)
                i = 1
            conv(f"{p}.{i}.0.weight", hid, 1, 3)
            bn(f"{p}.{i}.1", hid)
            conv(f"{p}.{i + 1}.weight", cout, hid, 1)
            bn(f"{p}.{i + 2}", cout)
            cin, feat = cout, feat + 1
    conv("features.18.0.weight", 1280, 320, 1)
    bn("features.18.1", 1280)
    if num_classes:
        sd[f"{classifier}.weight"] = t(rng.standard_normal((num_classes, 1280)) * 0.05)
        sd[f"{classifier}.bias"] = t(rng.standard_normal(num_classes) * 0.1)
    return sd


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The convolutions on one intra-op thread: under the parallel test
    run, torch's spinning OpenMP threads otherwise multiply this file's
    time several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def embedders(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mnv2") / "mobilenet_v2.pt")
    torch.save(torchvision_state_dict(), path)
    jax_emb = J.MobileNetV2Embedder(J.load_torch_mobilenet_v2(path, NUM_CLASSES),
                                    num_classes=NUM_CLASSES)
    port_emb = MobileNetV2Embedder.from_torch_checkpoint(path, NUM_CLASSES, device="cpu")
    return jax_emb, port_emb


def test_torchvision_names_load_strictly():
    """A torchvision state_dict loads with load_state_dict (strict): the
    module's names and shapes are torchvision's; the single-Linear
    classifier layout and a state_dict without num_batches_tracked load
    through load_torch_mobilenet_v2; a missing classifier raises."""
    sd = torchvision_state_dict(num_classes=1000)
    model = MobileNetV2(1000)
    model.load_state_dict(sd)
    assert sum(p.numel() for n, p in model.named_parameters()
               if not n.startswith("classifier")) == 2_223_872  # torchvision's count
    alt = {k: v for k, v in torchvision_state_dict(num_classes=10, classifier="classifier")
           .items() if not k.endswith("num_batches_tracked")}
    loaded = load_torch_mobilenet_v2(alt, num_classes=10)
    MobileNetV2(10).load_state_dict(loaded)
    torch.testing.assert_close(loaded["classifier.1.weight"], alt["classifier.weight"],
                               rtol=0, atol=0)
    with pytest.raises(KeyError, match="classifier"):
        load_torch_mobilenet_v2(torchvision_state_dict(num_classes=None), num_classes=10)


def test_features_and_logits_match_the_flax_model(embedders):
    jax_emb, port_emb = embedders
    x = np.random.default_rng(1).standard_normal((4, 82, 114, 3)).astype(np.float32)
    jf, jl = (np.asarray(a) for a in jax_emb._fwd(jax_emb.params, x))
    with torch.no_grad():
        tf, tl = (a.numpy() for a in port_emb.model(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert tf.shape == (4, 1280) and tl.shape == (4, NUM_CLASSES)
    assert np.abs(tf - jf).max() <= REL_TOL * np.abs(jf).max()
    assert np.abs(tl - jl).max() <= REL_TOL * np.abs(jl).max()


def test_preprocess_frames_matches_jax():
    frames = np.random.default_rng(2).integers(0, 256, (3, 120, 170, 3), dtype=np.uint8)
    got = preprocess_frames(frames, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (3, 82, 114, 3)
    np.testing.assert_allclose(got.numpy(), J.preprocess_frames(frames), rtol=0, atol=PRE_TOL)


def test_static_video_decisions_match_jax(embedders):
    """filters.is_static_video with the embedder: the JAX package's
    decisions and cosines on a static and a moving clip (4 frames each, the
    same batch shape as above), and the object scorer's expected count.
    Each clip is embedded once per package; the decisions at each
    threshold then read those embeddings."""
    jax_emb, port_emb = embedders
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, (150, 200, 3), dtype=np.uint8)
    clips = {"static": np.stack([frame] * 4),
             "moving": rng.integers(0, 256, (4, 150, 200, 3), dtype=np.uint8)}
    emb_t = {name: port_emb(clip) for name, clip in clips.items()}
    emb_j = {name: jax_emb(clip) for name, clip in clips.items()}
    cos = {name: jfilters.mean_pairwise_cosine(e) for name, e in emb_j.items()}
    for name in clips:
        assert abs(filters.mean_pairwise_cosine(emb_t[name]) - cos[name]) <= 1e-5, name
    # 0.85, and a threshold halfway between the two clips' cosines, which
    # must tell them apart in both packages
    middle = (cos["static"] + cos["moving"]) / 2
    for threshold in (0.85, middle):
        for name, clip in clips.items():
            got = filters.is_static_video(clip, threshold, lambda f, e=emb_t[name]: e)
            assert got == jfilters.is_static_video(clip, threshold,
                                                   lambda f, e=emb_j[name]: e), name
            assert got == (name == "static" or threshold == 0.85 and cos[name] >= 0.85)
    assert filters.is_static_video(clips["static"], middle, frame_embedder=port_emb)
    scores = port_emb.object_scores(clips["moving"])
    np.testing.assert_allclose(scores, jax_emb.object_scores(clips["moving"]), rtol=0,
                               atol=REL_TOL)
    assert abs(port_emb.expected_object_count(clips["moving"])
               - jax_emb.expected_object_count(clips["moving"])) <= NUM_CLASSES * REL_TOL
