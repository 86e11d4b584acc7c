"""Port parity: serving artifacts (merlot_reserve_tpu_torch/export.py) and
the flash forward as a PyTorch operator, at tiny widths (hidden 128, 1
layer per tower, grid 4x4, f32, joint attention "flash": on the CPU the
operator's plain version).

The port's CPU artifact is held against the JAX package's live
``batch_embed_video`` and ``embed_text_spans_only`` (dense attention) on
the same f16-rounded parameters at atol 1e-4, as tests/test_torch_model.py
holds the model, and against the port's live model on them at atol 1e-6.
The artifact's params.msgpack is read both ways with JAX's codec (bit for
bit), and ``param_overview``'s text is JAX's.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import flax
import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import merlot_reserve_tpu as mr
from merlot_reserve_tpu.models import MerlotReserve as JaxMerlotReserve
from merlot_reserve_tpu.utils import checkpoint as jck
from merlot_reserve_tpu_torch import export as texport
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.models import MerlotReserve
from merlot_reserve_tpu_torch.ops import attention as tattn
from merlot_reserve_tpu_torch.serving import VideoEmbedService
from merlot_reserve_tpu_torch.utils import checkpoint as tck
from merlot_reserve_tpu_torch.utils import msgpack
from merlot_reserve_tpu_torch.utils.weights import load_flax_params
from test_torch_serving import TINY, _videos

ROOT = Path(__file__).resolve().parent.parent
JAX_ATOL = 1e-4
LIVE_ATOL = 1e-6
BATCH, OPTIONS = 2, 8
FIELDS = ("images", "audio_clips", "tokens", "subseg_idxs")


def _options(n=3):
    opts = np.zeros((n, 15), np.int64)
    opts[:, :3] = np.random.RandomState(5).randint(10, 1000, (n, 3))
    opts[:, 3] = 2
    return opts


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's tiny model and its full parameter tree; the port's CPU artifact
    of it; JAX's live outputs on the f16-rounded tree (one eager apply of
    each method)."""
    jcfg = mr.load_config("base", **dict(TINY, joint_attention_impl="xla"))
    jmodel = JaxMerlotReserve.from_config(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init_params_full())
    params16 = jax.tree.map(np.asarray, jck.decompress_state(jck.compress_state(params)))
    videos = _videos(3)
    embed = jax.jit(lambda p, *x: jmodel.apply({"params": p}, *x,
                                               method=jmodel.batch_embed_video))
    jax_embed = np.asarray(embed(params16, *(np.stack([v[k] for v in videos]) for k in FIELDS)))
    label = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                              method=jmodel.embed_text_spans_only))
    jax_label = np.asarray(label(params16, _options()))
    cfg = load_config("base", **TINY)
    path = str(tmp_path_factory.mktemp("artifact"))
    manifest = texport.export_serving_artifact(MerlotReserve(cfg, device="meta"), params,
                                               videos[0], path, batch_size=BATCH,
                                               num_options=OPTIONS, device="cpu")
    live = MerlotReserve(cfg, device="cpu")
    load_flax_params(live, params16)
    return dict(label=label, params=params, params16=params16, videos=videos, path=path,
                manifest=manifest, jax_embed=jax_embed, jax_label=jax_label, live=live)


@pytest.fixture(scope="module")
def svc(setup):
    return texport.load_serving_artifact(setup["path"], device="cpu")


def test_artifact_files_and_manifest(setup):
    path, manifest = setup["path"], setup["manifest"]
    assert sorted(os.listdir(path)) == ["embed_video.pt2", "label_space.pt2", "manifest.json",
                                        "params.msgpack"]
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f) == manifest
    assert manifest["platforms"] == ["cpu"] and manifest["torch_version"] == torch.__version__
    assert manifest["batch_size"] == BATCH and manifest["num_options"] == OPTIONS
    assert manifest["input_shapes"]["images"] == [BATCH, 2, 16, 768]
    per_layer = jck.unstack_layer_params(setup["params"])
    assert sorted(manifest["param_order"]) == sorted(n for n, _ in tck.flat_leaves(per_layer))
    # one flash_fwd node per joint layer; the metadata asserts erased
    nodes = [str(n.target) for n in
             torch.export.load(os.path.join(path, "embed_video.pt2")).graph.nodes]
    assert nodes.count("merlot_reserve_torch.flash_fwd.default") == TINY["joint_num_layers"]
    assert "aten._assert_tensor_metadata.default" not in nodes
    # the programs hold no weights: together far smaller than the f16 params
    params_bytes = os.path.getsize(os.path.join(path, "params.msgpack"))
    for f in ("embed_video.pt2", "label_space.pt2"):
        assert os.path.getsize(os.path.join(path, f)) < params_bytes / 4


def test_exported_embed_matches_jax_and_the_live_model(setup, svc):
    videos = setup["videos"]
    out = svc.embed_stream(videos)  # a full batch, then one padded
    assert out.shape == (3, 16, 128) and out.dtype == np.float32
    np.testing.assert_allclose(out, setup["jax_embed"], atol=JAX_ATOL, rtol=0)
    live = VideoEmbedService(setup["live"], batch_size=BATCH, device="cpu").embed_stream(videos)
    np.testing.assert_allclose(out, live, atol=LIVE_ATOL, rtol=0)
    np.testing.assert_array_equal(svc.embed(videos[:2]), out[:2])


def test_exported_label_space_matches_jax_and_the_live_model(setup, svc):
    vecs = svc.label_space(_options())
    assert vecs.shape == (3, 128)
    np.testing.assert_allclose(vecs, setup["jax_label"], atol=JAX_ATOL, rtol=0)
    with torch.no_grad():
        live = setup["live"].embed_text_spans_only(torch.from_numpy(_options())).numpy()
    np.testing.assert_allclose(vecs, live, atol=LIVE_ATOL, rtol=0)
    with pytest.raises(ValueError, match="do not fit"):
        svc.label_space(np.zeros((OPTIONS + 1, 15), np.int64))


def test_params_file_reads_both_ways_with_jax_codec(setup, svc, tmp_path):
    """JAX's decompress_state(msgpack_restore(...)) reads the port's file
    into the f16-rounded tree, bit for bit, which JAX's model applies; the
    port's loader reads a file JAX wrote and serves the same outputs."""
    with open(os.path.join(setup["path"], "params.msgpack"), "rb") as f:
        from_port = jck.decompress_state(flax.serialization.msgpack_restore(f.read()))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), from_port,
                 setup["params16"])
    out = setup["label"](from_port, _options())
    np.testing.assert_array_equal(np.asarray(out), setup["jax_label"])

    copy = tmp_path / "artifact"
    shutil.copytree(setup["path"], copy)
    with open(copy / "params.msgpack", "wb") as f:
        f.write(flax.serialization.msgpack_serialize(
            jax.tree.map(np.asarray, jck.compress_state(setup["params"]))))
    from_jax = texport.load_serving_artifact(str(copy), device="cpu")
    for x, y in zip(svc.params, from_jax.params):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(from_jax.label_space(_options()), svc.label_space(_options()))


def test_loader_checks_the_parameters_against_the_programs(setup, tmp_path):
    copy = tmp_path / "artifact"
    shutil.copytree(setup["path"], copy)
    params = dict(setup["params"], head={"kernel": setup["params"]["head"]["kernel"][:, :64],
                                         "bias": setup["params"]["head"]["bias"]})
    with open(copy / "params.msgpack", "wb") as f:
        f.write(flax.serialization.msgpack_serialize(jck.compress_state(params)))
    with pytest.raises(ValueError, match="parameter head/kernel"):
        texport.load_serving_artifact(str(copy), device="cpu")


def test_loader_in_a_fresh_process_loads_no_model_code(setup):
    code = ("import json, sys\nimport numpy as np\n"
            "from merlot_reserve_tpu_torch.export import load_serving_artifact\n"
            f"svc = load_serving_artifact({setup['path']!r}, device='cpu')\n"
            "vecs = svc.label_space(np.zeros((2, 15), np.int64))\n"
            "print(json.dumps([list(vecs.shape), sorted(sys.modules)]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    shape, loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert shape == [2, 128]
    assert "merlot_reserve_tpu_torch.ops.attention" in loaded
    bad = [m for m in loaded if m.startswith(("merlot_reserve_tpu_torch.models",
                                              "merlot_reserve_tpu.", "jax", "flax"))
           or m in ("merlot_reserve_tpu", "jax")]
    assert bad == []


def test_empty_request_has_the_exported_rank(setup, svc):
    m = svc.manifest
    assert svc.embed([]).shape == (0, m["input_shapes"]["tokens"][1], m["hidden_size"])
    assert svc.embed_stream([]).shape == (0, 16, 128)
    with pytest.raises(ValueError, match="embed_stream"):
        svc.embed(setup["videos"])


def test_loader_refuses_a_device_the_artifact_was_not_exported_for(setup, monkeypatch):
    if not torch.cuda.is_available():  # the card is asked for and absent
        with pytest.raises(RuntimeError, match="cuda"):
            texport.load_serving_artifact(setup["path"], device="cuda")
    monkeypatch.setattr(texport, "resolve_device", lambda d: torch.device("cuda", 0))
    with pytest.raises(ValueError, match=r"exported for \['cpu'\]"):
        texport.load_serving_artifact(setup["path"], device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("key_labels", [False, True])
def test_flash_fwd_fake_gives_the_real_shapes_and_dtypes(dtype, key_labels):
    """The operator's fake (what torch.export traces) against its CPU
    implementation: shapes, dtypes and strides (torch.library.opcheck), and
    flash_forward through the operator equal to the plain version."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 24, 3, 64, generator=g).to(dtype) for _ in range(3))
    valid = torch.arange(24)[None].expand(2, 24) < torch.tensor([[20], [24]])
    seg = (torch.arange(24) // 10)[None].expand(2, 24).int()
    labels = (valid, seg) if key_labels else (None, None)
    torch.library.opcheck(tattn.flash_fwd_op, (q, k, v, valid, seg, *labels))
    real = tattn.flash_forward(q, k, v, valid, seg, *labels)
    with FakeTensorMode() as mode:
        fake = tattn.flash_forward(*(mode.from_tensor(x) if x is not None else None
                                     for x in (q, k, v, valid, seg, *labels)))
    for f, r in zip(fake, real):
        assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype, r.stride())
    assert real[0].dtype == dtype and real[1].dtype == torch.float32
    for a, b in zip(real, tattn.flash_attention_reference(q, k, v, valid, seg, *labels)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cast", ["f32", "bf16"])
def test_param_overview_is_jax_text(setup, cast):
    tree = tck.decompress_state(msgpack.load(os.path.join(setup["path"], "params.msgpack")))
    jtree = setup["params16"]
    if cast == "bf16":
        tree, jtree = tck.f32_to_bf16(tree), jck.f32_to_bf16(jtree)
    tree["step"], jtree["step"] = torch.tensor(3, dtype=torch.int32), np.asarray(3, np.int32)
    assert tck.param_overview(tree) == jck.param_overview(jtree)
