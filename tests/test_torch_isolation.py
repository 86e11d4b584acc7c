"""The port stands alone: importing every module of merlot_reserve_tpu_torch
(and running chip_smoke.py) loads no JAX, flax, merlot_reserve_tpu or
HuggingFace tokenizers module, and the entry points refuse to run on their
default device, the CUDA card, where there is none: they never fall back to
the CPU on their own."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_torch import main as bench_main
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.ops.audio import batch_make_spectrogram
from merlot_reserve_tpu_torch.ops.vision import batch_preprocess_images
from merlot_reserve_tpu_torch.preprocess import preprocess_video, segments_from_arrays
from merlot_reserve_tpu_torch.models import MerlotReserve, PretrainedMerlotReserve
from merlot_reserve_tpu_torch.models.pretrainer import MerlotReservePretrainer
from merlot_reserve_tpu_torch.parallel.mesh import make_mesh
from merlot_reserve_tpu_torch.serving import VideoEmbedService
from merlot_reserve_tpu_torch.training.pretrain import run_pretraining

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "merlot_reserve_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "merlot_reserve_tpu", "tokenizers")
TINY = dict(hidden_size=128, joint_num_layers=1, vit_num_layers=1, audio_num_layers=1,
            span_num_layers=1, output_grid=(4, 4), use_bfloat16=False)


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_importing_every_port_module_loads_no_jax():
    code = ("import importlib, json, sys\n"
            f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert "merlot_reserve_tpu_torch.models.model" in loaded
    assert "merlot_reserve_tpu_torch.ops.ring_attention" in loaded
    assert "merlot_reserve_tpu_torch.parallel.mesh" in loaded
    for module in ("ops.vision", "ops.audio", "tokenizer", "preprocess", "zero_shot",
                   "utils.subtitles", "utils.profiling", "models.layers", "models.towers",
                   "models.pretrainer", "training.trainer", "training.pretrain"):
        assert f"merlot_reserve_tpu_torch.{module}" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py", "bench_torch.py"])
def test_no_source_imports_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert [n for n in names if _forbidden(n)] == []


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = load_config("base", **TINY)
    with pytest.raises(RuntimeError, match="cuda"):
        MerlotReserve(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        VideoEmbedService(MerlotReserve(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        PretrainedMerlotReserve.from_params("base", {})
    with pytest.raises(RuntimeError, match="cuda"):
        MerlotReservePretrainer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        run_pretraining(cfg, iter([]), num_steps=1)
    with pytest.raises(RuntimeError, match="cuda"):  # the long-video recipe and its mesh
        run_pretraining(load_config("soak_longvideo", joint_attention_impl="ring:flash",
                                    **TINY), iter([]), num_steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(sp=4)  # its default devices: the card, once per rank
    frames = np.zeros((1, 32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="cuda"):
        batch_preprocess_images(frames, (2, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        batch_make_spectrogram(np.zeros((1, 110250), np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        segments_from_arrays(frames, np.zeros(110250, np.float32),
                             [{"start_time": 0.0, "end_time": 5.0, "mid_time": 2.5}])
    with pytest.raises(RuntimeError, match="cuda"):
        preprocess_video([{"frame": frames[0], "spectrogram": None, "text": "a"}], (2, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        bench_main([])


def test_make_mesh_puts_virtual_ranks_on_the_default_device(monkeypatch):
    """make_mesh's default devices are resolve_device('cuda'), repeated once
    per rank: on one card, make_mesh(sp=4) is 4 virtual ranks on it."""
    import merlot_reserve_tpu_torch.parallel.mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "resolve_device", lambda d: torch.device("cuda", 0))
    mesh = make_mesh(sp=4)
    assert mesh.shape == {"dcn": 1, "dp": 1, "sp": 4, "pp": 1, "tp": 1}
    assert mesh.distinct_devices() == [torch.device("cuda", 0)]
    assert make_mesh(dp=2, sp=2).devices.size == 4


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    res = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout
