"""The port stands alone: importing every module of merlot_reserve_tpu_torch
(and running chip_smoke.py, a scripts/*_torch.py, the prep scripts
included, or a demo/*_torch.py) loads no JAX,
flax, optax, merlot_reserve_tpu, HuggingFace tokenizers, msgpack, ml_dtypes
or PIL module, and the entry
points refuse to run on their default device, the CUDA card, where there is
none: they never fall back to the CPU on their own."""

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
from merlot_reserve_tpu_torch.finetune.models import (
    MerlotReserveTVQA,
    MerlotReserveTVQAZeroShot,
    MerlotReserveVCR,
    MerlotReserveVCRZeroShot,
)
from merlot_reserve_tpu_torch.finetune.train import create_finetune_state
from merlot_reserve_tpu_torch.utils.checkpoint import load_checkpoint
from merlot_reserve_tpu_torch.data.device_builder import DeviceExampleBuilder
from merlot_reserve_tpu_torch.data.loader import DeviceFeed, DevicePretrainLoader
from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_corpus
from merlot_reserve_tpu_torch.dataset_creation.frame_embedder import (MobileNetV2Embedder,
                                                                      preprocess_frames)
from merlot_reserve_tpu_torch.dataset_creation.process import (build_chunk,
                                                               process_video_arrays,
                                                               window_log_mels)
from scripts.finetune_tvqa_torch import main as finetune_tvqa_main
from scripts.finetune_vcr_torch import main as finetune_vcr_main
from scripts.pretrain_fixres_torch import main as fixres_main
from scripts.prep_tvqa_torch import main as prep_tvqa_main
from scripts.prep_tvqa_torch import tvqa_record
from scripts.pretrain_torch import main as pretrain_main
from scripts.validate_torch import main as validate_main
from scripts.zero_shot_tvqa_torch import main as zero_shot_tvqa_main
from scripts.zero_shot_vcr_torch import main as zero_shot_vcr_main

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "merlot_reserve_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "merlot_reserve_tpu", "tokenizers", "msgpack",
             "ml_dtypes", "PIL")
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
                   "models.pretrainer", "training.trainer", "training.pretrain",
                   "training.optimization", "finetune.models", "finetune.train",
                   "utils.checkpoint", "utils.msgpack", "utils.experiment", "data.tfrecord",
                   "data.native", "data.masking", "data.debug", "data.synthetic",
                   "data.pretrain_pipeline", "data.loader", "data.device_builder",
                   "ops.masking_device", "ops.vision_train", "finetune.data",
                   "finetune.prep_data", "dataset_creation.spectrogram", "dataset_creation.text",
                   "dataset_creation.text_corpus", "dataset_creation.offset_model",
                   "dataset_creation.process", "dataset_creation.frame_embedder",
                   "dataset_creation.filters", "dataset_creation.youtube",
                   "parallel.distributed", "parallel.comm", "parallel.sharding",
                   "parallel.pipeline", "parallel.memory", "utils.launch"):
        assert f"merlot_reserve_tpu_torch.{module}" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py", "bench_torch.py"]
                         + sorted(str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob(
                             "*_torch.py"))
                         + sorted(str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob(
                             "profile_torch_*.py"))
                         + sorted(str(p.relative_to(ROOT)) for p in (ROOT / "demo").glob(
                             "*_torch.py")))
def test_no_source_imports_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert [n for n in names if _forbidden(n)] == []


def test_entry_points_refuse_a_missing_card(tmp_path):
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
    # finetuning: the heads, and a checkpoint loaded into a state on the card
    for head in (MerlotReserveVCR, MerlotReserveTVQA):
        with pytest.raises(RuntimeError, match="cuda"):
            head(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        load_checkpoint(str(tmp_path), state=create_finetune_state(cfg, MerlotReserveVCR(cfg)))
    with pytest.raises(RuntimeError, match="cuda"):  # checkpointing and resume
        run_pretraining(cfg, iter([]), num_steps=1, output_dir=str(tmp_path))
    assert list(tmp_path.iterdir()) == []
    # the data plane: the device feed, the device loader, the fused step's
    # run and the pretraining script
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceFeed([], "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        run_pretraining(cfg, iter([]), num_steps=1, fused_builder=DeviceExampleBuilder(cfg))
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    write_synthetic_corpus(str(corpus / "c.tfrecord"), cfg, num_records=1)
    with pytest.raises(RuntimeError, match="cuda"):
        DevicePretrainLoader([str(corpus / "c.tfrecord")], cfg, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain_main(["base", "-train_fns", str(corpus / "c.tfrecord"), "-num_steps", "1",
                       "--fused_data"])
    # fixres, validation, finetuning on records and zero-shot QA: the rankers
    # and every script, which refuse before they read a file
    for head in (MerlotReserveVCRZeroShot, MerlotReserveTVQAZeroShot):
        with pytest.raises(RuntimeError, match="cuda"):
            head(cfg)
    with pytest.raises(RuntimeError, match="cuda"):  # the process pool changes nothing here
        DevicePretrainLoader([str(corpus / "c.tfrecord")], cfg, 1, use_processes=True)
    # dataset creation and the prep scripts: the log-mels, the embedder
    words = [{"word": "a", "start": 1.0, "end": 1.2}]
    window = {"start_time": 0.0, "end_time": 5.0, "playback_speed": 1, "words": words}
    pcm = np.zeros(22050 * 6, np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        window_log_mels(pcm[None, :110250], 1)
    with pytest.raises(RuntimeError, match="cuda"):
        build_chunk(np.zeros((8, 8, 3), np.uint8), pcm, window)
    with pytest.raises(RuntimeError, match="cuda"):
        process_video_arrays(np.zeros((1, 8, 8, 3), np.uint8), pcm, words, 6.0)
    with pytest.raises(RuntimeError, match="cuda"):
        MobileNetV2Embedder()
    with pytest.raises(RuntimeError, match="cuda"):
        preprocess_frames(np.zeros((1, 8, 8, 3), np.uint8))
    ann = {"id": "x", "ts_start": 1.0, "ts_end": 2.0, "question": "q", "answers": ["a"] * 5,
           "label": 0}
    with pytest.raises(RuntimeError, match="cuda"):
        tvqa_record(ann, np.zeros((7, 8, 8, 3), np.uint8), pcm, 6.0)
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="cuda"):
        prep_tvqa_main(["-manifest", missing, "-out", missing])
    for main, argv in ((fixres_main, ["-train_fns", missing]),
                       (validate_main, ["-ckpt_dir", missing, "-val_fns", missing]),
                       (finetune_vcr_main, ["-train_fns", missing]),
                       (finetune_tvqa_main, ["-train_fns", missing]),
                       (zero_shot_vcr_main, ["-val_fns", missing]),
                       (zero_shot_tvqa_main, ["-val_fns", missing])):
        ckpt = [] if main is validate_main else ["-ckpt", missing]
        with pytest.raises(RuntimeError, match="cuda"):
            main(["base", *ckpt, *argv])


SERVING_TOOLS = ("merlot_reserve_tpu_torch.export", "scripts.export_serving_torch",
                 "scripts.convert_checkpoint_torch", "scripts.vcr_leaderboard_torch",
                 "demo.demo_video_torch", "demo.zero_shot_qa_torch", "demo.zero_shot_ek100_torch",
                 "demo.load_video_torch")


def test_serving_tools_and_demos_load_no_jax():
    """export.py, the export, converter and leaderboard scripts and the four
    demos import (and their heavy imports, made inside the functions, with
    them) with no JAX, flax, msgpack or merlot_reserve_tpu module loaded."""
    code = ("import importlib, json, sys\n"
            f"for m in {SERVING_TOOLS!r}: importlib.import_module(m)\n"
            "import merlot_reserve_tpu_torch.models, merlot_reserve_tpu_torch.finetune.train\n"
            "import merlot_reserve_tpu_torch.zero_shot, merlot_reserve_tpu_torch.preprocess\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(SERVING_TOOLS) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


def test_serving_tools_and_demos_refuse_a_missing_card(tmp_path):
    """Each entry point of the serving tools and demos refuses the missing
    card before it reads a file, unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from demo.demo_video_torch import main as demo_video_main
    from demo.load_video_torch import load_video
    from demo.load_video_torch import main as load_video_main
    from demo.zero_shot_ek100_torch import main as ek100_main
    from demo.zero_shot_qa_torch import main as qa_main
    from merlot_reserve_tpu_torch.export import export_serving_artifact, load_serving_artifact
    from scripts.export_serving_torch import main as export_main
    from scripts.vcr_leaderboard_torch import main as leaderboard_main

    missing = str(tmp_path / "missing")
    cfg = load_config("base", **TINY)
    with pytest.raises(RuntimeError, match="cuda"):
        export_serving_artifact(MerlotReserve(cfg, device="meta"), {}, {}, missing)
    with pytest.raises(RuntimeError, match="cuda"):
        load_serving_artifact(missing)
    with pytest.raises(RuntimeError, match="cuda"):
        load_video(missing, missing)
    for main, argv in (
            (export_main, ["base", "-ckpt", missing, "-out", missing]),
            (leaderboard_main, ["base", "-ckpt", missing, "-test_fns", missing]),
            (demo_video_main, [missing, "-ckpt", missing, "--options", "a,b"]),
            (qa_main, ["infer", "--videos", missing, "--qa", missing, "--vocab", missing,
                       "-ckpt", missing]),
            (ek100_main, ["extract", "--videos", missing, "--annotations", missing, "--out",
                          missing, "-ckpt", missing]),
            (ek100_main, ["eval", "--feats", missing, "--annotations", missing,
                          "--verb_classes", missing, "--noun_classes", missing,
                          "-ckpt", missing]),
            (load_video_main, [missing, "-vtt", missing])):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    assert list(tmp_path.iterdir()) == []


def test_distributed_entry_points_refuse_a_missing_card(tmp_path, monkeypatch):
    """Joining a job on the card (NCCL) refuses without one, and never
    takes gloo or the CPU on its own; so does the pretraining script's
    -distributed, before it reads a file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from merlot_reserve_tpu_torch.parallel import distributed

    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="29591").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="cuda"):
        distributed.initialize()
    assert not distributed.is_initialized()
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain_main(["base", "-train_fns", missing, "-distributed"])
    assert not distributed.is_initialized() and list(tmp_path.iterdir()) == []


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


SOAK_AND_TRACE_TOOLS = ("scripts.profile_torch_soak", "scripts.profile_step_torch",
                        "merlot_reserve_tpu_torch.utils.profiling")


def test_soak_and_trace_tools_load_no_jax_and_refuse_a_missing_card():
    """The soak tool, the step profiler and the trace helpers, with the
    sharded checkpoints' torch.distributed.checkpoint, load no forbidden
    module; both tools refuse the missing card before they write or build
    anything."""
    code = ("import importlib, json, sys\n"
            f"for m in {SOAK_AND_TRACE_TOOLS!r}: importlib.import_module(m)\n"
            "import torch.distributed.checkpoint\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(SOAK_AND_TRACE_TOOLS) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []
    if torch.cuda.is_available():
        return
    from scripts.profile_step_torch import main as profile_step_main
    from scripts.profile_torch_soak import main as soak_main

    with pytest.raises(RuntimeError, match="cuda"):
        profile_step_main([])
    with pytest.raises(RuntimeError, match="cuda"):
        soak_main(["--config", "soak_fused_r5", "--workdir", "/nonexistent/never-written"])
