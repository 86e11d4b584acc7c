"""The port's training feeds on the CPU: run_pretraining through
host-assembled batches from PretrainLoader, scripts/pretrain_torch.py (raw
batches with frames augmented on the device), and the DeviceFeed's dtypes,
at tiny widths
(hidden 128, 2 layers per tower, 4 segments, seq_len 80, batch 2). The
losses at step 0 sit within 0.05 of ln N, each head's number of candidates
(an untrained model scores them all about equally)."""

import math
import os

import numpy as np
import pytest
import torch

from merlot_reserve_tpu_torch.data.loader import DeviceFeed, PretrainLoader
from merlot_reserve_tpu_torch.training.pretrain import run_pretraining
from merlot_reserve_tpu_torch.training.trainer import model_batch
from test_torch_data_train import (  # noqa: F401
    DATA,
    TINY,
    configs,
    corpus,
    expected_init_losses,
    one_torch_thread,
)


def test_run_pretraining_through_the_host_loader(corpus):
    """A step through the host-assembled loader (the script's test and
    test_torch_data_train's resume run the fused step with frames on the
    device, test_torch_data_train the fused step on host-decoded images):
    finite losses near ln N."""
    _, tcfg = configs()
    loader = PretrainLoader(corpus, tcfg, 2, seed=0, num_workers=1, prefetch=1)
    logged = []
    run_pretraining(tcfg, loader, num_steps=1, device="cpu", log_every=0,
                    log_fn=lambda s, m: logged.append(m))
    assert len(logged) == 1
    assert all(math.isfinite(v) for m in logged for v in m.values())
    for head, ln_n in expected_init_losses(tcfg, 2).items():
        assert abs(logged[0][head] - ln_n) < 0.05, (head, logged[0][head], ln_n)


def test_pretrain_script_on_the_cpu(corpus, tmp_path, capsys):
    """scripts/pretrain_torch.py with --device cpu, --fused_data and
    --on_device_frames, from a YAML config."""
    import yaml

    from scripts.pretrain_torch import main

    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump({"model": {**TINY, "output_grid": [4, 4]},
                                        "data": DATA}))
    shards = os.path.join(os.path.dirname(corpus[0]), "s*.tfrecord")
    main([str(cfg_path), "-train_fns", shards, "-num_steps", "1", "-batch_size", "2",
          "-seed", "1", "--device", "cpu", "--fused_data", "--on_device_frames"])
    out = capsys.readouterr().out
    assert "step 0: " in out and "stuff_to_span=" in out


def test_device_feed_on_the_cpu():
    """The feed's dtypes: int64 goes as int32 and is widened back (or kept
    int32 for a raw batch), the narrow keys are cast, uint8 and f32 stay."""
    batch = {"tokens": np.arange(6, dtype=np.int64).reshape(2, 3),
             "images": np.linspace(0, 1, 8, dtype=np.float32).reshape(2, 4),
             "frames": np.arange(8, dtype=np.uint8), "magic": np.ones(2, np.float64)}
    out = next(iter(DeviceFeed([batch], "cpu", narrow={"images": torch.bfloat16})))
    assert out["tokens"].dtype == torch.int64 and out["tokens"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert out["images"].dtype == torch.bfloat16
    assert torch.equal(out["images"], torch.from_numpy(batch["images"]).to(torch.bfloat16))
    assert out["frames"].dtype == torch.uint8 and out["magic"].dtype == torch.float32
    raw = next(iter(DeviceFeed([batch], "cpu", widen_ints=False)))
    assert raw["tokens"].dtype == torch.int32 and raw["images"].dtype == torch.float32
    assert not DeviceFeed([], "cpu").pinned
    with pytest.raises(ValueError, match="int32"):
        DeviceFeed([], "cpu").to_device({"x": np.asarray([2**40])})
    assert model_batch({"a": torch.zeros(2, dtype=torch.int32)})["a"].dtype == torch.int64
