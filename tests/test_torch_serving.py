"""merlot_reserve_tpu_torch/serving.py on device="cpu": padding to the fixed
batch, micro-batching, futures, drain on close, and error delivery. The
model is a tiny random port model; outputs are held against the model's own
batch_embed_video (padding must not change the rows that are kept)."""

import sys
import threading

import numpy as np
import pytest
import torch

from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch.models import MerlotReserve
from merlot_reserve_tpu_torch.serving import DynamicBatcher, VideoEmbedService
from merlot_reserve_tpu_torch.tokenizer import AUDIOSPAN, MASK

TINY = dict(hidden_size=128, joint_num_layers=1, vit_num_layers=1, audio_num_layers=1,
            span_num_layers=1, output_grid=(4, 4), use_bfloat16=False,
            joint_attention_impl="flash")


@pytest.fixture(scope="module")
def model():
    return MerlotReserve(load_config("base", **TINY), device="cpu", seed=0)


def _videos(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tokens = np.zeros(16, np.int32)
        tokens[:12] = AUDIOSPAN
        tokens[12] = MASK
        tokens[13:14] = rng.randint(10, 1000, 1)
        subseg = np.zeros(16, np.int32)
        subseg[:12] = np.arange(12) // 6
        subseg[12:14] = [2, 3]
        out.append({"images": rng.randn(2, 16, 768).astype(np.float32),
                    "audio_clips": rng.randn(6, 60, 65).astype(np.float32),
                    "tokens": tokens, "subseg_idxs": subseg})
    return out


def _direct(model, videos):
    with torch.no_grad():
        return model.batch_embed_video(
            *[torch.from_numpy(np.stack([v[k] for v in videos])).to(dt) for k, dt in
              (("images", torch.float32), ("audio_clips", torch.float32),
               ("tokens", torch.int64), ("subseg_idxs", torch.int64))]).numpy()


def test_embed_pads_underfilled_batches(model):
    svc = VideoEmbedService(model, batch_size=4, device="cpu")
    videos = _videos(3)
    out = svc.embed(videos)
    assert out.shape == (3, 16, 128) and out.dtype == np.float32
    np.testing.assert_allclose(out, _direct(model, videos), atol=1e-6, rtol=0)
    assert svc.stats["batches"] == 1 and svc.stats["videos"] == 3
    assert svc.throughput > 0


def test_embed_rejects_empty_and_oversized_requests(model):
    svc = VideoEmbedService(model, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        svc.embed([])
    with pytest.raises(ValueError, match="embed_stream"):
        svc.embed(_videos(3))
    with pytest.raises(ValueError, match="empty"):
        svc.embed_stream([])


def test_embed_stream_and_mask_features(model):
    svc = VideoEmbedService(model, batch_size=2, device="cpu")
    videos = _videos(5, seed=1)
    out = svc.embed_stream(videos)
    assert out.shape == (5, 16, 128) and svc.stats["batches"] == 3
    np.testing.assert_allclose(out, _direct(model, videos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(svc.mask_features(videos), out[:, 12], atol=0, rtol=0)


def test_service_refuses_a_model_on_another_device(model):
    with pytest.raises((ValueError, RuntimeError)):
        VideoEmbedService(model, batch_size=2, device="meta")


def test_dynamic_batcher_resolves_every_future_and_drains_on_close(model):
    svc = VideoEmbedService(model, batch_size=4, device="cpu")
    videos = _videos(7, seed=2)
    batcher = DynamicBatcher(svc, max_wait_ms=10_000)  # only a full batch or close() flushes
    futures = [batcher.submit(v) for v in videos]
    batcher.close()
    assert not batcher._thread.is_alive()
    results = np.stack([f.result(timeout=60) for f in futures])
    np.testing.assert_allclose(results, _direct(model, videos), atol=1e-6, rtol=0)
    assert sum(batcher.batch_fills) == 7 and max(batcher.batch_fills) <= 4
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(videos[0])
    batcher.close()  # idempotent


def test_dynamic_batcher_delivers_errors_and_keeps_serving(model):
    svc = VideoEmbedService(model, batch_size=2, device="cpu")
    bad = dict(_videos(1)[0], audio_clips=np.zeros((5, 60, 65), np.float32))
    with DynamicBatcher(svc, max_wait_ms=1.0) as batcher:
        with pytest.raises(ValueError):
            batcher.submit(bad).result(timeout=60)
        good = batcher.submit(_videos(1)[0]).result(timeout=60)
    assert good.shape == (16, 128)


def test_dynamic_batcher_under_concurrent_submitters(model):
    svc = VideoEmbedService(model, batch_size=4, device="cpu")
    videos = _videos(4, seed=3)
    expected = _direct(model, videos)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with DynamicBatcher(svc, max_wait_ms=2.0) as batcher:
            futures = {}
            lock = threading.Lock()

            def submit(tid):
                for i in range(6):
                    fut = batcher.submit(videos[(tid + i) % 4])
                    with lock:
                        futures[(tid, i)] = fut

            threads = [threading.Thread(target=submit, args=(t,)) for t in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        for (tid, i), fut in futures.items():
            np.testing.assert_allclose(fut.result(timeout=60), expected[(tid + i) % 4],
                                       atol=1e-6, rtol=0)
    finally:
        sys.setswitchinterval(old)
    assert len(futures) == 24 and sum(batcher.batch_fills) == 24
