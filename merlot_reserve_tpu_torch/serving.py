"""Batched zero-shot inference service.

``VideoEmbedService`` runs ``batch_embed_video`` at one fixed batch size,
padding underfilled requests, so the card always sees the same shapes;
``DynamicBatcher`` coalesces concurrent requests into those batches.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Sequence

import numpy as np
import torch

from merlot_reserve_tpu_torch.tokenizer import MASK
from merlot_reserve_tpu_torch.utils.device import resolve_device

_FIELDS = ("images", "audio_clips", "tokens", "subseg_idxs")


class VideoEmbedService:
    """Fixed-shape batched ``embed_video`` server.

    :param model: a ``MerlotReserve`` whose parameters live on ``device``
    :param batch_size: every call runs at this batch; requests pad up to it
    :param device: where the model runs: the card unless the caller passes "cpu"
    """

    def __init__(self, model, batch_size: int = 8, device="cuda"):
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device != self.device:
            raise ValueError(f"model is on {model_device}, service device is {self.device}")
        self.model = model.eval()
        self.batch_size = batch_size
        self.stats: Dict[str, float] = {"batches": 0, "videos": 0, "seconds": 0.0}

    def embed(self, video_pres: Sequence[Dict]) -> np.ndarray:
        """Embed up to batch_size preprocessed videos -> [N, L, H] f32."""
        n = len(video_pres)
        if n == 0:
            raise ValueError("empty request: the output length is set by the inputs, "
                             "so an empty result has no shape")
        if n > self.batch_size:
            raise ValueError(f"{n} videos > batch size {self.batch_size}: use embed_stream")
        pad = [video_pres[0]] * (self.batch_size - n)
        stack = {k: np.stack([np.asarray(v[k]) for v in list(video_pres) + pad])
                 for k in _FIELDS}
        t0 = time.perf_counter()
        with torch.inference_mode():
            images = torch.from_numpy(stack["images"]).to(self.device, torch.float32)
            audio = torch.from_numpy(stack["audio_clips"]).to(self.device, torch.float32)
            tokens = torch.from_numpy(stack["tokens"]).to(self.device, torch.int64)
            subseg = torch.from_numpy(stack["subseg_idxs"]).to(self.device, torch.int64)
            out = self.model.batch_embed_video(images, audio, tokens, subseg)
            out = out[:n].float().cpu().numpy()
        self.stats["batches"] += 1
        self.stats["videos"] += n
        self.stats["seconds"] += time.perf_counter() - t0
        return out

    def embed_stream(self, video_pres: Sequence[Dict]) -> np.ndarray:
        """Embed any number (>= 1) of videos, batch by batch."""
        if not video_pres:
            raise ValueError("empty request (see embed)")
        return np.concatenate([self.embed(video_pres[i:i + self.batch_size])
                               for i in range(0, len(video_pres), self.batch_size)], 0)

    def mask_features(self, video_pres: Sequence[Dict]) -> np.ndarray:
        """[N, H] embedding at each video's first MASK token."""
        out = self.embed_stream(video_pres)
        return np.stack([out[i, int(np.argmax(np.asarray(vp["tokens"]) == MASK))]
                         for i, vp in enumerate(video_pres)])

    @property
    def throughput(self) -> float:
        """Videos per second over the service lifetime."""
        return self.stats["videos"] / max(self.stats["seconds"], 1e-9)


class DynamicBatcher:
    """Queue-fed dynamic batching on top of :class:`VideoEmbedService`.

    Requests submit from any thread and get a Future; one dispatcher thread
    flushes a batch when ``batch_size`` requests are pending or the oldest
    pending request has waited ``max_wait_ms``. Underfilled flushes pad to
    the fixed batch (the service does).

    >>> with DynamicBatcher(service, max_wait_ms=5.0) as b:
    ...     futs = [b.submit(vp) for vp in video_pres]
    ...     embs = [f.result() for f in futs]
    """

    def __init__(self, service: VideoEmbedService, max_wait_ms: float = 10.0):
        self.service = service
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        # guards the closed-check + enqueue pair: without it a submit could pass
        # the check and enqueue after close()'s sentinel, and its Future would
        # never resolve
        self._lock = threading.Lock()
        self.batch_fills: List[int] = []
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    def submit(self, video_pre: Dict) -> Future:
        """Enqueue one preprocessed video; returns a Future of its [L, H] embedding."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.put((video_pre, fut))
        return fut

    def _dispatch(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if item is None:
                return
            pending = [item]
            deadline = time.monotonic() + self.max_wait
            while len(pending) < self.service.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(pending)
                    return
                pending.append(nxt)
            self._flush(pending)

    def _flush(self, pending):
        self.batch_fills.append(len(pending))
        try:
            out = self.service.embed([vp for vp, _ in pending])
        except Exception as e:  # noqa: BLE001 — deliver to the callers, keep the thread
            for _, fut in pending:
                fut.set_exception(e)
            return
        for i, (_, fut) in enumerate(pending):
            fut.set_result(out[i])

    def close(self):
        """Flush every accepted request, then stop the thread."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            # FIFO + the lock: every accepted item precedes the sentinel
            self._q.put(None)
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
