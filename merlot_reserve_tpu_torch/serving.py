"""Batched zero-shot inference service.

``VideoEmbedService`` runs ``batch_embed_video`` at one fixed batch size,
padding underfilled requests, so the card always sees the same shapes;
``DynamicBatcher`` coalesces concurrent requests into those batches.
"""

from __future__ import annotations

import contextvars
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Sequence

import numpy as np
import torch

from merlot_reserve_tpu_torch.parallel.mesh import current_mesh
from merlot_reserve_tpu_torch.tokenizer import MASK
from merlot_reserve_tpu_torch.utils.device import resolve_device

FIELDS = ("images", "audio_clips", "tokens", "subseg_idxs")
# the dtypes ``batch_embed_video`` takes its batch in
DTYPES = {"images": torch.float32, "audio_clips": torch.float32, "tokens": torch.int64,
          "subseg_idxs": torch.int64}


def stage_batch(video_pres: Sequence[Dict], batch_size: int, device) -> List[torch.Tensor]:
    """1 to ``batch_size`` preprocessed videos -> the model's batch on
    ``device``, one tensor per field of ``FIELDS``: padded with the first
    request up to ``batch_size``, stacked, copied in its model dtype."""
    pad = [video_pres[0]] * (batch_size - len(video_pres))
    return [torch.from_numpy(np.stack([np.asarray(v[k]) for v in (*video_pres, *pad)]))
            .to(device, DTYPES[k]) for k in FIELDS]


def embed_in_batches(embed, video_pres: Sequence[Dict], batch_size: int) -> np.ndarray:
    """``embed`` over ``video_pres`` in slices of ``batch_size`` -> [N, L, H]."""
    return np.concatenate([embed(video_pres[i:i + batch_size])
                           for i in range(0, len(video_pres), batch_size)], 0)


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
        t0 = time.perf_counter()
        with torch.inference_mode():
            batch = stage_batch(video_pres, self.batch_size, self.device)
            out = self.model.batch_embed_video(*batch)[:n].float().cpu().numpy()
        self.stats["batches"] += 1
        self.stats["videos"] += n
        self.stats["seconds"] += time.perf_counter() - t0
        return out

    def embed_stream(self, video_pres: Sequence[Dict]) -> np.ndarray:
        """Embed any number (>= 1) of videos, batch by batch."""
        if not video_pres:
            raise ValueError("empty request (see embed)")
        return embed_in_batches(self.embed, video_pres, self.batch_size)

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
    the fixed batch (the service does). Each request carries a copy of its
    caller's context (``contextvars``), and a batch runs in its first
    request's: a model served under ``parallel.mesh.activate_mesh`` keeps
    its mesh on the dispatcher thread, so a ``ring:*`` joint tower runs
    sequence parallel there as it does when called directly. Requests
    submitted under different meshes (or one under none) never share a
    batch: a request whose mesh differs from the pending batch's flushes
    that batch and starts the next.

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
            self._q.put((video_pre, fut, contextvars.copy_context()))
        return fut

    def _dispatch(self):
        carried = None  # a request that ended the batch before it (another mesh)
        while True:
            if carried is not None:
                item, carried = carried, None
            else:
                try:
                    item = self._q.get(timeout=0.1)
                except queue.Empty:
                    if self._closed:
                        return
                    continue
            if item is None:
                return
            pending = [item]
            mesh = item[2].run(current_mesh)
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
                if nxt[2].run(current_mesh) is not mesh:
                    carried = nxt
                    break
                pending.append(nxt)
            self._flush(pending)

    def _flush(self, pending):
        self.batch_fills.append(len(pending))
        context = pending[0][2]
        try:
            out = context.run(self.service.embed, [vp for vp, _, _ in pending])
        except Exception as e:  # noqa: BLE001 — deliver to the callers, keep the thread
            for _, fut, _ in pending:
                fut.set_exception(e)
            return
        for i, (_, fut, _) in enumerate(pending):
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
