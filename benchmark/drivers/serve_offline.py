"""Traffic driver ``serve_offline``: one caller in a closed loop sends
``VideoEmbedService.embed`` a batch of preprocessed videos, takes the numpy
result, and sends the next.

The videos come from a pool made in set-up from the seed (frames and audio
drawn on the device and brought to the host once; tokens on the host): each
has ``segments`` segments, ``tokens`` token positions of which the first
``audio_tokens`` are audio spans (six a subsegment) and the rest padding,
and half of the pool, chosen by the seed, carries text in place of the last
``text_subsegments`` subsegments' audio. Every seed has the same sizes.
Requests cycle through the pool in a seeded order, a round being one pass
over it. The answers of every ``kept_round``-th round, from a round drawn
from the seed, are kept and compared, once the window has closed, with the
reference's embedding of the same videos; the others are dropped as a
corpus job drops what it has written out.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from frozen import bounds, flops
from harness import checks, weights
from harness.config import port_config
from reference import model as ref

AUDIOSPAN = ref.AUDIOSPAN


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.cfg = cell.config
        self.mix = cell.traffic
        self.seed = seed
        self.device = torch.device(device)
        self.B = self.mix["batch_size"]
        self.latencies: List[float] = []
        self.answers: List[Tuple[int, np.ndarray]] = []
        self.kept_round = self.mix["kept_round"]
        self.first_kept = weights.derive(seed, "kept") % self.kept_round

    # -- inputs ---------------------------------------------------------

    def make_pool(self) -> None:
        m, mix = self.cfg.model, self.mix
        V, S, T, A = mix["pool_videos"], mix["segments"], mix["tokens"], mix["audio_tokens"]
        gen = torch.Generator(device=self.device).manual_seed(weights.derive(self.seed, "videos"))
        images = torch.randn((V, S, m.vit_seq_len, m.vit_patch_size ** 2 * 3), generator=gen,
                             device=self.device).cpu().numpy()
        audio = torch.randn((V, 3 * S, m.audio_seq_length, m.audio_num_mels + 1), generator=gen,
                            device=self.device).cpu().numpy()
        rng = np.random.RandomState(weights.derive(self.seed, "tokens") % 2 ** 32)
        tokens = np.zeros((V, T), np.int32)
        tokens[:, :A] = AUDIOSPAN
        text = A - mix["text_subsegments"] * m.audio_token_length
        for v in rng.permutation(V)[:V // 2]:
            tokens[v, text:A] = rng.randint(10, m.vocab_size, A - text)
        subseg = np.zeros((V, T), np.int32)
        subseg[:, :A] = np.arange(A) // m.audio_token_length
        self.pool = {"images": images, "audio_clips": audio, "tokens": tokens,
                     "subseg_idxs": subseg}
        order = rng.permutation(V)
        self.requests = [order[np.arange(r * self.B, (r + 1) * self.B) % V]
                         for r in range(V // self.B)]
        self.videos = [{k: self.pool[k][v] for k in self.pool} for v in range(V)]

    def make_inputs(self) -> None:
        self.make_pool()

    # -- the program ----------------------------------------------------

    def setup(self) -> None:
        from merlot_reserve_tpu_torch.models.model import MerlotReserve
        from merlot_reserve_tpu_torch.serving import VideoEmbedService

        pc = port_config(self.cfg)
        w = weights.make(self.cfg, self.seed, self.device)
        model = MerlotReserve(pc, device="meta").to_empty(device=self.device)
        weights.load_into(model, w)
        del w
        self.service = VideoEmbedService(model, batch_size=self.B, device=self.device)
        self.make_inputs()
        for i in range(self.mix["warmup_requests"]):
            self.service.embed(self.request(i))

    def request(self, i: int):
        return [self.videos[v] for v in self.requests[i % len(self.requests)]]

    def iterate(self, i: int) -> None:
        videos = self.request(i)
        t0 = time.perf_counter()
        out = self.service.embed(videos)
        self.latencies.append(time.perf_counter() - t0)
        r, rnd = i % len(self.requests), i // len(self.requests)
        if rnd % self.kept_round == self.first_kept:
            self.answers.append((r, out))

    def window_metrics(self, iterations: int, seconds: float) -> Dict[str, float]:
        return {"serve_videos_per_s": iterations * self.B / seconds}

    def host_readings(self, traced: int) -> Dict[str, object]:
        return {"latencies_ms": [t * 1e3 for t in self.latencies[traced:]]}

    def attempted(self, iterations: int):
        limit = self.cell.limits.get("row_err", float("inf"))
        return iterations, int(sum(not (e <= limit) for e in getattr(self, "errors", [])))

    # -- what the traced iterations asked of the card -------------------

    def work(self, iterations: int) -> Dict[str, float]:
        m = self.cfg.model
        per_request = []
        for r in range(len(self.requests)):
            tokens = torch.from_numpy(self.pool["tokens"][self.requests[r]]).to(self.device)
            valid, seg = ref.serving_labels(self.cfg, tokens, self.mix["segments"])
            per_request.append(m.joint_num_layers * bounds.fwd_bound(
                valid, seg, m.num_heads, m.size_per_head, "bf16", 2)["bound_ms"])
        traced = sum(per_request[i % len(per_request)] for i in range(iterations))
        return {"flops_per_iteration": flops.encode_flops(self.cfg, self.B, self.mix["segments"]),
                "peak_flops": flops.PEAK_BF16_FLOPS, "flash_fwd_bound_s": traced / 1e3,
                "iterations": iterations}

    # -- after the window -----------------------------------------------

    def release(self) -> None:
        del self.service
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, kind: str = "f32") -> np.ndarray:
        """[pool, tokens, H]: the reference's embedding of every pool video."""
        w = weights.make(self.cfg, self.seed, self.device)
        out = []
        with torch.no_grad():
            for s in range(0, self.mix["pool_videos"], self.B):
                args = [torch.from_numpy(self.pool[k][s:s + self.B]).to(self.device)
                        for k in ("images", "audio_clips", "tokens", "subseg_idxs")]
                args[2], args[3] = args[2].long(), args[3].long()
                out.append(ref.embed_video(w.views, self.cfg, *args,
                                           nm=ref.Numerics(kind, remat=False)).cpu().numpy())
        del w
        return np.concatenate(out)

    def _row_errors(self, answers, reference) -> List[float]:
        valid = self.pool["tokens"] != ref.PADDING
        errs = []
        for r, out in answers:
            v = self.requests[r]
            errs.append(checks.row_error(out, reference[v], valid[v]))
        return errs

    def numbers(self) -> Dict[str, float]:
        """The widest row error over the kept answers (infinite where none
        was kept: nothing checked is not correct)."""
        self.errors = self._row_errors(self.answers, self.reference("f32"))
        return {"row_err": max(self.errors, default=float("inf"))}

    def control_numbers(self) -> Dict[str, float]:
        control = self.reference("fp8")
        answers = [(r, control[self.requests[r]]) for r in range(len(self.requests))]
        return {"row_err": max(self._row_errors(answers, self.reference("f32")))}
