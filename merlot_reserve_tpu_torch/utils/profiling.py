"""Throughput meters and the analytic FLOP counts behind MFU (copies of the
JAX package's ``utils/profiling.py`` helpers), and the peak rates of the
CUDA cards the port knows.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

import torch

# bf16 dense peak FLOP/s by card name (NVIDIA data sheets, without sparsity)
CUDA_PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM5 at its 700 W limit
}


class ThroughputMeter:
    """Rolling it/sec + examples/sec meter (train.py:141-145's loop print,
    structured)."""

    def __init__(self, window: int = 100, batch_size: Optional[int] = None):
        self.window = window
        self.batch_size = batch_size
        self._t0 = time.time()
        self._count = 0

    def step(self) -> Optional[Dict[str, float]]:
        self._count += 1
        if self._count % self.window:
            return None
        dt = time.time() - self._t0
        self._t0 = time.time()
        out = {"it_per_sec": self.window / dt}
        if self.batch_size:
            out["examples_per_sec"] = self.window * self.batch_size / dt
        return out


def log_jsonl(path: str, record: Dict):
    """Append one JSON line (metrics stream consumable by any dashboard)."""
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def device_peak_flops(device=None) -> Optional[float]:
    """bf16 dense peak FLOP/s of a CUDA ``device`` (the current card when
    None), or None for a device it does not know (the CPU included)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return CUDA_PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device))


def transformer_layer_flops(seq_len: int, hidden: int, mlp_ratio: int = 4) -> float:
    """Forward matmul FLOPs of one pre-LN transformer layer on seq_len
    tokens: QKV+out projections (8*S*H^2), attention score+mix (4*S^2*H),
    MLP (2 * 2*S*H*rH)."""
    s, h = float(seq_len), float(hidden)
    return 8 * s * h * h + 4 * s * s * h + 2 * 2 * s * h * (mlp_ratio * h)


def encode_flops(cfg, n_videos: int, n_segments: int,
                 include_preprocess: bool = False) -> float:
    """Analytic forward FLOPs of embed_video (modeling.py:806-843 workload):
    vision tower over every segment, audio tower over every subsegment,
    joint transformer per video. Matmul terms only (layernorms/softmax/GELU
    are bandwidth-, not FLOP-, relevant)."""
    m = cfg.model
    h = float(m.hidden_size)
    flops = 0.0

    # vision tower: [n_videos*n_segments] x (CLS + grid tokens)
    s_vit = m.vit_seq_len + 1
    n_seg_total = n_videos * n_segments
    flops += n_seg_total * m.vit_num_layers * transformer_layer_flops(s_vit, h)
    flops += n_seg_total * 2 * m.vit_seq_len * (16 * 16 * 3) * h  # patch embed
    # 2x2 attention pool: one MHA layer over the grid
    flops += n_seg_total * (4 * m.vit_seq_len * h * h
                            + 4 * m.vit_seq_len * (m.vit_seq_len / 4) * h)

    # audio tower: [n_videos*n_segments*3 subsegments] x (CLS + patched frames)
    s_aud = m.audio_seq_length // m.audio_patch_size + 1
    n_sub = n_seg_total * 3
    flops += n_sub * m.audio_num_layers * transformer_layer_flops(s_aud, h)
    flops += n_sub * 2 * (s_aud - 1) * (m.audio_patch_size * 65) * h
    flops += n_sub * (4 * (s_aud - 1) * h * h
                      + 4 * (s_aud - 1) * m.audio_token_length * h)  # attnpool

    # joint transformer: per video, lang + pooled vision tokens
    s_joint = (cfg.data.lang_seq_len
               + n_segments * m.vit_pooled_seq_len)
    flops += n_videos * m.joint_num_layers * transformer_layer_flops(s_joint, h)
    flops += n_videos * 2 * s_joint * h * h  # joint_proj head

    if include_preprocess:
        # mel matmul-DFT: frames [188, n_fft] @ cos/sin [n_fft, n_bins]
        n_fft, n_bins, n_frames = 1536, 769, 188
        flops += n_seg_total * (2 * 2 * n_frames * n_fft * n_bins
                                + 2 * n_frames * n_bins * 64)
    return flops


def pretrain_step_flops(cfg, batch_size: int) -> float:
    """Analytic matmul FLOPs of one full pretraining train step
    (pretrain_model.py:38-258 workload): vision tower over every segment,
    audio tower over every subsegment, span tower over the text-span
    targets, the fused 4-stream joint call, x3 for forward+backward."""
    m, d = cfg.model, cfg.data
    h = float(m.hidden_size)
    B = batch_size
    f = 0.0

    # vision tower over B * num_segments frames (+ patch embed + attnpool)
    n_seg = B * d.num_segments
    s_vit = m.vit_seq_len + 1
    f += n_seg * m.vit_num_layers * transformer_layer_flops(s_vit, h)
    f += n_seg * 2 * m.vit_seq_len * (16 * 16 * 3) * h
    f += n_seg * (4 * m.vit_seq_len * h * h
                  + 4 * m.vit_seq_len * (m.vit_seq_len / 4) * h)

    # audio tower over every subsegment
    s_aud = m.audio_seq_length // m.audio_patch_size + 1
    n_sub = n_seg * d.num_audio_subsegments
    f += n_sub * m.audio_num_layers * transformer_layer_flops(s_aud, h)
    f += n_sub * 2 * (s_aud - 1) * (m.audio_patch_size * 65) * h
    f += n_sub * (4 * (s_aud - 1) * h * h
                  + 4 * (s_aud - 1) * m.audio_token_length * h)

    # span tower over the text-span targets (+CLS)
    n_spans = B * d.num_text_spans_to_include
    f += n_spans * m.span_num_layers * transformer_layer_flops(
        m.text_span_length + 1, h)

    # the ONE fused joint call: per example, num_segment_groups rows each for
    # audio2text/text2audio (x their seq multipliers) + matching + random_text
    rows = B * (d.num_segment_groups * (d.num_audio2text_seqs
                                        + d.num_text2audio_seqs)
                + 1 + d.num_text_seqs)
    f += rows * m.joint_num_layers * transformer_layer_flops(d.seq_len, h)
    f += rows * 2 * d.seq_len * h * h  # joint_proj

    return 3.0 * f  # backward ~= 2x forward for matmul-dominated graphs
