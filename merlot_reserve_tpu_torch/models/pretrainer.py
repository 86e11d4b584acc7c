"""Pretraining objective: three symmetric InfoNCE heads over one fused
joint-transformer call.

The port of ``merlot_reserve_tpu/models/pretrainer.py``, in its four named
stages:

  1. ``encode_towers``     every frame, audio subsegment and token stream
                           encoded once, in batched calls;
  2. ``fuse_streams``      the four task streams concatenated into ONE
                           joint-transformer call;
  3. ``pool_*_targets``    contrastive (x, y) pairs pooled out of the joint
                           outputs;
  4. ``contrastive_heads`` learned temperatures and unit normalization.

Randomness (the packed-video split augmentation and the Gumbel draw of span
targets) comes from an explicit ``torch.Generator``. By default it is seeded
from the batch's content, as the JAX package keys its draws on the content
(``content_generator``), so a batch draws the same numbers every time. The
port cannot reproduce ``jax.random`` bits: a test injects both draws
(``split_at``, ``gumbel``) so that the two packages see the same numbers.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from merlot_reserve_tpu_torch.models.layers import linear
from merlot_reserve_tpu_torch.models.model import MerlotReserve
from merlot_reserve_tpu_torch.ops.pooling import one_hot_pool, unit_normalize
from merlot_reserve_tpu_torch.parallel.mesh import dp_anchor, rows_anchor
from merlot_reserve_tpu_torch.tokenizer import LTOVPOOL, MASK, MASKAUDIO, PADDING

# multimodal spans are preferred 4:1 over text-only spans when drawing
# contrastive span targets
_MULTIMODAL_PREFERENCE = math.log(4)

# pseudo-video ids offset far past any real video_src_index so a split can
# never collide with another packed video's id
_SPLIT_ID_STRIDE = 4

_SCALE_SLOT = {"imgs_to_audio": 0, "text_to_audio": 1, "stuff_to_span": 2}
_SPAN_SOURCES = ("text2audio", "audio2text", "random_text")


class MerlotReservePretrainer(MerlotReserve):
    """The 4-stream contrastive pretrainer head over the MerlotReserve towers.

    ``forward(batch)`` takes a ``make_dummy_batch``-shaped dict of tensors on
    the model's device and returns the three heads' inputs for
    ``loss_fn_given_preds``.
    """

    def __init__(self, config, device="cuda", seed: int = 0):
        super().__init__(config, device=device, seed=seed)
        self.data = config.data

    # ------------------------------------------------------------------
    # stage 1: modality towers
    # ------------------------------------------------------------------

    def encode_towers(self, batch: Dict[str, torch.Tensor]):
        """Run each modality tower once over the whole batch, and flatten the
        token streams to the [rows, L] layout every later stage consumes."""
        cfg, data = self.config, self.data
        B, num_segments_nvpatch0, patch_dim = batch["images"].shape
        patches_per_frame = cfg.vit_seq_len
        num_segments = num_segments_nvpatch0 // patches_per_frame
        segs_per_group = num_segments // data.num_segment_groups

        # segment sharding: the towers never mix rows, so their [B x
        # segments] inputs may split over segment_shard_axis as well as dp
        # (a hint, as in the JAX package; parallel.mesh.rows_anchor)
        seg_axis = cfg.segment_shard_axis
        vision = self.vision_encoder(rows_anchor(
            batch["images"].reshape(B * num_segments, patches_per_frame, patch_dim),
            extra_axis=seg_axis))
        frames_by_group = vision["seq_attnpool"].reshape(
            B, data.num_segment_groups, segs_per_group * cfg.vit_pooled_seq_len,
            cfg.hidden_size)

        audio = self.audio_encoder(rows_anchor(batch["audio_clips"].reshape(
            B * num_segments * data.num_audio_subsegments, cfg.audio_seq_length, -1),
            extra_axis=seg_axis))
        num_audio_spans = num_segments * data.num_audio_subsegments
        audio_span_tokens = audio["seq_attnpool"].reshape(
            B, num_audio_spans, cfg.audio_token_length, cfg.hidden_size)
        audio_span_cls = audio["cls"].reshape(B, num_audio_spans, cfg.hidden_size)

        flat = dict(batch)
        for stream in ("text2audio", "audio2text"):
            for suffix in ("", "/audio_ptr", "/text_ptr"):
                flat[stream + suffix] = flat[stream + suffix].reshape(-1, data.lang_seq_len)
        for key in ("random_text", "random_text/text_ptr",
                    "audio_text_matching", "audio_text_matching/audio_ptr"):
            flat[key] = flat[key].reshape(-1, data.seq_len)
        flat["text_spans"] = flat["text_spans"].reshape(-1, cfg.text_span_length)
        flat["video_src_index"] = flat["video_src_index"].reshape(-1, segs_per_group)

        token_embs = self.token_encoder(
            {k: flat[k] for k in ("text2audio", "audio2text", "audio_text_matching",
                                  "text_spans", "random_text")})
        return {
            "batch_size": B,
            "num_segments": num_segments,
            "segs_per_group": segs_per_group,
            "num_audio_spans": num_audio_spans,
            "vision_cls": vision["cls"],
            "frames_by_group": frames_by_group,
            "audio_span_tokens": audio_span_tokens,
            "audio_span_cls": audio_span_cls,
            "token_embs": token_embs,
            "flat": flat,
        }

    # ------------------------------------------------------------------
    # stage 2: stream fusion
    # ------------------------------------------------------------------

    def draw_split_at(self, rows: int, segs_per_group: int,
                      generator: torch.Generator) -> torch.Tensor:
        """``_split_packed_videos``'s draw: for each of ``rows`` rows, the
        segment at which a packed video splits (segs_per_group = no split,
        probability 0.9; each earlier segment 0.1 / (segs_per_group - 1))."""
        n = segs_per_group
        probs = torch.tensor([0.1 / (n - 1)] * (n - 1) + [0.9], device=generator.device)
        return 1 + torch.multinomial(probs, rows, replacement=True, generator=generator)

    def _split_packed_videos(self, video_src_idx, generator=None, split_at=None):
        """Data augmentation: with probability 0.1 split a packed video's
        segments into two pseudo-videos (ids offset past any real id) so that
        short-clip attention patterns appear during training.

        :param split_at: [rows] ints in [1, L]; drawn from ``generator`` if None
        """
        B, L = video_src_idx.shape
        if L == 1:
            return video_src_idx
        if split_at is None:
            split_at = self.draw_split_at(B, L, generator)
        is_tail = split_at.to(video_src_idx.device)[:, None] <= torch.arange(
            L, device=video_src_idx.device)[None]
        return torch.where(is_tail, video_src_idx + _SPLIT_ID_STRIDE * L, video_src_idx)

    def fuse_streams(self, towers, generator=None,
                     split_at: Optional[Sequence[torch.Tensor]] = None):
        """Assemble the four task streams and run them through ONE joint call.

        :param split_at: (audio2text, text2audio) draws for
            ``_split_packed_videos``; drawn from ``generator`` if None
        """
        cfg, data = self.config, self.data
        flat = towers["flat"]
        B = towers["batch_size"]
        segs_per_group = towers["segs_per_group"]
        frames = towers["frames_by_group"]
        vis_len = frames.shape[-2]
        if split_at is None:
            split_at = (None, None)

        def packed_ids(n_seqs, draw):
            tiled = flat["video_src_index"].reshape(B, data.num_segment_groups, segs_per_group) \
                .repeat(1, n_seqs, 1).reshape(-1, segs_per_group)
            return self._split_packed_videos(tiled, generator, draw)

        def segment_idx(ptr):
            return (ptr // data.num_audio_subsegments) % segs_per_group

        token_embs = towers["token_embs"]
        streams = {}
        streams["audio2text"] = self.prepare_multimodal_inputs(
            tokens=flat["audio2text"],
            token_segment_idx=segment_idx(flat["audio2text/audio_ptr"]),
            token_embs=token_embs["audio2text"],
            vision_input=frames.repeat(1, data.num_audio2text_seqs, 1, 1).reshape(
                -1, vis_len, cfg.hidden_size),
            audio_spans=towers["audio_span_tokens"].repeat_interleave(
                data.num_segment_groups * data.num_audio2text_seqs, dim=0),
            audio_pointers=flat["audio2text/audio_ptr"],
            padding_len=data.seq_len,
            video_src_idx=packed_ids(data.num_audio2text_seqs, split_at[0]),
        )
        streams["audio_text_matching"] = self.prepare_multimodal_inputs(
            tokens=flat["audio_text_matching"],
            token_segment_idx=torch.cumsum(flat["audio_text_matching"] == LTOVPOOL, -1),
            token_embs=token_embs["audio_text_matching"],
            audio_spans=towers["audio_span_tokens"],
            audio_pointers=flat["audio_text_matching/audio_ptr"],
            padding_len=data.seq_len,
        )
        streams["text2audio"] = self.prepare_multimodal_inputs(
            tokens=flat["text2audio"],
            token_segment_idx=segment_idx(flat["text2audio/audio_ptr"]),
            token_embs=token_embs["text2audio"],
            vision_input=frames.repeat(1, data.num_text2audio_seqs, 1, 1).reshape(
                -1, vis_len, cfg.hidden_size),
            audio_pointers=flat["text2audio/audio_ptr"],
            padding_len=data.seq_len,
            video_src_idx=packed_ids(data.num_text2audio_seqs, split_at[1]),
        )
        streams["random_text"] = self.prepare_multimodal_inputs(
            tokens=flat["random_text"], token_embs=token_embs["random_text"],
            padding_len=data.seq_len)

        # example-major fusion: every stream is [B * n_k, ...]; concatenating
        # as [B, n_k, ...] keeps one example's rows together, in stream order
        order = sorted(streams)
        rows_per_ex = [streams[k]["x"].shape[0] // B for k in order]

        def bmajor_concat(key):
            parts = [streams[k][key].reshape((B, n) + streams[k][key].shape[1:])
                     for k, n in zip(order, rows_per_ex)]
            cat = torch.cat(parts, 1)
            return cat.reshape((-1,) + cat.shape[2:])

        # the joint rows are the batch dim: a dp hint, as in the JAX package
        x, is_valid, segment_ids = dp_anchor(
            bmajor_concat("x"), bmajor_concat("is_valid"), bmajor_concat("segment_ids"))
        fused = self.joint_transformer(
            x, rotary_coords=dp_anchor(bmajor_concat("rotary_coords")) if cfg.do_rotary else None,
            is_valid=is_valid, segment_ids=segment_ids)["seq"]
        fused = linear(fused, self.head, self.dtype)

        fused = fused.reshape((B, sum(rows_per_ex)) + fused.shape[1:])
        parts = torch.split(fused, rows_per_ex, dim=1)
        outputs = {k: p.reshape((-1,) + p.shape[2:]) for k, p in zip(order, parts)}
        # language positions only for the two span-target streams
        outputs["text2audio"] = outputs["text2audio"][:, :data.lang_seq_len]
        outputs["audio2text"] = outputs["audio2text"][:, :data.lang_seq_len]
        return outputs

    # ------------------------------------------------------------------
    # stage 3: target pooling
    # ------------------------------------------------------------------

    def pool_matching_targets(self, towers, stream_out):
        """imgs <-> audio head inputs: the joint state at each LTOVPOOL token
        (one per segment) against that segment's vision CLS."""
        flat = towers["flat"]
        at_pool_token = flat["audio_text_matching"] == LTOVPOOL
        segment_slot = torch.cumsum(at_pool_token.long(), -1) - 1
        pooled = one_hot_pool(at_pool_token, idx=segment_slot,
                              v=stream_out["audio_text_matching"],
                              num_segments=towers["num_segments"])["x"]
        return pooled.reshape(towers["batch_size"] * towers["num_segments"],
                              self.config.hidden_size)

    def pool_audio_span_targets(self, towers, stream_out):
        """text -> audio head inputs: joint states pooled at MASKAUDIO
        positions into their audio-span slot. The most-masked slots (stable
        order on ties) become (x, y) pairs against their audio CLS, and
        every other span's CLS joins the denominator as an extra negative."""
        data = self.data
        flat = towers["flat"]
        B = towers["batch_size"]
        num_audio_spans = towers["num_audio_spans"]
        pooled = one_hot_pool(do_pool=flat["text2audio"] == MASKAUDIO,
                              idx=flat["text2audio/audio_ptr"], v=stream_out["text2audio"],
                              num_segments=num_audio_spans, real_bsize=B)
        num_targets = int(num_audio_spans * data.mask_rate) * data.num_text2audio_seqs
        times_masked = pooled["idx_oh"].sum(1)
        masked_first = torch.argsort(-times_masked, dim=-1, stable=True)

        rows = torch.arange(B, device=times_masked.device)
        target_slots = masked_first[:, :num_targets].reshape(B * num_targets)
        target_rows = rows.repeat_interleave(num_targets)
        masked_states = pooled["x"][target_rows, target_slots]
        masked_audio_cls = towers["audio_span_cls"][target_rows, target_slots]

        negative_slots = masked_first[:, num_targets:].reshape(B * (num_audio_spans - num_targets))
        negative_rows = rows.repeat_interleave(num_audio_spans - num_targets)
        negative_audio_cls = towers["audio_span_cls"][negative_rows, negative_slots]
        return masked_states, masked_audio_cls, negative_audio_cls

    def pool_text_span_targets(self, towers, stream_out, generator=None,
                               gumbel: Optional[torch.Tensor] = None):
        """stuff -> span head inputs: MASK-position joint states of the three
        text streams sum into per-span slots; usable slots are drawn by
        Gumbel top-k across the whole batch with multimodal spans preferred
        4:1, and the drawn spans' tokens go through the span tower as the
        target side. Also returns each drawn span's source stream.

        :param gumbel: [B, spans per example] f32 Gumbel noise; drawn from
            ``generator`` if None
        """
        data = self.data
        flat = towers["flat"]
        B = towers["batch_size"]
        hidden = self.config.hidden_size
        spans_per_example = towers["token_embs"]["text_spans"].shape[0] // B

        pools = {}
        for stream in ("audio2text", "text2audio", "random_text"):
            pools[stream] = one_hot_pool(flat[stream] == MASK, idx=flat[f"{stream}/text_ptr"],
                                         v=stream_out[stream], num_segments=spans_per_example,
                                         real_bsize=B)
            pools[stream]["count"] = pools[stream].pop("idx_oh").sum(1)

        summed_states = (pools["text2audio"]["x"] + pools["audio2text"]["x"]
                         + pools["random_text"]["x"])
        mask_counts = (pools["text2audio"]["count"] + pools["audio2text"]["count"]
                       + pools["random_text"]["count"])
        # source id per slot: 0/1/2 = text2audio/audio2text/random_text,
        # -1 = never masked (argmax over a leading zeros column, shifted)
        source_id = torch.stack(
            [torch.zeros_like(mask_counts)] + [pools[s]["count"] for s in _SPAN_SOURCES],
            -1).argmax(-1) - 1

        span_usable = (flat["text_spans"] != PADDING).any(-1).reshape(B, spans_per_example)
        span_usable = (span_usable & (mask_counts > 0)).float()

        # Gumbel top-k without replacement over the whole batch
        selection_logits = span_usable * 1e6 + _MULTIMODAL_PREFERENCE * (
            pools["text2audio"]["count"] + pools["audio2text"]["count"]).float()
        if gumbel is None:
            u = torch.rand((B, spans_per_example), generator=generator,
                           device=generator.device)
            gumbel = -torch.log(-torch.log(u))
        num_drawn = data.num_text_spans_to_include
        if num_drawn > spans_per_example:
            raise ValueError(f"num_text_spans_to_include {num_drawn} > {spans_per_example} "
                             "spans per example")
        # top k with ties in index order, as lax.top_k: at 1e6 an f32 step is
        # 0.0625, so two usable spans' noisy logits can round to one value
        drawn = torch.sort((selection_logits + gumbel.to(selection_logits.device)).reshape(-1),
                           descending=True, stable=True).indices[:num_drawn * B]

        drawn_states = summed_states.reshape(B * spans_per_example, hidden)[drawn]
        drawn_sources = source_id.reshape(B * spans_per_example)[drawn]
        span_x = towers["token_embs"]["text_spans"][drawn]
        span_valid = flat["text_spans"][drawn] != PADDING
        # the drawn spans are as independent as segments (rows_anchor above)
        drawn_states, span_x, span_valid = rows_anchor(
            drawn_states, span_x, span_valid, extra_axis=self.config.segment_shard_axis)
        span_targets = self.span_encoder(span_x, span_valid)
        return drawn_states, span_targets, drawn_sources

    # ------------------------------------------------------------------
    # stage 4: heads
    # ------------------------------------------------------------------

    def contrastive_heads(self, head_inputs):
        """Apply the three learned temperatures (log-scales clipped at
        log 100, exp(s / 2) put on both sides) and unit-normalize; cast to
        bf16 under the bf16 policy."""
        log_scales = self.contrastive_scales.float().clamp(max=math.log(100.0))
        for name, head in head_inputs.items():
            temp = torch.exp(log_scales[_SCALE_SLOT[name]] / 2.0)
            for side in ("x", "y", "x_extra", "y_extra"):
                if side in head:
                    v = unit_normalize(head[side]).float() * temp
                    head[side] = v.to(torch.bfloat16) if self.config.use_bfloat16 else v
        return head_inputs

    # ------------------------------------------------------------------

    def content_generator(self, towers) -> torch.Generator:
        """A generator seeded from the batch's content (the sum of the
        audio2text text pointers, the JAX package's content key), so that
        one batch always draws the same augmentation and span targets."""
        seed = int(towers["flat"]["audio2text/text_ptr"].sum())
        device = towers["flat"]["audio2text/text_ptr"].device
        return torch.Generator(device=device).manual_seed(seed)

    def forward(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                split_at: Optional[Sequence[torch.Tensor]] = None,
                gumbel: Optional[torch.Tensor] = None):
        towers = self.encode_towers(batch)
        if generator is None and (split_at is None or gumbel is None):
            generator = self.content_generator(towers)
        stream_out = self.fuse_streams(towers, generator, split_at)

        seg_states = self.pool_matching_targets(towers, stream_out)
        t2a_x, t2a_y, t2a_negatives = self.pool_audio_span_targets(towers, stream_out)
        span_x, span_y, span_sources = self.pool_text_span_targets(towers, stream_out,
                                                                   generator, gumbel)
        return self.contrastive_heads({
            "imgs_to_audio": {"x": seg_states, "y": towers["vision_cls"]},
            "text_to_audio": {"x": t2a_x, "y": t2a_y, "y_extra": t2a_negatives},
            "stuff_to_span": {"x": span_x, "y": span_y, "_sources": span_sources},
        })


def loss_fn_given_preds(preds: Dict) -> tuple:
    """Symmetric InfoNCE per head over the whole batch of targets. Keys
    prefixed '_' are diagnostics excluded from the total. The logits are
    products in the heads' dtype; the log-sum-exp runs in f32.

    :return: (total loss, {head: loss, '_<head>_from_<source>': loss})
    """
    loss_info = {}
    for c_type, c_dict in preds.items():
        numer_logits = (c_dict["x"] * c_dict["y"]).sum(-1).float()
        loss_info[c_type] = 0.0
        if "_sources" in c_dict:
            for k in _SPAN_SOURCES:
                loss_info[f"_{c_type}_from_{k}"] = 0.0

        for k1, k2 in ("xy", "yx"):
            x = c_dict[k1]
            y = c_dict[k2]
            if f"{k2}_extra" in c_dict:
                y = torch.cat([y, c_dict[f"{k2}_extra"]])
            denom_lse = torch.logsumexp((x @ y.T).float(), dim=-1)
            loss_info[c_type] = loss_info[c_type] + (denom_lse - numer_logits).mean() / 2.0
            if "_sources" in c_dict:
                for i, type_i in enumerate(_SPAN_SOURCES):
                    does_match = (c_dict["_sources"] == i).float()
                    loss_match = ((denom_lse - numer_logits) * does_match).sum() / (
                        does_match.sum() + 1e-5)
                    loss_info[f"_{c_type}_from_{type_i}"] = \
                        loss_info[f"_{c_type}_from_{type_i}"] + loss_match / 2.0

    loss = sum(v for k, v in loss_info.items() if not k.startswith("_"))
    return loss, loss_info


def batch_to_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A ``make_dummy_batch``-shaped numpy batch on ``device``: float arrays
    as f32, integer arrays as int64 (index tensors)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = (t.float() if t.is_floating_point() else t.long()).to(device)
    return out
