"""MerlotReserve: the towers, multimodal fusion, and the zero-shot API.

``prepare_multimodal_inputs`` emits per-position ``(is_valid, segment_ids)``
labels instead of a dense [B, L, L] mask; padding and packed-video
block-diagonal masking both factor through them, which is the form the
flash kernel consumes. ``batch_embed_video`` is the serving path: one batch
of videos through the vision and audio towers, the fusion, and the joint
transformer, whose attention is the flash kernel on the card when the
config asks for ``joint_attention_impl="flash"`` (or leaves 'auto'), and
the ring kernel over the active mesh's sp ranks under
``joint_attention_impl="ring:rdma"``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from merlot_reserve_tpu_torch.config import MerlotConfig, load_config
from merlot_reserve_tpu_torch.models.layers import TransformerEncoder, init_linear, linear
from merlot_reserve_tpu_torch.models.towers import (
    AudioTransformer,
    SpanTransformer,
    TokenEmbedder,
    VisionTransformer,
)
from merlot_reserve_tpu_torch.ops import rotary as rotary_ops
from merlot_reserve_tpu_torch.ops.pooling import unit_normalize
from merlot_reserve_tpu_torch.tokenizer import AUDIOSPAN, PADDING, encode_batch_padded
from merlot_reserve_tpu_torch.utils.device import resolve_device
from merlot_reserve_tpu_torch.utils.weights import load_flax_params

# config knobs of the JAX package that the port does not implement yet
_UNPORTED = ("pipeline_axis",)


class MerlotReserve(nn.Module):
    """The base model. Built on ``device`` (the card unless the caller asks
    for the CPU) with weights drawn from a ``torch.Generator`` seeded with
    ``seed``; load trained weights with ``utils.weights.load_flax_params``."""

    def __init__(self, config: MerlotConfig, device="cuda", seed: int = 0):
        super().__init__()
        cfg = config.model
        for knob in _UNPORTED:
            if getattr(cfg, knob):
                raise NotImplementedError(f"ModelConfig.{knob} is not ported yet")
        device = resolve_device(device)
        self.config = cfg
        self.dtype = torch.bfloat16 if cfg.use_bfloat16 else torch.float32
        generator = torch.Generator(device=device).manual_seed(seed)
        with device:
            self.vision_encoder = VisionTransformer(cfg, self.dtype, generator)
            self.audio_encoder = AudioTransformer(cfg, self.dtype, generator)
            self.token_encoder = TokenEmbedder(cfg.hidden_size, cfg.vocab_size, self.dtype,
                                               generator)
            self.span_encoder = SpanTransformer(cfg, self.dtype, generator)
            joint_impl = (cfg.attention_impl if cfg.joint_attention_impl is None
                          else cfg.joint_attention_impl)
            self.joint_transformer = TransformerEncoder(
                cfg.hidden_size, cfg.joint_num_layers, generator=generator, dtype=self.dtype,
                size_per_head=cfg.size_per_head, rotary_hsize=cfg.rotary_hsize,
                attention_impl=joint_impl, rotary_sign_quirk=cfg.rotary_sign_quirk,
                pe_len=None if cfg.do_rotary else config.joint_seq_len,
                seq_shard_axis=cfg.seq_shard_axis, remat=cfg.gradient_checkpoint,
                remat_policy=cfg.gradient_checkpoint_policy)
            # named "head" like the flax param; the JAX module calls it joint_proj
            self.head = init_linear(cfg.hidden_size, cfg.hidden_size,
                                    (cfg.hidden_size, cfg.hidden_size), generator)
            self.contrastive_scales = nn.Parameter(torch.ones(3))

    # ------------------------------------------------------------------
    # fusion
    # ------------------------------------------------------------------

    def prepare_multimodal_inputs(self, tokens, token_segment_idx=None, token_embs=None,
                                  vision_input=None, audio_spans=None, audio_pointers=None,
                                  padding_len=None, video_src_idx=None) -> Dict[str, Any]:
        """Assemble the joint-transformer input stream.

        AUDIOSPAN tokens are replaced by consecutive pooled audio tokens
        selected by ``audio_pointers``; text gets (segment, token) rotary
        coordinates and vision gets (segment, h, w); packed videos are
        isolated through ``video_src_idx``.

        :return: {'x': [B, L', H], 'rotary_coords': [B, L', 4],
                  'is_valid': [B, L'] bool, 'segment_ids': [B, L'] int32}
        """
        cfg = self.config
        dtype = self.dtype
        B, L = tokens.shape
        device = tokens.device
        if token_embs is None:
            token_embs = self.token_encoder({"k": tokens})["k"]

        if audio_spans is not None and audio_pointers is not None:
            if audio_spans.shape[0] != B or audio_spans.shape[2] != cfg.audio_token_length:
                raise ValueError(f"audio_spans {tuple(audio_spans.shape)} is not "
                                 f"[{B}, n, {cfg.audio_token_length}, H]")
            is_audio_src = tokens == AUDIOSPAN
            audio_ptr = audio_pointers.clamp(min=0)
            # position within the span: running count of AUDIOSPAN tokens mod span length
            audio_subpos = (torch.cumsum(is_audio_src.int(), -1) - 1).clamp(min=0) \
                % cfg.audio_token_length
            batch_idx = torch.arange(B, device=device)[:, None]
            audio_embs = audio_spans[batch_idx, audio_ptr, audio_subpos]
            token_embs = torch.where(is_audio_src[..., None], audio_embs, token_embs)

        token_idx = (1.0 + torch.arange(L, dtype=dtype, device=device))[None].expand(B, L)
        coords = rotary_ops.multimodal_rotary_coords(
            segment_idx=None if token_segment_idx is None else token_segment_idx.to(dtype),
            token_idx=token_idx, dtype=dtype)

        vis_segment_idx = None
        vis_seq_len = 0
        if vision_input is not None:
            hpool, wpool = cfg.vit_grid_pooled
            img_coords_pool = rotary_ops.get_rotary_coordinates_2d(hpool, wpool, dtype=dtype,
                                                                   device=device)
            vis_seq_len = vision_input.shape[1]
            num_pool_segments = vis_seq_len // (hpool * wpool)
            img_coords = img_coords_pool.repeat(num_pool_segments, 1)[None].expand(B, -1, -1)
            vis_segment_idx = torch.arange(num_pool_segments, device=device) \
                .repeat_interleave(hpool * wpool)[None].expand(B, -1)
            img_mm_coords = rotary_ops.multimodal_rotary_coords(
                segment_idx=vis_segment_idx.to(dtype), h=img_coords[..., 0],
                w=img_coords[..., 1], dtype=dtype)
            coords = torch.cat([coords, img_mm_coords], 1)
            token_embs = torch.cat([token_embs, vision_input], 1)

        is_valid = tokens != PADDING
        if vis_seq_len:
            is_valid = torch.cat(
                [is_valid, torch.ones((B, vis_seq_len), dtype=torch.bool, device=device)], 1)

        extra_len = 0
        if padding_len is not None:
            extra_len = padding_len - is_valid.shape[1]
            if extra_len < 0:
                raise ValueError(f"padding_len {padding_len} < stream length {is_valid.shape[1]}")
            if extra_len:
                is_valid = torch.cat(
                    [is_valid, torch.zeros((B, extra_len), dtype=torch.bool, device=device)], 1)
                coords = torch.cat([coords, coords.new_zeros((B, extra_len, 4))], 1)
                token_embs = torch.cat(
                    [token_embs, token_embs.new_zeros((B, extra_len, cfg.hidden_size))], 1)

        # block-diagonal packing as per-position labels
        if video_src_idx is not None and token_segment_idx is not None:
            batch_idx = torch.arange(B, device=device)[:, None]
            segs = [video_src_idx[batch_idx, token_segment_idx]]
            if vis_segment_idx is not None:
                segs.append(video_src_idx[batch_idx, vis_segment_idx])
            if extra_len:
                segs.append(torch.full((B, extra_len), -1, dtype=segs[0].dtype, device=device))
            segment_ids = torch.cat(segs, -1).to(torch.int32)
        else:
            segment_ids = torch.zeros(is_valid.shape, dtype=torch.int32, device=device)

        return {"x": token_embs, "rotary_coords": coords,
                "is_valid": is_valid, "segment_ids": segment_ids}

    def _run_joint(self, mm_inputs):
        return self.joint_transformer(
            mm_inputs["x"],
            rotary_coords=mm_inputs["rotary_coords"] if self.config.do_rotary else None,
            is_valid=mm_inputs["is_valid"], segment_ids=mm_inputs["segment_ids"])

    def _project(self, joint_seq, token_length: int):
        return unit_normalize(linear(joint_seq[:, :token_length], self.head, self.dtype))

    # ------------------------------------------------------------------
    # zero-shot API
    # ------------------------------------------------------------------

    def embed_text_spans_only(self, text_spans):
        """[B, L] span tokens -> [B, H] unit-normalized span embeddings."""
        token_embs = self.token_encoder({"text_spans": text_spans})["text_spans"]
        return unit_normalize(self.span_encoder(token_embs, text_spans != PADDING))

    def embed_audio_only(self, audio_clips):
        """[*batch, num_hops, 65] -> [*batch, H] unit-normalized audio CLS."""
        *batch_dims, hops, mels = audio_clips.shape
        enc = self.audio_encoder(audio_clips.reshape(-1, hops, mels))["cls"]
        return unit_normalize(enc).reshape(*batch_dims, self.config.hidden_size)

    def get_imgseq_only(self, imgs):
        """[*batch, P, 768] pre-patchified -> [*batch, P/4, H] pooled tokens."""
        *batch_dims, num_patch, pp3 = imgs.shape
        enc = self.vision_encoder(imgs.reshape(-1, num_patch, pp3))["seq_attnpool"]
        return enc.reshape(*batch_dims, num_patch // 4, self.config.hidden_size)

    def get_audioseq_only(self, audio_clips):
        return self.audio_encoder(
            audio_clips.reshape(-1, self.config.audio_seq_length, 65))["seq_attnpool"]

    def batch_embed_video(self, images, audio_clips, tokens, subseg_idxs):
        """Joint encoding of a batch of videos.

        :param images: [B, num_segments, num_patch_per_img, 768] pre-patchified
        :param audio_clips: [B, 3*num_segments, num_hops, 65]
        :param tokens: [B, L] (AUDIOSPAN marks audio-filled positions)
        :param subseg_idxs: [B, L] subsegment index per token
        :return: [B, L, H] unit-normalized joint projections
        """
        cfg = self.config
        B, num_segments, num_patch, pp3 = images.shape
        if audio_clips.shape != (B, 3 * num_segments, cfg.audio_seq_length, 65):
            raise ValueError(f"audio_clips {tuple(audio_clips.shape)} is not "
                             f"[{B}, {3 * num_segments}, {cfg.audio_seq_length}, 65]")
        if tokens.dim() != 2 or subseg_idxs.shape != tokens.shape or tokens.shape[0] != B:
            raise ValueError("tokens and subseg_idxs must both be [B, L]")

        imgs_enc = self.vision_encoder(images.reshape(B * num_segments, num_patch, pp3))
        imgs_enc = imgs_enc["seq_attnpool"].reshape(B, num_segments * num_patch // 4,
                                                    cfg.hidden_size)
        audio_enc = self.audio_encoder(audio_clips.reshape(-1, cfg.audio_seq_length, 65))
        audio_enc = audio_enc["seq_attnpool"].reshape(B, 3 * num_segments,
                                                      cfg.audio_token_length, cfg.hidden_size)
        mm_inputs = self.prepare_multimodal_inputs(
            tokens=tokens, token_segment_idx=subseg_idxs // 3, vision_input=imgs_enc,
            audio_pointers=subseg_idxs, audio_spans=audio_enc)
        return self._project(self._run_joint(mm_inputs)["seq"], tokens.shape[1])

    def embed_video(self, images, audio_clips, tokens, subseg_idxs):
        """One video: ``batch_embed_video`` on a batch of one -> [L, H]."""
        return self.batch_embed_video(images[None], audio_clips[None], tokens[None],
                                      subseg_idxs[None])[0]

    def embed_singleimg_with_multiimg_prompt(self, images_prompt, images, tokens, subseg_idxs):
        """Precomputed image prefix + new images, no audio."""
        ns0 = images_prompt.shape[0]
        ns1, num_patch, _pp3 = images.shape
        if ns0 + ns1 > 8:
            raise ValueError("at most 8 images in all")
        imgs_enc = self.vision_encoder(images)["seq_attnpool"]
        imgs_enc = torch.cat([images_prompt, imgs_enc], 0)
        imgs_enc = imgs_enc.reshape((ns0 + ns1) * num_patch // 4, self.config.hidden_size)
        mm_inputs = self.prepare_multimodal_inputs(
            tokens=tokens[None], token_segment_idx=subseg_idxs[None] // 3,
            vision_input=imgs_enc[None])
        return self._project(self._run_joint(mm_inputs)["seq"], tokens.shape[0])[0]

    def embed_preencoded_noaudio(self, images_enc, tokens, subseg_idxs):
        ns, npp4, hidden_size = images_enc.shape
        mm_inputs = self.prepare_multimodal_inputs(
            tokens=tokens[None], token_segment_idx=subseg_idxs[None] // 3,
            vision_input=images_enc.reshape(ns * npp4, hidden_size)[None])
        return self._project(self._run_joint(mm_inputs)["seq"], tokens.shape[0])[0]

    def embed_preencoded_audio(self, images_enc, audio_enc, tokens, subseg_idxs,
                               audio_pointers):
        mm_inputs = self.prepare_multimodal_inputs(
            tokens=tokens[None], token_segment_idx=subseg_idxs[None] // 3,
            vision_input=images_enc.reshape(-1, self.config.hidden_size)[None],
            audio_pointers=audio_pointers[None], audio_spans=audio_enc[None])
        return self._project(self._run_joint(mm_inputs)["seq"], tokens.shape[0])[0]


class PretrainedMerlotReserve:
    """Inference wrapper: every model method runs under
    ``torch.inference_mode()``, with numpy arguments moved to the model's
    device first."""

    def __init__(self, model: MerlotReserve):
        self.model = model.eval()
        self.device = next(model.parameters()).device

    @classmethod
    def from_params(cls, model_name: str, params: Dict, image_grid_size=(12, 20),
                    device="cuda") -> "PretrainedMerlotReserve":
        """Build ``model_name`` ('base', 'large') at ``image_grid_size`` and
        load a flax parameter tree (scan-stacked or ``layer_NN`` layout).
        Computes in bf16 on the card and in f32 on the CPU."""
        device = resolve_device(device)
        cfg = load_config(model_name, output_grid=tuple(image_grid_size),
                          use_bfloat16=device.type == "cuda")
        model = MerlotReserve(cfg, device=device)
        load_flax_params(model, params)
        return cls(model)

    def get_label_space(self, options):
        """Encode answer options (padded or cut to the span length) through
        the span tower -> [len(options), H] unit-normalized."""
        table = encode_batch_padded(options, length=self.model.config.text_span_length)
        return self.embed_text_spans_only(torch.from_numpy(table).to(self.device))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        method = getattr(self.model, name)
        if not callable(method):
            return method

        def bound(*args, **kwargs):
            args = [torch.from_numpy(a).to(self.device) if isinstance(a, np.ndarray) else a
                    for a in args]
            kwargs = {k: torch.from_numpy(v).to(self.device) if isinstance(v, np.ndarray) else v
                      for k, v in kwargs.items()}
            with torch.inference_mode():
                return method(*args, **kwargs)

        return bound
