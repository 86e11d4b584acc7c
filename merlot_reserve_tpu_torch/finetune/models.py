"""Task heads: VCR (QA and QA->R jointly) and TVQA (subtitles and audio
streams), finetuned and zero-shot; the port of
``merlot_reserve_tpu/finetune/models.py``.

Each head is a ``MerlotReserve`` built with only the towers it uses (and so
with only their parameters, as the JAX model's tree has no others). The
finetune heads have no span tower and no contrastive ``head``, and VCR's
no audio tower either; a logit is ``proj`` (Dense H -> 1, no bias) of the
joint transformer's hidden state at each option's MASK. The zero-shot
rankers keep the span tower and ``head`` and have no ``proj`` (VCR's has no
audio tower). Masks travel as
per-position labels, so the TVQA splice of the dummy first image is a 1-D
slice of each field, and the joint attention is the flash kernel on the
card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from merlot_reserve_tpu_torch.models.layers import linear
from merlot_reserve_tpu_torch.models.model import OPTIONAL_TOWERS, MerlotReserve, seeded_generator
from merlot_reserve_tpu_torch.ops.pooling import unit_normalize
from merlot_reserve_tpu_torch.tokenizer import AUDIOSPAN, MASK


def pool_at_mask(joint: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The hidden state at each row's first MASK (position 0 if it has none)."""
    pool_idx = torch.argmax((tokens == MASK).float(), 1)
    return joint[torch.arange(joint.shape[0], device=joint.device), pool_idx]


class _TaskHead(MerlotReserve):
    """A ``MerlotReserve`` with only the towers in ``TOWERS``."""

    TOWERS: Tuple[str, ...] = OPTIONAL_TOWERS

    def __init__(self, config, device="cuda", seed: int = 0):
        super().__init__(config, device=device, seed=seed, towers=self.TOWERS)


class _FinetuneHead(_TaskHead):
    """A ``MerlotReserve`` without the span tower and ``head``, plus ``proj``."""

    TOWERS = ("vision_encoder", "audio_encoder")

    def __init__(self, config, device="cuda", seed: int = 0):
        super().__init__(config, device=device, seed=seed)
        device = self.contrastive_scales.device
        generator = seeded_generator(device, seed + 1)
        with device:
            self.proj = nn.Linear(self.config.hidden_size, 1, bias=False)
        with torch.no_grad():
            self.proj.weight.normal_(0.0, 0.02, generator=generator)


class MerlotReserveVCR(_FinetuneHead):
    """One image, 2 tasks x 4 options, each option ending in MASK.

    ``forward(batch)``: ``image`` [B, P, 768] patches, ``answers`` [B, 2, 4,
    L] tokens -> logits [B, 2, 4]."""

    TOWERS = ("vision_encoder",)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        B, two, num_ans, L = batch["answers"].shape
        answers2d = batch["answers"].reshape(B * two * num_ans, L)
        imgs_enc = self.vision_encoder(batch["image"])["seq_attnpool"].repeat_interleave(
            two * num_ans, 0)
        mm_inputs = self.prepare_multimodal_inputs(
            tokens=answers2d, token_segment_idx=torch.zeros_like(answers2d),
            vision_input=imgs_enc)
        joint = self._run_joint(mm_inputs)["seq"][:, :L]
        pooled = pool_at_mask(joint, answers2d)
        return linear(pooled, self.proj, self.dtype).reshape(B, two, num_ans)


def tvqa_pool_mask_hidden(model: MerlotReserve, batch: Dict[str, torch.Tensor]
                          ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The TVQA two-stream fusion: encode the frames (plus a zero first
    image for the question segment) and the audio once, fuse the
    subtitles-as-text and audio-as-AUDIOSPAN streams through one joint
    call with the dummy image's pooled tokens spliced out, and pool the
    hidden state at each sequence's MASK.

    :return: (pooled [B * 2 * num_ans, H], (B, num_ans)), the audio
        stream's rows first
    """
    cfg = model.config
    H = cfg.hidden_size
    B, images_per_batch, seq_size, img_dim = batch["images"].shape
    imgs_enc = model.vision_encoder(
        batch["images"].reshape(B * images_per_batch, seq_size, img_dim))["seq_attnpool"]
    imgs_enc = imgs_enc.reshape(B, images_per_batch, seq_size // 4, H)
    imgs_enc = torch.cat([imgs_enc.new_zeros((B, 1, seq_size // 4, H)), imgs_enc], 1)
    images_per_batch += 1

    _, num_ans, L, _two = batch["textonly_seqs"].shape
    imgs_enc = imgs_enc.reshape(B, images_per_batch * seq_size // 4, H).repeat_interleave(
        num_ans, 0)

    text_toks = batch["textonly_seqs"][..., 0].reshape(-1, L)
    textonly_inputs = model.prepare_multimodal_inputs(
        tokens=text_toks, token_segment_idx=batch["textonly_seqs"][..., 1].reshape(-1, L),
        vision_input=imgs_enc)

    _, num_segments, nsub, audio_seq_len, num_mels = batch["audio_clips"].shape
    audio_enc = model.audio_encoder(
        batch["audio_clips"].reshape(-1, audio_seq_len, num_mels))["seq_attnpool"]
    audio_token_len = audio_enc.shape[1]
    num_audio_spans = num_segments * nsub
    audio_enc = audio_enc.reshape(B, num_audio_spans, audio_token_len, H).repeat_interleave(
        num_ans, 0)

    audio_toks = batch["audio_seqs"][..., 0].reshape(-1, L)
    audio_pointers = (torch.cumsum((audio_toks == AUDIOSPAN).long(), -1) - 1) // audio_token_len
    audio_pointers = audio_pointers % num_audio_spans
    audio_inputs = model.prepare_multimodal_inputs(
        tokens=audio_toks, token_segment_idx=batch["audio_seqs"][..., 1].reshape(-1, L),
        vision_input=imgs_enc, audio_spans=audio_enc, audio_pointers=audio_pointers)

    start_imgs = L + seq_size // 4
    fused = {k: torch.cat([torch.cat([d[k][:, :L], d[k][:, start_imgs:]], 1)
                           for d in (audio_inputs, textonly_inputs)], 0)
             for k in ("x", "rotary_coords", "is_valid", "segment_ids")}
    joint = model._run_joint(fused)["seq"][:, :L]
    pooled = pool_at_mask(joint, torch.cat([audio_toks, text_toks], 0))
    return pooled, (B, num_ans)


class MerlotReserveTVQA(_FinetuneHead):
    """7 frames with audio and subtitles, answered by two parallel streams.

    ``forward(batch)``: ``images`` [B, 7, P, 768], ``audio_clips`` [B, 7, 3,
    60, 65], ``textonly_seqs`` and ``audio_seqs`` [B, 5, L, 2] (token,
    segment) -> (logits from audio [B, 5], logits from text [B, 5])."""

    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        pooled, (B, num_ans) = tvqa_pool_mask_hidden(self, batch)
        logits = linear(pooled, self.proj, self.dtype).squeeze(-1)
        from_audio, from_text = torch.chunk(logits, 2, 0)
        return from_audio.reshape(B, num_ans), from_text.reshape(B, num_ans)


class _ZeroShotHead(_TaskHead):
    """Ranks answers without a finetuned head: the joint transformer's hidden
    state at a statement's MASK goes through the pretrained ``head`` (the
    JAX model's ``joint_proj``, which the contrastive objective trained to
    infill masks), is unit-normalised, and scores each candidate answer
    embedded by the span tower: cosine logits."""

    def _mask_embedding(self, pooled: torch.Tensor) -> torch.Tensor:
        return unit_normalize(linear(pooled, self.head, self.dtype))

    def _answer_embeddings(self, answers: torch.Tensor) -> torch.Tensor:
        """[..., n_opt, span_len] tokens -> [..., n_opt, H] unit-normalised."""
        *lead, span_len = answers.shape
        emb = self.embed_text_spans_only(answers.reshape(-1, span_len))
        return emb.reshape(*lead, self.config.hidden_size)


class MerlotReserveTVQAZeroShot(_ZeroShotHead):
    """Zero-shot TVQA: one statement per stream (``textonly_seqs`` and
    ``audio_seqs`` [B, 1, L, 2]: question, 'answer:', MASK, then the
    subtitle or AUDIOSPAN rows) fused as the finetune head fuses them
    (``tvqa_pool_mask_hidden``), ranked against the 5 span-encoded choices
    (``answers`` [B, 5, span_len]).

    ``forward(batch)`` -> (cosine logits of the audio stream [B, 5], of the
    text stream [B, 5])."""

    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        pooled, (B, num_ans) = tvqa_pool_mask_hidden(self, batch)
        h = self._mask_embedding(pooled).reshape(2, B * num_ans, self.config.hidden_size)
        opts = self._answer_embeddings(batch["answers"])  # [B, n_opt, H]
        logits = torch.einsum("sbh,boh->sbo", h, opts)
        return logits[0], logits[1]


class MerlotReserveVCRZeroShot(_ZeroShotHead):
    """Zero-shot VCR: one image and two statements ending in MASK (QA:
    question + 'answer:'; QA->R: question + 'rationale:'), each ranked
    against its task's 4 span-encoded choices. No audio tower.

    ``forward(batch)``: ``image`` [B, P, 768], ``statements`` [B, 2, L],
    ``answers`` [B, 2, 4, span_len] -> cosine logits [B, 2, 4]."""

    TOWERS = ("vision_encoder", "span_encoder", "head")

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        B, n_tasks, L = batch["statements"].shape
        stmts = batch["statements"].reshape(B * n_tasks, L)
        imgs_enc = self.vision_encoder(batch["image"])["seq_attnpool"].repeat_interleave(
            n_tasks, 0)
        mm_inputs = self.prepare_multimodal_inputs(
            tokens=stmts, token_segment_idx=torch.zeros_like(stmts), vision_input=imgs_enc)
        joint = self._run_joint(mm_inputs)["seq"][:, :L]
        h = self._mask_embedding(pool_at_mask(joint, stmts)).reshape(
            B, n_tasks, self.config.hidden_size)
        opts = self._answer_embeddings(batch["answers"])  # [B, n_tasks, n_opt, H]
        return torch.einsum("bth,btoh->bto", h, opts)


def adapt_pretrained_params(params: Dict, hidden_size: int, drop_audio: bool = False,
                            seed: int = 123456) -> Dict:
    """Pretrained flax params -> a finetuning head's: drop the audio tower
    if asked, always drop ``head`` and ``span_encoder``, and add ``proj``
    from ``RandomState(seed)`` (the JAX package's draw, bit for bit)."""
    params = dict(params)
    for k in (["audio_encoder"] if drop_audio else []) + ["head", "span_encoder"]:
        params.pop(k, None)
    rng = np.random.RandomState(seed)
    params["proj"] = {"kernel": torch.from_numpy(
        (rng.randn(hidden_size, 1) * 0.01).astype(np.float32))}
    return params
