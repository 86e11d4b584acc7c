"""Modality towers: vision ViT, audio spectrogram encoder, text-span encoder,
token embedder. Behaviour and parameter names follow the JAX package's
towers (and through them the reference's), so weights map one to one.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from merlot_reserve_tpu_torch.models.layers import (
    TransformerEncoder,
    _tp_mesh,
    init_linear,
    linear,
)
from merlot_reserve_tpu_torch.ops import rotary as rotary_ops
from merlot_reserve_tpu_torch.parallel import comm

_LECUN_TRUNC_SCALE = 0.87962566103423978  # stddev of a unit normal truncated to [-2, 2]


class MultiHeadDotProductAttention(nn.Module):
    """Port of flax's ``MultiHeadDotProductAttention`` as the towers use it
    (no mask, no dropout): q, k, v and out projections with bias, q scaled by
    1/sqrt(d), and the softmax in the compute dtype. Init is flax's default
    LeCun normal, truncated at two standard deviations."""

    def __init__(self, hidden_size: int, num_heads: int, dtype, generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.dtype = dtype
        for name in ("query", "key", "value"):
            setattr(self, name, self._lecun(hidden_size, hidden_size, hidden_size, generator))
        self.out = self._lecun(hidden_size, hidden_size, hidden_size, generator)

    @staticmethod
    def _lecun(in_features, out_features, fan_in, generator):
        layer = nn.Linear(in_features, out_features)
        std = 1.0 / math.sqrt(fan_in) / _LECUN_TRUNC_SCALE
        with torch.no_grad():
            nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(layer.bias)
        return layer

    def forward(self, inputs_q, inputs_kv):
        heads, d = self.num_heads, self.head_dim

        def project(x, layer):
            return linear(x, layer, self.dtype).reshape(*x.shape[:-1], heads, d)

        q = project(inputs_q, self.query) / math.sqrt(d)
        k = project(inputs_kv, self.key)
        v = project(inputs_kv, self.value)
        weights = torch.softmax(torch.einsum("...qhd,...khd->...hqk", q, k), dim=-1)
        out = torch.einsum("...hqk,...khd->...qhd", weights, v)
        return linear(out.reshape(*out.shape[:-2], heads * d), self.out, self.dtype)


def _encoder(cfg, num_layers, dtype, generator, pe_len, **kwargs):
    """A modality tower's encoder; the towers recompute their layers under
    ``tower_gradient_checkpoint`` (the joint tower under
    ``gradient_checkpoint``), both with ``gradient_checkpoint_policy``."""
    return TransformerEncoder(
        cfg.hidden_size, num_layers, generator=generator, dtype=dtype,
        size_per_head=cfg.size_per_head, rotary_hsize=cfg.rotary_hsize,
        attention_impl=cfg.attention_impl, rotary_sign_quirk=cfg.rotary_sign_quirk,
        pe_len=None if cfg.do_rotary else pe_len, remat=cfg.tower_gradient_checkpoint,
        remat_policy=cfg.gradient_checkpoint_policy, **kwargs)


class VisionTransformer(nn.Module):
    """ViT over pre-patchified frames [*batch, H*W, P*P*3] with 2-D centered
    rotary, a CLS token, and a ratio x ratio attention-pool with the window
    mean as query -> ``seq_attnpool`` [*batch, HW / ratio^2, hidden]."""

    def __init__(self, cfg, dtype, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        gh, gw = cfg.output_grid
        pp3 = cfg.vit_patch_size ** 2 * 3
        self.embedding = init_linear(pp3, cfg.hidden_size, (pp3, cfg.hidden_size),
                                     generator)
        self.transformer = _encoder(cfg, cfg.vit_num_layers, dtype, generator,
                                    pe_len=gh * gw + 1, add_cls_token=True)
        self.seq_attnpool = MultiHeadDotProductAttention(cfg.hidden_size, cfg.num_heads, dtype,
                                                         generator)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        *batch_dims, hw, pp3 = x.shape
        gh, gw = cfg.output_grid
        if hw != gh * gw or pp3 != cfg.vit_patch_size ** 2 * 3:
            raise ValueError(f"vision input {tuple(x.shape)} does not match grid {gh}x{gw}")
        x = linear(x, self.embedding, self.dtype)
        coords = (rotary_ops.get_rotary_coordinates_2d(gh, gw, dtype=self.dtype, device=x.device)
                  if cfg.do_rotary else None)
        t_out = self.transformer(x, rotary_coords=coords)

        r = cfg.vit_pooling_ratio
        h2, w2 = gh // r, gw // r
        b2 = math.prod(batch_dims) * h2
        seq = t_out["seq"].reshape(b2, r, w2, r, cfg.hidden_size).transpose(-4, -3)
        seq = seq.reshape(b2 * w2, r * r, cfg.hidden_size)
        pooled = self.seq_attnpool(seq.mean(-2, keepdim=True), seq)
        t_out["seq_attnpool"] = pooled.reshape(*batch_dims, h2 * w2, cfg.hidden_size)
        return t_out


class AudioTransformer(nn.Module):
    """Spectrogram encoder for [*batch, 60, 65] (64 mels + playback speed):
    stride-2 patch embedding, 1-D centered rotary, CLS, and an attention-pool
    to ``audio_token_length`` tokens.

    The flax ``Conv`` (kernel 2, stride 2, SAME padding, which pads nothing
    when the length is a multiple of the stride) is a reshape to
    [*, 30, 2 * 65] and one linear layer over the flattened patch."""

    def __init__(self, cfg, dtype, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        patch_in = cfg.audio_patch_size * (cfg.audio_num_mels + 1)
        self.embedding = init_linear(
            patch_in, cfg.hidden_size,
            (cfg.audio_patch_size, cfg.audio_num_mels + 1, cfg.hidden_size), generator)
        seq_len = cfg.audio_seq_length // cfg.audio_patch_size
        self.transformer = _encoder(cfg, cfg.audio_num_layers, dtype, generator,
                                    pe_len=seq_len + 1, add_cls_token=True)
        self.seq_attnpool = MultiHeadDotProductAttention(cfg.hidden_size, cfg.num_heads, dtype,
                                                         generator)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        *batch_dims, raw_len, mels = x.shape
        if mels != cfg.audio_num_mels + 1 or raw_len % cfg.audio_patch_size:
            raise ValueError(f"audio input {tuple(x.shape)} is not [*, k*{cfg.audio_patch_size}, "
                             f"{cfg.audio_num_mels + 1}]")
        seq_len = raw_len // cfg.audio_patch_size
        x = linear(x.reshape(*batch_dims, seq_len, cfg.audio_patch_size * mels),
                   self.embedding, self.dtype)
        coords = (rotary_ops.get_rotary_coordinates(seq_len, dtype=self.dtype,
                                                    device=x.device)[:, None] / seq_len
                  if cfg.do_rotary else None)
        t_out = self.transformer(x, rotary_coords=coords)

        ratio = cfg.audio_pooling_ratio
        seq = t_out["seq"].reshape(-1, ratio, cfg.hidden_size)
        pooled = self.seq_attnpool(seq.mean(-2, keepdim=True), seq)
        t_out["seq_attnpool"] = pooled.reshape(*batch_dims, seq_len // ratio, cfg.hidden_size)
        return t_out


class SpanTransformer(nn.Module):
    """Text-span encoder returning the CLS projection: the target tower of
    the contrastive span-matching head."""

    def __init__(self, cfg, dtype, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.max_len = cfg.text_span_length + 1
        self.do_rotary = cfg.do_rotary
        self.transformer = _encoder(cfg, cfg.span_num_layers, dtype, generator,
                                    pe_len=self.max_len, add_cls_token=True)

    def forward(self, x, x_isvalid):
        seq_len = x.shape[-2]
        if seq_len >= self.max_len:
            raise ValueError(f"span length {seq_len} must be < {self.max_len}")
        # not centered: spans are short and left-aligned
        coords = (rotary_ops.get_rotary_coordinates(seq_len, dtype=self.dtype, center_origin=False,
                                                    device=x.device)[:, None] / self.max_len
                  if self.do_rotary else None)
        return self.transformer(x, is_valid=x_isvalid, rotary_coords=coords)["cls"]


class TokenEmbedder(nn.Module):
    """Embed a dict of token tensors through one shared table."""

    def __init__(self, hidden_size: int, vocab_size: int, dtype, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.Embed_0 = nn.Embedding(vocab_size, hidden_size)
        with torch.no_grad():
            if hidden_size <= 768:
                nn.init.normal_(self.Embed_0.weight, std=0.02, generator=generator)
            else:
                nn.init.xavier_uniform_(self.Embed_0.weight, generator=generator)

    def shard_tp_(self, mesh) -> None:
        """Look up in the rank's share of the vocabulary (tensor parallel:
        ``Embed_0`` holds rows [i V / tp, (i + 1) V / tp))."""
        rows = self.Embed_0.weight.shape[0]
        self.vocab_start = mesh.axis_index("tp") * rows
        self.tp = True

    def forward(self, token_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # the table is cast to the compute dtype before the lookup, as flax's
        # Embed does: under bf16 parameters and f32 compute the gradient then
        # sums a token's uses in f32 and rounds once, not use by use
        table = self.Embed_0.weight.to(self.dtype)
        mesh = _tp_mesh(self)
        if mesh is None:
            return {k: F.embedding(token_dict[k], table) for k in sorted(token_dict)}
        # the rank's rows only; the one rank holding a token's row gives it,
        # the others zeros, and one all-reduce sums them
        out = {}
        for k in sorted(token_dict):
            ids = token_dict[k] - self.vocab_start
            mine = (ids >= 0) & (ids < table.shape[0])
            emb = F.embedding(torch.where(mine, ids, 0), table)
            out[k] = comm.reduce_from_parallel(
                torch.where(mine[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                                device=emb.device)),
                mesh, "tp")
        return out
