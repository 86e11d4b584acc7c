"""MERLOT Reserve in plain PyTorch: the benchmark's reference.

Written from the model's description (the towers, the fused joint
transformer, the three contrastive heads), independent of the program
under test: it imports nothing of it. It is functional over a dict of
parameters named as the benchmark's weight layout names them
(``param_shapes``), and computes in float32 with TF32 off, or, for the
control, with every product's operands rounded to float8 e4m3
(``Numerics("fp8")``).

Every transformer layer is recomputed in the backward (``remat``) and
attention runs in blocks of query rows, so the reference fits beside
nothing else on the card at the benchmark's timed sizes.

Masking follows the model's per-position labels: a query attends to the
keys that are valid and share its segment id; a row that sees no key
averages every value (it is never read: no valid row attends to it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PADDING, MASK, MASKAUDIO, AUDIOSPAN, LTOVPOOL = 0, 3, 4, 5, 6
NEG_INF = -1e10
FP8_MAX = 448.0  # largest finite float8 e4m3 value
ATTN_QUERY_BLOCK = 512
SPAN_SOURCES = ("text2audio", "audio2text", "random_text")
HEADS = ("imgs_to_audio", "text_to_audio", "stuff_to_span")


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Numerics:
    """``f32``: the reference; ``fp8``: the control, every product's operands
    rounded to float8 e4m3 with a per-tensor scale; ``bf16``: every product's
    operands rounded to bfloat16, as the configurations compute (a witness
    for reading which gaps the stated precision alone makes). Gradients pass
    straight through the rounding."""

    kind: str = "f32"
    remat: bool = True

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return x
        if self.kind == "bf16":
            return x + (x.detach().bfloat16().float() - x).detach()
        if self.kind != "fp8":
            raise ValueError(f"unknown numerics {self.kind!r}")
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x).detach()


def linear(x, P, name, nm: Numerics, bias=True):
    out = nm.q(x) @ nm.q(P[name + ".weight"]).T
    b = P.get(name + ".bias") if bias else None
    return out if b is None else out + b


def layer_norm(x, P, name):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"], P[name + ".bias"], 1e-5)


def gelu(x):
    return x * torch.sigmoid(1.702 * x)


def unit_normalize(x):
    return x / torch.sqrt(torch.square(x).sum(-1, keepdim=True) + 1e-5)


# ---------------------------------------------------------------------------
# rotary positions
# ---------------------------------------------------------------------------


def coords_1d(n, center=True, device=None):
    """Centered: -n//2 .. -1, 1 .. n - n//2 (no 0); else 1 .. n."""
    if center:
        half = n // 2
        return torch.cat([torch.arange(half, device=device, dtype=torch.float32) - half,
                          1.0 + torch.arange(n - half, device=device, dtype=torch.float32)])
    return 1.0 + torch.arange(n, device=device, dtype=torch.float32)


def coords_2d(h, w, device=None):
    s = 1.0 / (max(h, w) + 1.0)
    hh, ww = torch.meshgrid(s * coords_1d(h, device=device), s * coords_1d(w, device=device),
                            indexing="ij")
    return torch.stack([hh, ww], -1).reshape(h * w, 2)


def mm_coords(shape, device, h=None, w=None, seg=None, tok=None):
    """(h, w, segment / 16, token / 1024), absent axes 0."""
    z = torch.zeros(shape, device=device)
    return torch.stack([z if h is None else h.float(), z if w is None else w.float(),
                        z if seg is None else seg.float() / 16.0,
                        z if tok is None else tok.float() / 1024.0], -1)


def sinusoids(coords, rotary=32, max_freq=10.0):
    """[*, L, n] -> [*, 2, L, rotary]: slot 0 cos, slot 1 sin, each
    frequency twice; frequencies 2^linspace(0, log2(max_freq / 2))."""
    *b, L, n = coords.shape
    per = rotary // (2 * n)
    freqs = torch.pow(2.0, torch.linspace(0.0, math.log2(max_freq / 2.0), per,
                                          device=coords.device))
    rad = (coords[..., None] * freqs * math.pi).reshape(*b, L, n * per)
    return torch.repeat_interleave(torch.stack([torch.cos(rad), torch.sin(rad)], -3), 2, -1)


def rotate(qk, sin_cos):
    """The released model's rotation of the first ``rotary`` dims of each
    head: pairs rotate as (-x0, x1), slot 0 (cos) multiplies the rotated
    pair and slot 1 (sin) the unrotated values."""
    r = sin_cos.shape[-1]
    extra = qk.dim() - 3 - (sin_cos.dim() - 3)
    sc = sin_cos.reshape((1,) * extra + sin_cos.shape)
    a, b = sc[..., 0, :, None, :], sc[..., 1, :, None, :]
    x = qk[..., :r]
    turned = torch.stack([-x[..., ::2], x[..., 1::2]], -1).reshape(x.shape)
    return torch.cat([x * b + turned * a, qk[..., r:]], -1)


# ---------------------------------------------------------------------------
# attention and encoders
# ---------------------------------------------------------------------------


def attention(q, k, v, valid, seg, nm: Numerics):
    """[B, L, h, d] -> [B, L, h, d], query rows in blocks."""
    B, L, h, d = q.shape
    q, k, v = nm.q(q * (1.0 / math.sqrt(d))), nm.q(k), nm.q(v)
    outs = []
    for s in range(0, L, ATTN_QUERY_BLOCK):
        e = min(L, s + ATTN_QUERY_BLOCK)
        scores = torch.einsum("bqhd,bkhd->bhqk", q[:, s:e], k)
        if valid is not None:
            mask = valid[:, s:e, None] & valid[:, None, :] & (seg[:, s:e, None] == seg[:, None, :])
            scores = torch.where(mask[:, None], scores, NEG_INF)
        p = torch.softmax(scores, -1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", nm.q(p), v))
    return torch.cat(outs, 1)


def transformer_layer(x, P, name, heads, sc, valid, seg, nm: Numerics):
    *b, L, H = x.shape
    y = layer_norm(x, P, name + ".pre_attn_ln")
    qkv = linear(y, P, name + ".attention_layer.qkv", nm).reshape(*b, L, 3 * heads, H // heads)
    qk, v = qkv[..., :2 * heads, :], qkv[..., 2 * heads:, :]
    if sc is not None:
        qk = rotate(qk, sc)
    att = attention(qk[..., :heads, :], qk[..., heads:, :], v, valid, seg, nm)
    x = x + linear(att.reshape(*b, L, H), P, name + ".attention_layer.attn_proj", nm, bias=False)
    y = layer_norm(x, P, name + ".pre_mlp_ln")
    h = gelu(linear(y, P, name + ".mlp_layer.intermediate", nm))
    return x + linear(h, P, name + ".mlp_layer.out", nm, bias=False)


def encoder(x, P, prefix, layers, heads, nm: Numerics, coords=None, valid=None, seg=None,
            cls=False):
    """Pre-LN encoder; with ``cls`` a learned CLS token in front, returned
    through ``cls_proj``. -> {'seq': [.., L, H], 'cls': [.., H]}"""
    if cls:
        x = torch.cat([P[prefix + ".cls"].expand(*x.shape[:-2], 1, x.shape[-1]), x], -2)
        if valid is not None:
            valid = torch.cat([torch.ones_like(valid[..., :1]), valid], -1)
            seg = torch.cat([seg[..., :1], seg], -1)
        if coords is not None:
            coords = torch.cat([torch.zeros_like(coords[..., :1, :]), coords], -2)
    sc = None if coords is None else sinusoids(coords)
    x = layer_norm(x, P, prefix + ".pre_ln")
    for i in range(layers):
        name = f"{prefix}.layers.{i}"
        if nm.remat and torch.is_grad_enabled():
            x = checkpoint(transformer_layer, x, P, name, heads, sc, valid, seg, nm,
                           use_reentrant=False)
        else:
            x = transformer_layer(x, P, name, heads, sc, valid, seg, nm)
    x = layer_norm(x, P, prefix + ".final_ln")
    if cls:
        return {"cls": linear(x[..., 0, :], P, prefix + ".cls_proj", nm), "seq": x[..., 1:, :]}
    return {"seq": x}


def pool_attention(xq, xkv, P, name, heads, nm: Numerics):
    """The towers' attention pool: q, k, v, out with biases, q / sqrt(d)."""
    *b, Lq, H = xq.shape
    d = H // heads
    q = linear(xq, P, name + ".query", nm).reshape(*b, Lq, heads, d) / math.sqrt(d)
    k = linear(xkv, P, name + ".key", nm).reshape(*b, xkv.shape[-2], heads, d)
    v = linear(xkv, P, name + ".value", nm).reshape(*b, xkv.shape[-2], heads, d)
    p = torch.softmax(torch.einsum("...qhd,...khd->...hqk", nm.q(q), nm.q(k)), -1)
    out = torch.einsum("...hqk,...khd->...qhd", nm.q(p), nm.q(v))
    return linear(out.reshape(*b, Lq, H), P, name + ".out", nm)


def vision_tower(P, cfg, images, nm: Numerics):
    """[N, grid, 768] patches -> (cls [N, H], pooled [N, grid / r^2, H])."""
    m = cfg.model
    gh, gw = m.output_grid
    r, H = m.vit_pooling_ratio, m.hidden_size
    x = linear(images, P, "vision_encoder.embedding", nm)
    out = encoder(x, P, "vision_encoder.transformer", m.vit_num_layers, m.num_heads, nm,
                  coords=coords_2d(gh, gw, x.device), cls=True)
    N = x.shape[0]
    h2, w2 = gh // r, gw // r
    seq = out["seq"].reshape(N * h2, r, w2, r, H).transpose(1, 2).reshape(N * h2 * w2, r * r, H)
    pooled = pool_attention(seq.mean(-2, keepdim=True), seq, P, "vision_encoder.seq_attnpool",
                            m.num_heads, nm)
    return out["cls"], pooled.reshape(N, h2 * w2, H)


def audio_tower(P, cfg, clips, nm: Numerics):
    """[N, 60, 65] -> (cls [N, H], pooled [N, audio_token_length, H])."""
    m = cfg.model
    N, raw, mels = clips.shape
    L = raw // m.audio_patch_size
    x = linear(clips.reshape(N, L, m.audio_patch_size * mels), P, "audio_encoder.embedding", nm)
    out = encoder(x, P, "audio_encoder.transformer", m.audio_num_layers, m.num_heads, nm,
                  coords=coords_1d(L, device=x.device)[:, None] / L, cls=True)
    seq = out["seq"].reshape(-1, L // m.audio_token_length, m.hidden_size)
    pooled = pool_attention(seq.mean(-2, keepdim=True), seq, P, "audio_encoder.seq_attnpool",
                            m.num_heads, nm)
    return out["cls"], pooled.reshape(N, m.audio_token_length, m.hidden_size)


def span_tower(P, cfg, x, valid, nm: Numerics):
    """[N, Ls, H] span token embeddings -> [N, H] CLS projections."""
    m = cfg.model
    Ls = x.shape[-2]
    coords = coords_1d(Ls, center=False, device=x.device)[:, None] / (m.text_span_length + 1)
    return encoder(x, P, "span_encoder.transformer", m.span_num_layers, m.num_heads, nm,
                   coords=coords, valid=valid, seg=torch.zeros_like(valid, dtype=torch.int32),
                   cls=True)["cls"]


def embed_tokens(P, tokens):
    return F.embedding(tokens, P["token_encoder.Embed_0.weight"])


def multimodal_stream(cfg, tokens, token_embs, token_seg=None, vision=None, audio_spans=None,
                      audio_ptr=None, padding_len=None, video_src=None):
    """The joint transformer's input for one stream: AUDIOSPAN tokens taken
    from the pooled audio span ``audio_ptr`` points at (the k-th of a run
    takes its k-th token), pooled frames after the text, per-position
    (segment, token) or (h, w, segment) coordinates, validity, and the
    packed videos' ids as segment ids. -> (x, coords, valid, seg)"""
    m = cfg.model
    B, L = tokens.shape
    dev = tokens.device
    x = token_embs
    if audio_spans is not None:
        is_audio = tokens == AUDIOSPAN
        sub = (torch.cumsum(is_audio.int(), -1) - 1).clamp(min=0) % m.audio_token_length
        rows = torch.arange(B, device=dev)[:, None]
        x = torch.where(is_audio[..., None], audio_spans[rows, audio_ptr.clamp(min=0), sub], x)
    tok = (1.0 + torch.arange(L, device=dev, dtype=torch.float32))[None].expand(B, L)
    coords = mm_coords((B, L), dev, seg=token_seg, tok=tok)
    valid = tokens != PADDING
    vis_seg = None
    if vision is not None:
        hp, wp = (g // m.vit_pooling_ratio for g in m.output_grid)
        nv = vision.shape[1] // (hp * wp)
        c2 = coords_2d(hp, wp, dev).repeat(nv, 1)[None].expand(B, -1, -1)
        vis_seg = torch.arange(nv, device=dev).repeat_interleave(hp * wp)[None].expand(B, -1)
        coords = torch.cat([coords, mm_coords(vis_seg.shape, dev, h=c2[..., 0], w=c2[..., 1],
                                              seg=vis_seg)], 1)
        x = torch.cat([x, vision], 1)
        valid = torch.cat([valid, torch.ones(vis_seg.shape, dtype=torch.bool, device=dev)], 1)
    extra = 0 if padding_len is None else padding_len - valid.shape[1]
    if extra:
        valid = torch.cat([valid, torch.zeros((B, extra), dtype=torch.bool, device=dev)], 1)
        coords = torch.cat([coords, coords.new_zeros((B, extra, 4))], 1)
        x = torch.cat([x, x.new_zeros((B, extra, x.shape[-1]))], 1)
    if video_src is not None:
        rows = torch.arange(B, device=dev)[:, None]
        parts = [video_src[rows, token_seg]]
        if vis_seg is not None:
            parts.append(video_src[rows, vis_seg])
        if extra:
            parts.append(torch.full((B, extra), -1, dtype=video_src.dtype, device=dev))
        seg = torch.cat(parts, -1).to(torch.int32)
    else:
        seg = torch.zeros(valid.shape, dtype=torch.int32, device=dev)
    return x, coords, valid, seg


def joint(P, cfg, x, coords, valid, seg, nm: Numerics):
    m = cfg.model
    return encoder(x, P, "joint_transformer", m.joint_num_layers, m.num_heads, nm,
                   coords=coords, valid=valid, seg=seg)["seq"]


# ---------------------------------------------------------------------------
# serving: embed_video
# ---------------------------------------------------------------------------


def serving_labels(cfg, tokens, num_segments):
    """The joint attention's (valid, segment ids) of a serving batch of
    ``num_segments`` segments a video."""
    B = tokens.shape[0]
    valid = torch.cat([tokens != PADDING,
                       torch.ones((B, num_segments * cfg.model.vit_pooled_seq_len),
                                  dtype=torch.bool, device=tokens.device)], 1)
    return valid, torch.zeros(valid.shape, dtype=torch.int32, device=tokens.device)


def embed_video(P, cfg, images, audio_clips, tokens, subseg_idxs, nm: Numerics = Numerics()):
    """[B, S, grid, 768], [B, 3S, 60, 65], [B, L], [B, L] -> [B, L, H] unit rows."""
    m = cfg.model
    B, S = images.shape[:2]
    _, frames = vision_tower(P, cfg, images.reshape(B * S, *images.shape[2:]), nm)
    _, audio = audio_tower(P, cfg, audio_clips.reshape(-1, *audio_clips.shape[2:]), nm)
    x, coords, valid, seg = multimodal_stream(
        cfg, tokens, embed_tokens(P, tokens), token_seg=subseg_idxs // 3,
        vision=frames.reshape(B, -1, m.hidden_size),
        audio_spans=audio.reshape(B, 3 * S, m.audio_token_length, m.hidden_size),
        audio_ptr=subseg_idxs)
    seq = joint(P, cfg, x, coords, valid, seg, nm)[:, :tokens.shape[1]]
    return unit_normalize(linear(seq, P, "head", nm))


# ---------------------------------------------------------------------------
# pretraining: the three heads' loss
# ---------------------------------------------------------------------------


def one_hot_pool(do_pool, idx, v, slots, rows=None):
    """Sum rows of v [B, L, H] into ``slots`` slots keyed by idx where
    do_pool; with ``rows`` the (B, L) grid is regrouped into rows first.
    -> (pooled [B', slots, H], counts [B', slots])"""
    B, L, H = v.shape
    if rows is not None:
        do_pool, idx, v = (t.reshape(rows, (B * L) // rows, *t.shape[2:])
                           for t in (do_pool, idx, v))
    oh = (torch.where(do_pool, idx, -1)[..., None]
          == torch.arange(slots, device=v.device)).to(v.dtype)
    return torch.einsum("bls,blh->bsh", oh, v), oh.sum(1)


def _flat(cfg, batch):
    """The batch's token streams as [rows, L]."""
    d, m = cfg.data, cfg.model
    flat = dict(batch)
    for s in ("text2audio", "audio2text"):
        for suffix in ("", "/audio_ptr", "/text_ptr"):
            flat[s + suffix] = flat[s + suffix].reshape(-1, d.lang_seq_len)
    for key in ("random_text", "random_text/text_ptr", "audio_text_matching",
                "audio_text_matching/audio_ptr"):
        flat[key] = flat[key].reshape(-1, d.seq_len)
    flat["text_spans"] = flat["text_spans"].reshape(-1, m.text_span_length)
    return flat


@dataclass
class Draws:
    """What a pretraining batch draws from its content: the packed videos'
    ids after the split augmentation (audio2text, text2audio rows) and the
    text spans the span head takes, with every span slot's MASK counts."""

    video_ids: Dict[str, torch.Tensor]
    drawn: torch.Tensor


def draw(cfg, batch) -> Draws:
    """The model's content-seeded draws: a generator on the batch's device
    seeded with the sum of the audio2text text pointers; per packed row a
    split segment (probability 0.9 of none, else uniform), first for the
    audio2text rows, then the text2audio rows; then Gumbel noise over every
    span slot for a top-k across the batch that takes usable spans first
    and prefers spans masked in the multimodal streams 4:1."""
    d = cfg.data
    flat = _flat(cfg, batch)
    dev = flat["audio2text/text_ptr"].device
    gen = torch.Generator(device=dev).manual_seed(int(flat["audio2text/text_ptr"].sum()))
    B = batch["images"].shape[0]
    spg = d.num_segments // d.num_segment_groups
    ids = {}
    for stream, n_seqs in (("audio2text", d.num_audio2text_seqs),
                           ("text2audio", d.num_text2audio_seqs)):
        tiled = batch["video_src_index"].reshape(B, d.num_segment_groups, spg) \
            .repeat(1, n_seqs, 1).reshape(-1, spg)
        if spg > 1:
            probs = torch.tensor([0.1 / (spg - 1)] * (spg - 1) + [0.9], device=dev)
            split = 1 + torch.multinomial(probs, tiled.shape[0], replacement=True, generator=gen)
            tail = split[:, None] <= torch.arange(spg, device=dev)[None]
            tiled = torch.where(tail, tiled + 4 * spg, tiled)
        ids[stream] = tiled
    spans = flat["text_spans"].shape[0] // B
    counts = {}
    for s in ("audio2text", "text2audio", "random_text"):
        do = flat[s] == MASK
        oh = (torch.where(do, flat[s + "/text_ptr"], -1).reshape(B, -1)[..., None]
              == torch.arange(spans, device=dev))
        counts[s] = oh.sum(1).float()
    total = counts["audio2text"] + counts["text2audio"] + counts["random_text"]
    usable = ((flat["text_spans"] != PADDING).any(-1).reshape(B, spans) & (total > 0)).float()
    logits = usable * 1e6 + math.log(4) * (counts["text2audio"] + counts["audio2text"])
    u = torch.rand((B, spans), generator=gen, device=dev)
    order = torch.sort((logits - torch.log(-torch.log(u))).reshape(-1), descending=True,
                       stable=True).indices
    return Draws(ids, order[:d.num_text_spans_to_include * B])


def _streams(cfg, batch, draws: Draws, token_embs, frames, audio_tokens):
    """The four task streams' joint inputs, example-major in stream order
    (audio2text, audio_text_matching, random_text, text2audio)."""
    d, m = cfg.data, cfg.model
    flat = _flat(cfg, batch)
    B = batch["images"].shape[0]
    spg = d.num_segments // d.num_segment_groups

    def seg_of(ptr):
        return (ptr // d.num_audio_subsegments) % spg

    vis = None if frames is None else frames.reshape(B, d.num_segment_groups, -1, m.hidden_size)
    st = {}
    st["audio2text"] = multimodal_stream(
        cfg, flat["audio2text"], token_embs["audio2text"],
        token_seg=seg_of(flat["audio2text/audio_ptr"]),
        vision=None if vis is None else
        vis.repeat(1, d.num_audio2text_seqs, 1, 1).reshape(-1, vis.shape[2], m.hidden_size),
        audio_spans=None if audio_tokens is None else audio_tokens.repeat_interleave(
            d.num_segment_groups * d.num_audio2text_seqs, dim=0),
        audio_ptr=flat["audio2text/audio_ptr"], padding_len=d.seq_len,
        video_src=draws.video_ids["audio2text"])
    atm = flat["audio_text_matching"]
    st["audio_text_matching"] = multimodal_stream(
        cfg, atm, token_embs["audio_text_matching"], token_seg=torch.cumsum(atm == LTOVPOOL, -1),
        audio_spans=audio_tokens, audio_ptr=flat["audio_text_matching/audio_ptr"],
        padding_len=d.seq_len)
    st["text2audio"] = multimodal_stream(
        cfg, flat["text2audio"], token_embs["text2audio"],
        token_seg=seg_of(flat["text2audio/audio_ptr"]),
        vision=None if vis is None else
        vis.repeat(1, d.num_text2audio_seqs, 1, 1).reshape(-1, vis.shape[2], m.hidden_size),
        audio_ptr=flat["text2audio/audio_ptr"], padding_len=d.seq_len,
        video_src=draws.video_ids["text2audio"])
    st["random_text"] = multimodal_stream(cfg, flat["random_text"], token_embs["random_text"],
                                          padding_len=d.seq_len)
    order = sorted(st)
    per = [st[k][0].shape[0] // B for k in order]

    def fuse(i):
        parts = [st[k][i].reshape((B, n) + st[k][i].shape[1:]) for k, n in zip(order, per)]
        cat = torch.cat(parts, 1)
        return cat.reshape((-1,) + cat.shape[2:])

    return order, per, [fuse(i) for i in range(4)]


def pretraining_labels(cfg, batch, draws: Draws):
    """The attention labels of one pretraining step: the fused joint call's
    (valid, seg) [rows, seq_len] and the span tower's (valid, seg) with its
    CLS in front [spans, 1 + span length]. The token content alone sets
    them, so no tower runs."""
    d = cfg.data
    flat = _flat(cfg, batch)
    B = batch["images"].shape[0]
    dev = flat["text_spans"].device
    H = 1
    embs = {k: torch.zeros(flat[k].shape + (H,), device=dev)
            for k in ("audio2text", "text2audio", "audio_text_matching", "random_text")}
    spg = d.num_segments // d.num_segment_groups
    frames = torch.zeros((B, d.num_segment_groups * spg * cfg.model.vit_pooled_seq_len, H),
                         device=dev)
    cfg_h1 = _with_hidden(cfg, H)
    audio = torch.zeros((B, d.num_segments * d.num_audio_subsegments,
                         cfg.model.audio_token_length, H), device=dev)
    _, _, (_, _, valid, seg) = _streams(cfg_h1, batch, draws, embs, frames, audio)
    span_valid = flat["text_spans"][draws.drawn] != PADDING
    span_valid = torch.cat([torch.ones_like(span_valid[:, :1]), span_valid], 1)
    return (valid, seg), (span_valid, torch.zeros_like(span_valid, dtype=torch.int32))


def _with_hidden(cfg, hidden):
    import copy

    c = copy.copy(cfg)
    c.model = copy.copy(cfg.model)
    c.model.hidden_size = hidden
    return c


def pretraining_loss(P, cfg, batch, nm: Numerics = Numerics(), draws: Optional[Draws] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The summed loss of the three symmetric InfoNCE heads (frames against
    audio, masked text against audio spans, masked text against text spans)
    over one fused joint call. -> (total, {head: its loss})"""
    d, m = cfg.data, cfg.model
    H = m.hidden_size
    B = batch["images"].shape[0]
    S = d.num_segments
    draws = draw(cfg, batch) if draws is None else draws
    flat = _flat(cfg, batch)

    vcls, frames = vision_tower(P, cfg, batch["images"].reshape(B * S, m.vit_seq_len, -1), nm)
    acls, audio = audio_tower(P, cfg, batch["audio_clips"].reshape(
        B * S * d.num_audio_subsegments, m.audio_seq_length, -1), nm)
    n_audio = S * d.num_audio_subsegments
    audio_tokens = audio.reshape(B, n_audio, m.audio_token_length, H)
    audio_cls = acls.reshape(B, n_audio, H)
    embs = {k: embed_tokens(P, flat[k]) for k in ("audio2text", "text2audio",
                                                  "audio_text_matching", "random_text",
                                                  "text_spans")}
    order, per, (x, coords, valid, seg) = _streams(cfg, batch, draws, embs,
                                                   frames.reshape(B, -1, H), audio_tokens)
    out = linear(joint(P, cfg, x, coords, valid, seg, nm), P, "head", nm)
    out = out.reshape((B, sum(per)) + out.shape[1:])
    so = {k: p.reshape((-1,) + p.shape[2:]) for k, p in zip(order, torch.split(out, per, 1))}
    so["text2audio"] = so["text2audio"][:, :d.lang_seq_len]
    so["audio2text"] = so["audio2text"][:, :d.lang_seq_len]

    # frames <-> audio: the joint state at each segment's LTOVPOOL token
    atm = flat["audio_text_matching"]
    at_pool = atm == LTOVPOOL
    seg_states, _ = one_hot_pool(at_pool, torch.cumsum(at_pool.long(), -1) - 1,
                                 so["audio_text_matching"], S)
    heads = {"imgs_to_audio": {"x": seg_states.reshape(B * S, H), "y": vcls}}

    # masked text -> audio spans: the most-masked spans are the pairs, the
    # others' CLS extra negatives
    pooled, times = one_hot_pool(flat["text2audio"] == MASKAUDIO, flat["text2audio/audio_ptr"],
                                 so["text2audio"], n_audio, rows=B)
    n_t = int(n_audio * d.mask_rate) * d.num_text2audio_seqs
    first = torch.argsort(-times, dim=-1, stable=True)
    rows = torch.arange(B, device=first.device)
    tr, ts = rows.repeat_interleave(n_t), first[:, :n_t].reshape(-1)
    nr, ns = rows.repeat_interleave(n_audio - n_t), first[:, n_t:].reshape(-1)
    heads["text_to_audio"] = {"x": pooled[tr, ts], "y": audio_cls[tr, ts],
                              "y_extra": audio_cls[nr, ns]}

    # masked text -> text spans
    spans = flat["text_spans"].shape[0] // B
    summed = 0.0
    for s in ("audio2text", "text2audio", "random_text"):
        summed = summed + one_hot_pool(flat[s] == MASK, flat[s + "/text_ptr"], so[s], spans,
                                       rows=B)[0]
    span_x = embs["text_spans"][draws.drawn]
    span_y = span_tower(P, cfg, span_x, flat["text_spans"][draws.drawn] != PADDING, nm)
    heads["stuff_to_span"] = {"x": summed.reshape(B * spans, H)[draws.drawn], "y": span_y}

    scales = P["contrastive_scales"].clamp(max=math.log(100.0))
    slot = {"imgs_to_audio": 0, "text_to_audio": 1, "stuff_to_span": 2}
    per_head = {}
    for name, hd in heads.items():
        t = torch.exp(scales[slot[name]] / 2.0)
        hd = {k: unit_normalize(v) * t for k, v in hd.items()}
        numer = (hd["x"] * hd["y"]).sum(-1)
        per_head[name] = 0.0
        for a, b in (("x", "y"), ("y", "x")):
            keys = hd[b] if b + "_extra" not in hd else torch.cat([hd[b], hd[b + "_extra"]])
            lse = torch.logsumexp(nm.q(hd[a]) @ nm.q(keys).T, -1)
            per_head[name] = per_head[name] + (lse - numer).mean() / 2.0
    return sum(per_head.values()), per_head


# ---------------------------------------------------------------------------
# the parameters
# ---------------------------------------------------------------------------


def _encoder_shapes(prefix, H, layers, cls):
    out = []
    if cls:
        out += [(prefix + ".cls", (H,)), (prefix + ".cls_proj.weight", (H, H)),
                (prefix + ".cls_proj.bias", (H,))]
    out += [(prefix + ".pre_ln.weight", (H,)), (prefix + ".pre_ln.bias", (H,))]
    for i in range(layers):
        n = f"{prefix}.layers.{i}"
        out += [(n + ".pre_attn_ln.weight", (H,)), (n + ".pre_attn_ln.bias", (H,)),
                (n + ".attention_layer.qkv.weight", (3 * H, H)),
                (n + ".attention_layer.qkv.bias", (3 * H,)),
                (n + ".attention_layer.attn_proj.weight", (H, H)),
                (n + ".pre_mlp_ln.weight", (H,)), (n + ".pre_mlp_ln.bias", (H,)),
                (n + ".mlp_layer.intermediate.weight", (4 * H, H)),
                (n + ".mlp_layer.intermediate.bias", (4 * H,)),
                (n + ".mlp_layer.out.weight", (H, 4 * H))]
    return out + [(prefix + ".final_ln.weight", (H,)), (prefix + ".final_ln.bias", (H,))]


def _pool_shapes(prefix, H):
    return [(f"{prefix}.{p}.{w}", (H, H) if w == "weight" else (H,))
            for p in ("query", "key", "value", "out") for w in ("weight", "bias")]


def param_shapes(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter of the pretraining model, by name, in order."""
    m = cfg.model
    H = m.hidden_size
    patch = m.vit_patch_size ** 2 * 3
    audio_in = m.audio_patch_size * (m.audio_num_mels + 1)
    return ([("vision_encoder.embedding.weight", (H, patch)),
             ("vision_encoder.embedding.bias", (H,))]
            + _encoder_shapes("vision_encoder.transformer", H, m.vit_num_layers, True)
            + _pool_shapes("vision_encoder.seq_attnpool", H)
            + [("audio_encoder.embedding.weight", (H, audio_in)),
               ("audio_encoder.embedding.bias", (H,))]
            + _encoder_shapes("audio_encoder.transformer", H, m.audio_num_layers, True)
            + _pool_shapes("audio_encoder.seq_attnpool", H)
            + [("token_encoder.Embed_0.weight", (m.vocab_size, H))]
            + _encoder_shapes("span_encoder.transformer", H, m.span_num_layers, True)
            + _encoder_shapes("joint_transformer", H, m.joint_num_layers, False)
            + [("head.weight", (H, H)), ("head.bias", (H,)), ("contrastive_scales", (3,))])


def decayed(name: str, shape, scan_layers: bool) -> bool:
    """Whether the pretraining chain decays this parameter: its leaf in the
    model's published (flax) layout has more than one axis. Per-layer
    leaves carry the stacked layer axis under ``scan_layers``, and the
    attention pools' q, k, v biases are [heads, head size]."""
    if len(shape) > 1 or (scan_layers and ".layers." in name):
        return True
    return ".seq_attnpool." in name and name.rsplit(".", 2)[-2] in ("query", "key", "value") \
        and name.endswith(".bias")
