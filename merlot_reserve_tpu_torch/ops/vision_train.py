"""Training-frame preprocessing on the card: flip-if-vertical, random-scale
resize with one of six Pillow-convention kernels, random crop, zero pad and
patchify, for a batch of frames at once.

The port of ``merlot_reserve_tpu/ops/vision_train.py`` (reference
pretrain/dataloader.py:63-85, pretrain/data_utils.py:8-147). The host only
decodes JPEG bytes into a fixed square uint8 buffer per frame.

The resize's scale, crop and kernel differ per frame, so each axis's
resampling is a dense [dst, src] weight matrix built from Pillow's
antialiased coefficient windows (the convention of the native library's
``mn_resize_patchify_k``), and the resize is two batched products per
frame, horizontal first: ``out = W_y @ (img @ W_x^T)``. They run in IEEE f32
(``utils.device.ieee_f32_matmul``), never TF32: TF32 keeps ten mantissa bits,
about 0.1 of a pixel level at 255. All six filters are evaluated and the
frame's kernel id selects one. The flip works on a square [FB, FB] buffer:
a transpose, a row gather and two column masks.

Draws (scale multiplier, kernel id, crop offsets) come in as tensors
(``draw_augmentations`` turns uniform draws into them, as the JAX package's
in-graph draw does), so a test can give both packages the same numbers.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from merlot_reserve_tpu_torch.utils.device import ieee_f32_matmul

# filter support radii in RESIZE_KERNELS order (data/native.py); NEAREST (id
# 5) is a single-tap special case
_SUPPORT = (2.0, 1.0, 0.5, 1.0, 3.0, 0.0)
NUM_KERNELS = 6
BILINEAR = 1  # the no-augmentation default kernel


def _filter_values(kernel, x):
    """Pillow filter value at signed distance ``x`` (filter units) for each
    frame's ``kernel`` id (0..4; NEAREST is handled by the caller).
    ``kernel`` [F], ``x`` [F, dst, src]."""
    ax = x.abs()
    a = -0.5  # Keys bicubic, Pillow's BICUBIC
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    bicubic = torch.where(ax < 1.0, ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
                          torch.where(ax < 2.0, (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a, zero))
    bilinear = (1.0 - ax).clamp(min=0.0)
    box = ((x > -0.5) & (x <= 0.5)).to(x.dtype)
    pix = torch.where(ax == 0.0, torch.ones_like(ax), math.pi * ax)  # a safe denominator
    sinc = torch.sin(pix) / pix
    hamming = torch.where(ax >= 1.0, zero,
                          torch.where(ax == 0.0, 1.0, sinc * (0.54 + 0.46 * torch.cos(pix))))
    px3 = pix / 3.0
    lanczos = torch.where(ax >= 3.0, zero,
                          torch.where(ax == 0.0, 1.0, sinc * torch.sin(px3) / px3))
    stacked = torch.stack([bicubic, bilinear, box, hamming, lanczos], 0)
    k = kernel.long().clamp(0, 4).view(1, -1, 1, 1).expand(1, *x.shape)
    return torch.gather(stacked, 0, k)[0]


def resample_weights(kernel, in_size, out_full, out_lo, out_valid, src_max: int,
                     dst_size: int):
    """Each frame's resampling matrix along one axis, [F, dst_size, src_max].

    Per frame ([F] tensors): ``kernel`` (0..5), ``in_size`` (the source's
    true extent in the src_max buffer), ``out_full`` (the whole resized
    extent before the crop), ``out_lo`` (the crop offset), ``out_valid``
    (output rows that receive content; the rest stay zero, the pad).
    Mirrors the native library's ``mn_precompute``."""
    f32 = dict(dtype=torch.float32, device=kernel.device)
    in_size = in_size.float()[:, None, None]
    out_full = out_full.float().clamp(min=1.0)[:, None, None]
    ratio = in_size / out_full
    filterscale = ratio.clamp(min=1.0)
    support = torch.tensor(_SUPPORT, **f32)[kernel.long().clamp(0, 5)][:, None, None] * filterscale

    i = torch.arange(dst_size, **f32)[None, :, None]
    center = (out_lo.float()[:, None, None] + i + 0.5) * ratio       # [F, dst, 1]
    xmn = torch.floor(center - support + 0.5).clamp(min=0.0)
    xmx = torch.minimum(torch.floor(center + support + 0.5), in_size)

    x = torch.arange(src_max, **f32)[None, None, :]                   # [1, 1, src]
    arg = (x - center + 0.5) / filterscale
    w = _filter_values(kernel, arg)
    w = torch.where((x >= xmn) & (x < xmx), w, 0.0)

    # NEAREST: one tap at the (truncated) sample point
    x0 = torch.minimum(torch.floor(center).clamp(min=0.0), in_size - 1.0)
    w = torch.where((kernel == 5)[:, None, None], (x == x0).float(), w)

    total = w.sum(-1, keepdim=True)
    w = w / torch.where(total == 0.0, 1.0, total)
    return torch.where(i < out_valid.float()[:, None, None], w, 0.0)


def resize_patchify(img, h, w, grid: Tuple[int, int], mult, kernel, off_y, off_x,
                    patch: int = 16):
    """[F, FB, FB, 3] float buffers (0..255) of true extent (h, w) ->
    patches [F, grid_h*grid_w, patch*patch*3] in [0, 1]: aspect-preserving
    resize into the grid box scaled by ``mult``, crop at (off_y, off_x),
    zero pad bottom and right, tf.nn.space_to_depth layout."""
    gh, gw = grid
    dh, dw = gh * patch, gw * patch
    hf, wf = h.float(), w.float()
    scale = torch.minimum(dh / hf, dw / wf) * mult
    sh_full = torch.floor(hf * scale)
    sw_full = torch.floor(wf * scale)
    sh = torch.minimum(sh_full - off_y, torch.full_like(sh_full, float(dh)))
    sw = torch.minimum(sw_full - off_x, torch.full_like(sw_full, float(dw)))

    wy = resample_weights(kernel, h, sh_full, off_y, sh, img.shape[1], dh)
    wx = resample_weights(kernel, w, sw_full, off_x, sw, img.shape[2], dw)
    F, fb_h, fb_w = img.shape[:3]
    rows = img.float().permute(0, 1, 3, 2).reshape(F, fb_h * 3, fb_w)   # [F, h*c, w]
    # on the CPU, oneDNN's bmm was seen to return a first product off by
    # 1e-4 relative in a process that had run XLA; the plain BLAS path is
    # exact f32 there
    mkldnn = torch.backends.mkldnn.enabled
    try:
        torch.backends.mkldnn.enabled = mkldnn and img.device.type != "cpu"
        with ieee_f32_matmul():
            # horizontal pass first, then vertical: the native library's order
            tmp = torch.bmm(rows, wx.transpose(1, 2))                     # [F, h*c, dw]
            out = torch.bmm(wy, tmp.reshape(F, fb_h, 3 * dw))             # [F, dh, c*dw]
    finally:
        torch.backends.mkldnn.enabled = mkldnn
    out = out.reshape(F, dh, 3, dw).permute(0, 1, 3, 2)
    out = (out * (1.0 / 255.0)).clamp(0.0, 1.0)
    return out.reshape(F, gh, patch, gw, patch, 3).transpose(2, 3).reshape(
        F, gh * gw, patch * patch * 3)


def flip_if_vertical(img, h, w):
    """Portrait frames (h >= 4w/3) rotate 90 degrees counter-clockwise and
    gain 4 px 0.5-gray side markers (reference data_utils.py:25-39).
    ``img`` [F, FB, FB, 3] square buffers (uint8 or 0..255 floats) of true
    extent (h, w) [F]; returns (img', h', w')."""
    F, fb = img.shape[0], img.shape[1]
    if img.shape[2] != fb:
        raise ValueError("flip needs square frame buffers")
    flip = h.float() >= 4.0 * w.float() / 3.0

    # rot90(img)[a, b] = img[b, w-1-a]: transpose, then gather rows
    t = img.transpose(1, 2)
    rows = torch.arange(fb, device=img.device)
    src = (w.long()[:, None] - 1 - rows).clamp(0, fb - 1)                  # [F, fb]
    rot = torch.gather(t, 1, src[:, :, None, None].expand(F, fb, fb, 3))
    # content 4 px to the right; markers at cols [0, 4) and [h+4, h+8)
    shifted = rot[:, :, (rows - 4).clamp(0, fb - 1)]
    hh = h.long()[:, None]
    is_marker = (rows < 4) | ((rows >= hh + 4) & (rows < hh + 8))          # [F, fb]
    in_content = ((rows >= 4) & (rows < hh + 4))[:, None, :] & (rows[None, :, None]
                                                               < w.long()[:, None, None])
    flipped = torch.where(is_marker[:, None, :, None], torch.full_like(shifted[:1, :1, :1], 128),
                          torch.where(in_content[..., None], shifted, torch.zeros_like(shifted)))
    out = torch.where(flip[:, None, None, None], flipped, img)
    return out, torch.where(flip, w, h), torch.where(flip, h + 8, w)


def draw_augmentations(mult, kernel, u_off_y, u_off_x, h, w, grid: Tuple[int, int],
                       patch: int = 16) -> Dict[str, torch.Tensor]:
    """Each frame's augmentation from its draws, as the JAX package's
    in-graph draw makes it: the scale multiplier (drawn uniform in the
    config's scale range) and the kernel id as given, integer crop offsets
    uniform over the overhang (``u_off_*`` uniform in [0, 1))."""
    gh, gw = grid
    dh, dw = gh * patch, gw * patch
    hf, wf = h.float(), w.float()
    scale = torch.minimum(dh / hf, dw / wf) * mult
    max_oy = (torch.floor(hf * scale) - dh).clamp(min=0.0)
    max_ox = (torch.floor(wf * scale) - dw).clamp(min=0.0)
    return {"mult": mult, "kernel": kernel, "off_y": torch.floor(u_off_y * (max_oy + 1.0)),
            "off_x": torch.floor(u_off_x * (max_ox + 1.0))}


def augment_frames(frames_u8, frame_hw, grid: Tuple[int, int], draws: Dict[str, torch.Tensor],
                   patch: int = 16):
    """Frames on the card: [..., FB, FB, 3] uint8 buffers and [..., 2] true
    (h, w) -> [..., grid_h*grid_w, patch*patch*3] f32 patches, each frame
    flipped if portrait, then resized, cropped and patchified with its own
    draws. ``draws`` holds [...]-shaped tensors ``mult`` and ``kernel``, and
    either the explicit crop offsets ``off_y``, ``off_x`` (the parity-test
    hook) or uniform ``u_off_y``, ``u_off_x``, which ``draw_augmentations``
    turns into offsets after the flip."""
    lead = frames_u8.shape[:-3]
    fb = frames_u8.shape[-2]
    img = frames_u8.reshape(-1, fb, fb, 3)
    hw = frame_hw.reshape(-1, 2)
    flat = {k: v.reshape(-1) for k, v in draws.items()}
    img, h, w = flip_if_vertical(img, hw[:, 0], hw[:, 1])
    if "off_y" not in flat:
        flat = draw_augmentations(flat["mult"], flat["kernel"], flat["u_off_y"], flat["u_off_x"],
                                  h, w, grid, patch)
    out = resize_patchify(img, h, w, grid, flat["mult"], flat["kernel"], flat["off_y"],
                          flat["off_x"], patch)
    return out.reshape(*lead, *out.shape[1:])
