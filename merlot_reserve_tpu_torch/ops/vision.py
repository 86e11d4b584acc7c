"""Image preprocessing on the device: resize, pad and patchify.

A raw frame [H, W, 3] becomes the ViT's patches: an aspect-preserving
bilinear resize to fit the target box, clip to [0, 1], zero pad bottom and
right, then ``space_to_depth`` with P = 16 into [grid_h * grid_w, 768] in
``tf.nn.space_to_depth`` channel order, as the JAX package does.

The resize is JAX's own: ``jax.image.resize(..., "bilinear",
antialias=True)`` contracts each axis whose size changes with a triangle
weight matrix, widened by the scale when it downscales. The same matrices
are built here in numpy in f32 by JAX's formulas and applied as two
products in true f32. ``F.interpolate`` is not used: its antialiased
weights are cut at other support edges (2e-6 off at 50x333 -> 48x319), and
its plain bilinear does not widen the kernel when it downscales.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from merlot_reserve_tpu_torch.utils.device import ieee_f32_matmul, resolve_device


def _on_device(x, device) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) on ``device``, which must exist."""
    return torch.as_tensor(x).to(resolve_device(device))


def space_to_depth(img: torch.Tensor, patch_size: int = 16) -> torch.Tensor:
    """[..., H, W, C] -> [..., (H/P)*(W/P), P*P*C] in tf.nn.space_to_depth order."""
    *lead, H, W, C = img.shape
    P = patch_size
    if H % P or W % P:
        raise ValueError(f"image {H}x{W} is not a multiple of the patch size {P}")
    x = img.reshape(*lead, H // P, P, W // P, P, C).transpose(-4, -3)
    return x.reshape(*lead, (H // P) * (W // P), P * P * C)


def depth_to_space(patches: torch.Tensor, grid: Tuple[int, int], patch_size: int = 16,
                   channels: int = 3) -> torch.Tensor:
    """Inverse of ``space_to_depth`` (for inspection)."""
    h, w = grid
    P = patch_size
    *lead, hw, ppc = patches.shape
    if hw != h * w or ppc != P * P * channels:
        raise ValueError(f"patches [{hw}, {ppc}] do not fit grid {grid} of {P}x{P}x{channels}")
    x = patches.reshape(*lead, h, w, P, P, channels).transpose(-4, -3)
    return x.reshape(*lead, h * P, w * P, channels)


@lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] f32 weights of JAX's antialiased bilinear resize
    along one axis (``jax.image.scale_and_translate``, translation 0), in
    f32 as XLA computes them: the sample position (i + 0.5) / scale - 0.5
    rounded once, as the fused multiply-add XLA emits on the CPU (and nvcc
    for torch's own bilinear), and the division by the kernel's width a
    product with its f32 reciprocal. Where XLA rounds a position twice, its
    weights differ from these by one ulp of the position (under 1e-6 at
    the tested shapes; about 1.5e-5 on a 300-pixel axis)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))  # JAX's 1. / scale of a Python float
    positions = np.arange(out_size, dtype=np.float64) + 0.5
    sample_f = (positions * np.float64(inv_scale) - 0.5).astype(f32)  # exact, rounded once
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
    if inv_scale > 1:  # downscaling: the triangle widens by 1 / scale
        x = x * (f32(1.0) / inv_scale)
    weights = np.maximum(f32(0.0), f32(1.0) - x)
    total = weights.sum(0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(np.float32)


@lru_cache(maxsize=64)
def _device_resize_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights(in_size, out_size)).to(device)


def _resized_size(h: int, w: int, output_size: Tuple[int, int]) -> Tuple[float, int, int]:
    """(scale, sh, sw), in Python floats as the JAX package computes them."""
    scale = min(output_size[0] / h, output_size[1] / w)
    return scale, int(h * scale), int(w * scale)


def _resize_and_pad(images: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
    """[N, H, W, C] f32 -> [N, dh, dw, C]."""
    dh, dw = output_size
    h, w = images.shape[1], images.shape[2]
    _, sh, sw = _resized_size(h, w, output_size)
    x = images
    with ieee_f32_matmul():
        if sh != h:
            x = torch.einsum("nhwc,ho->nowc", x, _device_resize_weights(h, sh, x.device))
        if sw != w:
            x = torch.einsum("nhwc,wo->nhoc", x, _device_resize_weights(w, sw, x.device))
    return F.pad(x.clamp(0.0, 1.0), (0, 0, 0, dw - sw, 0, dh - sh))


def resize_and_pad(image, output_size: Tuple[int, int], device="cuda"):
    """Aspect-preserving resize of one [H, W, 3] image in [0, 1] into the
    box ``output_size`` = (dh, dw), plus bottom/right zero padding.

    :return: ([dh, dw, 3] f32, image_info [7] f32: the resized height and
             width as fractions of the box, 1/scale, the original height
             and width, and two zero offsets)
    """
    image = _on_device(image, device).float()
    h, w = image.shape[:2]
    scale, sh, sw = _resized_size(h, w, output_size)
    info = torch.tensor([sh / output_size[0], sw / output_size[1], 1.0 / scale, float(h),
                         float(w), 0.0, 0.0], dtype=torch.float32, device=image.device)
    return _resize_and_pad(image[None], output_size)[0], info


def _to_unit_float(images: torch.Tensor) -> torch.Tensor:
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images.float()


def preprocess_image_to_patches(img, output_grid_size: Tuple[int, int], patch_size: int = 16,
                                device="cuda") -> torch.Tensor:
    """uint8 or float [H, W, 3] -> [grid_h * grid_w, P*P*3] f32 patches."""
    return batch_preprocess_images(_on_device(img, device)[None], output_grid_size,
                                   patch_size, device)[0]


def batch_preprocess_images(imgs, output_grid_size: Tuple[int, int], patch_size: int = 16,
                            device="cuda") -> torch.Tensor:
    """[N, H, W, 3] frames of one raw size -> [N, grid_h * grid_w, P*P*3] f32."""
    h1, w1 = output_grid_size
    imgs = _to_unit_float(_on_device(imgs, device))
    return space_to_depth(_resize_and_pad(imgs, (h1 * patch_size, w1 * patch_size)),
                          patch_size)
