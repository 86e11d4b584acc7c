"""Spectrogram JPEG quantization for dataset creation.

The port of ``merlot_reserve_tpu/dataset_creation/spectrogram.py`` on the
data library's JPEG codec (``data/native.py``) in place of PIL. Log-mel
values are scaled by magic_number = 255 / max(percentile99, 1), cut to
uint8 and stored as a grayscale JPEG in the [num_mels, T] layout; the
loader divides by magic_number to dequantize (reference
data/video_utils.py:250-293).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from merlot_reserve_tpu_torch.data.native import decode_jpeg_native, encode_jpeg_native


def quantize_plane(log_mel: np.ndarray) -> Tuple[np.ndarray, float]:
    """[num_mels, T] log-mel -> (the uint8 plane, magic_number)."""
    perc99 = max(np.percentile(log_mel, 99), 1.0)
    magic_number = 255.0 / perc99
    return np.minimum(log_mel * magic_number, 255.0).astype(np.uint8), float(magic_number)


def quantize_spectrogram(log_mel: np.ndarray, quality: int = 90) -> Tuple[bytes, float]:
    """[num_mels, T] log-mel -> (jpeg bytes, magic_number)."""
    plane, magic_number = quantize_plane(log_mel)
    return encode_jpeg_native(plane, quality), magic_number


def dequantize_spectrogram(jpeg: bytes, magic_number: float) -> np.ndarray:
    return decode_jpeg_native(jpeg, 1).astype(np.float32) / magic_number
