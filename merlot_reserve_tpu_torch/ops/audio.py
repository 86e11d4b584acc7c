"""Audio on the device: waveform -> log-mel spectrogram, as two products.

    frames[T, n_fft] @ windowed DFT basis[n_fft, n_bins]  (cos and sin) -> power
    power[T, n_bins] @ mel weights[n_bins, n_mels]                       -> mel

This is the JAX package's design (``merlot_reserve_tpu/ops/audio.py``), not
``torch.stft``: the same bases, built in numpy, and the same products. The
semantics are librosa's, as the reference calls it: centered frames with
reflect padding of n_fft // 2, the symmetric hann window (scipy's
``hann(n_fft)``), the power spectrum, slaney mel filters with slaney
normalization, fmin 20 and fmax sr / 2; then log(mel + 0.1) - log(0.1),
the playback speed as a 65th channel, and [188, 65] cut into three
[60, 65] subsegments with pad_size frames around them.

The products run in true f32 whatever the caller's TF32 setting
(``utils.device.ieee_f32_matmul`` sets and restores it around them): with
TF32, an n_fft of 1536 drifts.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from merlot_reserve_tpu_torch.utils.device import ieee_f32_matmul, resolve_device

# ---------------------------------------------------------------------------
# bases, built once in numpy
# ---------------------------------------------------------------------------


def hann_window(n: int) -> np.ndarray:
    """The symmetric hann window (scipy's ``hann(n)``)."""
    if n == 1:
        return np.ones(1)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    return np.where(log_t, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@lru_cache(maxsize=16)
def mel_filterbank(sr: int = 22050, n_fft: int = 1536, n_mels: int = 64,
                   fmin: float = 20.0, fmax: float = 11025.0) -> np.ndarray:
    """[n_bins, n_mels] slaney-normalized triangular mel filters
    (librosa.filters.mel with htk=False, norm='slaney')."""
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


@lru_cache(maxsize=16)
def _dft_mel_basis(n_fft: int, sr: int, n_mels: int, fmin: float,
                   fmax: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Windowed DFT cos and sin bases [n_fft, n_bins] and the mel weights."""
    n_bins = 1 + n_fft // 2
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    window = hann_window(n_fft)[:, None]
    cos_b = (np.cos(ang) * window).astype(np.float32)
    sin_b = (-np.sin(ang) * window).astype(np.float32)
    return cos_b, sin_b, mel_filterbank(sr, n_fft, n_mels, fmin, fmax)


@lru_cache(maxsize=16)
def _device_bases(n_fft: int, sr: int, n_mels: int, fmin: float, fmax: float,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cos|sin basis [n_fft, 2 * n_bins] and mel weights on ``device``."""
    cos_b, sin_b, mel_w = _dft_mel_basis(n_fft, sr, n_mels, fmin, fmax)
    dft = torch.from_numpy(np.concatenate([cos_b, sin_b], 1)).to(device)
    return dft, torch.from_numpy(mel_w).to(device)


# ---------------------------------------------------------------------------
# the device pipeline
# ---------------------------------------------------------------------------


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centered frames with reflect padding: [..., samples] -> [..., n_frames, n_fft]."""
    pad = n_fft // 2
    lead = y.shape[:-1]
    y = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")
    return y.reshape(*lead, y.shape[-1]).unfold(-1, n_fft, hop)


def mel_power_spectrogram(y, *, sr: int = 22050, n_fft: int = 1536, hop_length: int = 588,
                          n_mels: int = 64, fmin: float = 20.0, fmax: float = 11025.0,
                          device="cuda") -> torch.Tensor:
    """[..., samples] waveform -> [..., n_frames, n_mels] f32 mel power
    spectrum (librosa.feature.melspectrogram semantics)."""
    device = resolve_device(device)
    y = torch.as_tensor(y).to(device, torch.float32)
    dft, mel_w = _device_bases(n_fft, sr, n_mels, float(fmin), float(fmax), device)
    n_bins = dft.shape[1] // 2
    frames = frame_signal(y, n_fft, hop_length)
    with ieee_f32_matmul():
        spec = frames @ dft
        re, im = spec[..., :n_bins], spec[..., n_bins:]
        return (re * re + im * im) @ mel_w


SEQ_SIZE = 60  # frames per subsegment
N_MELS = 64


def make_spectrogram(waveform, playback_speed: int = 1, sr: int = 22050, pad_size: int = 2,
                     device="cuda") -> torch.Tensor:
    """The waveforms of 5-second segments, [..., samples] (one or a whole
    video's), -> log-mel subsegments [..., 3, SEQ_SIZE, N_MELS + 1] f32."""
    seq_size = SEQ_SIZE
    mel = mel_power_spectrogram(waveform, sr=sr, n_fft=1536 * playback_speed,
                                hop_length=588 * playback_speed, n_mels=N_MELS, fmin=20.0,
                                fmax=sr / 2.0, device=device)
    eps = 0.1
    log_mel = torch.log(mel + eps) - math.log(eps)

    total = seq_size * 3 + pad_size * 4
    if log_mel.shape[-2] != total:
        raise ValueError(
            f"spectrogram has {log_mel.shape[-2]} frames; expected {total} "
            f"(waveform must be {total - 1} hops plus change, i.e. 5s at sr={sr})")

    speed = log_mel.new_full((*log_mel.shape[:-1], 1), float(playback_speed))
    log_mel = torch.cat([log_mel, speed], -1)
    starts = [(j + 1) * pad_size + j * seq_size for j in range(3)]
    return torch.stack([log_mel[..., s:s + seq_size, :] for s in starts], -3)


batch_make_spectrogram = make_spectrogram  # the JAX package's name for [B, samples]
