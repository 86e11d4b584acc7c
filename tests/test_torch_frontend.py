"""Port parity: the front end (merlot_reserve_tpu_torch.ops.vision and
ops.audio) against the JAX package's ops/vision.py and ops/audio.py on the
same numpy inputs, on the CPU.

Tolerances: space_to_depth and depth_to_space exact; the resize, its
image_info and the patches within 1e-6 of JAX at shapes that downscale,
upscale and keep the size. Log-mel within 1e-3 absolute of JAX's; both held
to tests/test_audio_dsp.py's limits against an f64 numpy oracle (mel power
rtol 2e-3 / atol 1e-4, log-mel rtol 1e-3 / atol 2e-3)."""

import numpy as np
import pytest
import scipy.signal
import torch

from merlot_reserve_tpu.ops import audio as JA
from merlot_reserve_tpu.ops import vision as JV
from merlot_reserve_tpu_torch.ops import audio as TA
from merlot_reserve_tpu_torch.ops import vision as TV
from merlot_reserve_tpu_torch.utils.device import ieee_f32_matmul

VISION_ATOL = 1e-6
LOGMEL_ATOL = 1e-3
# (raw H, W) -> box (dh, dw): three that downscale, one that upscales, one
# of scale 1 (the bench's frame into the base 12x20 grid's box)
RESIZE_CASES = [((360, 640), (180, 320)), ((481, 777), (192, 310)), ((50, 333), (48, 320)),
                ((100, 150), (192, 288)), ((180, 320), (192, 320))]


def _frames(shape, seed, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape, dtype=np.uint8)
    return rng.rand(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# vision
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(352, 640, 3), (2, 64, 48, 3)])
def test_space_to_depth_matches_jax_exactly(shape):
    img = _frames(shape, 0, np.float32)
    ours = TV.space_to_depth(torch.from_numpy(img), 16).numpy()
    np.testing.assert_array_equal(ours, np.asarray(JV.space_to_depth(img, 16)))


def test_depth_to_space_inverts_and_matches_jax_exactly():
    patches = _frames((22 * 40, 768), 1, np.float32)
    ours = TV.depth_to_space(torch.from_numpy(patches), (22, 40), 16)
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(JV.depth_to_space(patches, (22, 40), 16)))
    np.testing.assert_array_equal(TV.space_to_depth(ours, 16).numpy(), patches)


def test_space_to_depth_rejects_a_partial_patch():
    with pytest.raises(ValueError, match="patch size"):
        TV.space_to_depth(torch.zeros(20, 32, 3), 16)


@pytest.mark.parametrize("raw,box", RESIZE_CASES)
def test_resize_and_pad_matches_jax(raw, box):
    img = _frames((*raw, 3), 2, np.float32)
    j_img, j_info = JV.resize_and_pad(img, box)
    ours, info = TV.resize_and_pad(img, box, device="cpu")
    assert ours.shape == (*box, 3) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(j_img), atol=VISION_ATOL, rtol=0)
    np.testing.assert_allclose(info.numpy(), np.asarray(j_info), atol=VISION_ATOL, rtol=0)


@pytest.mark.parametrize("raw", [(360, 640), (100, 150), (180, 320)])
def test_patches_match_jax(raw):
    frames = _frames((3, *raw, 3), 3)
    ours = TV.batch_preprocess_images(frames, (12, 20), device="cpu").numpy()
    np.testing.assert_allclose(ours, np.asarray(JV.batch_preprocess_images(frames, (12, 20))),
                               atol=VISION_ATOL, rtol=0)
    single = TV.preprocess_image_to_patches(frames[1], (12, 20), device="cpu").numpy()
    np.testing.assert_array_equal(single, ours[1])
    assert ours.shape == (3, 240, 768) and 0.0 <= ours.min() and ours.max() <= 1.0


def test_float_frames_are_not_rescaled():
    frames = _frames((1, 180, 320, 3), 4, np.float32)
    ours = TV.batch_preprocess_images(frames, (12, 20), device="cpu").numpy()
    np.testing.assert_allclose(ours, np.asarray(JV.batch_preprocess_images(frames, (12, 20))),
                               atol=VISION_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------


def _numpy_log_mel(y, playback_speed=1, sr=22050, n_mels=64):
    """f64 oracle: librosa's algorithm with numpy's FFT."""
    n_fft, hop = 1536 * playback_speed, 588 * playback_speed
    window = scipy.signal.windows.hann(n_fft)
    ypad = np.pad(y.astype(np.float64), n_fft // 2, mode="reflect")
    n_frames = 1 + (len(ypad) - n_fft) // hop
    frames = np.stack([ypad[i * hop:i * hop + n_fft] for i in range(n_frames)])
    power = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2
    mel = power @ JA.mel_filterbank(sr, n_fft, n_mels, 20.0, sr / 2.0).astype(np.float64)
    return mel, np.log(mel + 0.1) - np.log(0.1)


@pytest.fixture(scope="module")
def waveform():
    rng = np.random.RandomState(0)
    t = np.arange(110250) / 22050.0  # exactly 5 s
    y = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 2200 * t)
         + 0.05 * rng.randn(len(t)))
    return y.astype(np.float32)


def test_bases_match_jax():
    np.testing.assert_array_equal(TA.hann_window(1536), JA.hann_window(1536))
    np.testing.assert_allclose(TA.hann_window(1536), scipy.signal.windows.hann(1536),
                               atol=1e-12)
    np.testing.assert_array_equal(TA.hann_window(64), JA.hann_window(64))
    np.testing.assert_array_equal(TA.mel_filterbank(22050, 1536, 64, 20.0, 11025.0),
                                  JA.mel_filterbank(22050, 1536, 64, 20.0, 11025.0))
    for ours, theirs in zip(TA._dft_mel_basis(1536, 22050, 64, 20.0, 11025.0),
                            JA._dft_mel_basis(1536, 22050, 64, 20.0, 11025.0)):
        np.testing.assert_array_equal(ours, theirs)


def test_frame_signal_matches_jax(waveform):
    y = waveform[:5000]
    ours = TA.frame_signal(torch.from_numpy(np.stack([y, -y])), 1536, 588).numpy()
    np.testing.assert_array_equal(ours, np.asarray(JA.frame_signal(np.stack([y, -y]), 1536, 588)))


def test_mel_power_matches_jax_and_the_oracle(waveform):
    ours = TA.mel_power_spectrogram(waveform, device="cpu").numpy()
    mel, _ = _numpy_log_mel(waveform)
    assert ours.shape == (188, 64)
    np.testing.assert_allclose(ours, mel, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(ours, np.asarray(JA.mel_power_spectrogram(waveform)),
                               rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("playback_speed", [1, 2])
def test_make_spectrogram_matches_jax_and_the_oracle(waveform, playback_speed):
    y = np.tile(waveform, playback_speed)  # 5 s of audio at the playback speed
    ours = TA.make_spectrogram(y, playback_speed=playback_speed, device="cpu").numpy()
    theirs = np.asarray(JA.make_spectrogram(y, playback_speed=playback_speed))
    assert ours.shape == theirs.shape == (3, 60, 65)
    np.testing.assert_allclose(ours, theirs, atol=LOGMEL_ATOL, rtol=0)
    np.testing.assert_array_equal(ours[..., 64], float(playback_speed))
    _, log_mel = _numpy_log_mel(y, playback_speed)
    for j, start in enumerate((2, 64, 126)):
        for spec in (ours, theirs):
            np.testing.assert_allclose(spec[j, :, :64], log_mel[start:start + 60],
                                       rtol=1e-3, atol=2e-3)


def test_batch_make_spectrogram_matches_jax(waveform):
    batch = np.stack([waveform, 0.5 * waveform, np.roll(waveform, 777)])
    ours = TA.batch_make_spectrogram(batch, device="cpu").numpy()
    np.testing.assert_allclose(ours, np.asarray(JA.batch_make_spectrogram(batch)),
                               atol=LOGMEL_ATOL, rtol=0)
    np.testing.assert_array_equal(ours[0], TA.make_spectrogram(waveform, device="cpu").numpy())


def test_pad_size_zero_matches_jax(waveform):
    y = waveform[:int(22050 * 4.79)]
    ours = TA.make_spectrogram(y, pad_size=0, device="cpu").numpy()
    np.testing.assert_allclose(ours, np.asarray(JA.make_spectrogram(y, pad_size=0)),
                               atol=LOGMEL_ATOL, rtol=0)


def test_wrong_length_raises():
    with pytest.raises(ValueError, match="expected 188"):
        TA.make_spectrogram(np.zeros(5000, np.float32), device="cpu")


@pytest.mark.parametrize("api,setting", [("legacy", True), ("legacy", False),
                                         ("new", "tf32"), ("new", "ieee")])
def test_true_f32_block_restores_the_callers_setting(api, setting, waveform):
    """The front end's products run in true f32 and leave the caller's TF32
    choice as it found it, readable afterwards through the API the caller
    set it with (torch refuses to read the legacy flag once the two
    disagree)."""
    matmul = torch.backends.cuda.matmul
    attr = "allow_tf32" if api == "legacy" else "fp32_precision"
    saved = matmul.fp32_precision
    try:
        setattr(matmul, attr, setting)
        with ieee_f32_matmul():
            assert matmul.fp32_precision == "ieee"
        TA.make_spectrogram(waveform, device="cpu")
        TV.batch_preprocess_images(_frames((1, 100, 150, 3), 5), (12, 20), device="cpu")
        assert getattr(matmul, attr) == setting
    finally:
        matmul.fp32_precision = saved
