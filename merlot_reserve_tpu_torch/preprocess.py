"""Video preprocessing: the ``video_to_segments`` / ``preprocess_video``
surface of the JAX package's ``preprocess.py``, with the log-mel and the
resize and patchify on ``device`` (``ops.audio``, ``ops.vision``).

ffmpeg and ffprobe only decode (frames and PCM), through subprocess; without
them the file entry points raise. ``segments_from_arrays`` is the entry that
needs no decoder: frames [N, H, W, 3] and a waveform in, segment dicts out.
Every function that computes takes ``device``, the card unless the caller
passes ``"cpu"``, and returns numpy arrays as the JAX package does.
"""

from __future__ import annotations

import concurrent.futures
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from merlot_reserve_tpu_torch.ops.audio import batch_make_spectrogram, make_spectrogram
from merlot_reserve_tpu_torch.ops.vision import batch_preprocess_images
from merlot_reserve_tpu_torch.tokenizer import AUDIOSPAN, get_tokenizer

_FFMPEG = "ffmpeg"
_FFPROBE = "ffprobe"


def _require_ffmpeg():
    from shutil import which

    if which(_FFMPEG) is None or which(_FFPROBE) is None:
        raise RuntimeError(
            "ffmpeg/ffprobe not found on PATH — video file decoding needs them. "
            "Pre-decoded inputs can use segments_from_arrays() instead.")


# ---------------------------------------------------------------------------
# black bars (numpy; matches preprocess.py:34-59)
# ---------------------------------------------------------------------------


def detect_black_bars(frames: np.ndarray, blackbar_threshold: int = 16,
                      max_perc_to_trim: float = 0.2) -> Tuple[int, int, int, int]:
    """[N, H, W, 3] -> (y1, y2, x1, x2) crop that removes black bars, trimming
    at most max_perc_to_trim per side."""
    has_content = frames.max(axis=(0, -1)) >= blackbar_threshold
    h, w = has_content.shape

    y_frames = np.where(has_content.any(1))[0]
    if y_frames.size == 0:
        y_frames = np.array([h // 2])
    y1 = min(y_frames[0], int(h * max_perc_to_trim))
    y2 = max(y_frames[-1] + 1, int(h * (1 - max_perc_to_trim)))

    x_frames = np.where(has_content.any(0))[0]
    if x_frames.size == 0:
        x_frames = np.array([w // 2])
    x1 = min(x_frames[0], int(w * max_perc_to_trim))
    x2 = max(x_frames[-1] + 1, int(w * (1 - max_perc_to_trim)))
    return int(y1), int(y2), int(x1), int(x2)


# ---------------------------------------------------------------------------
# ffmpeg decode (host, subprocess)
# ---------------------------------------------------------------------------


def video_duration(video_fn: str) -> float:
    _require_ffmpeg()
    out = subprocess.run(
        [_FFPROBE, "-v", "error", "-select_streams", "a", "-show_entries",
         "stream=duration", "-of", "csv=p=0", video_fn],
        capture_output=True, text=True).stdout.strip().splitlines()
    if not out or not out[0]:
        raise ValueError(f"could not parse audio stream duration for {video_fn}")
    return float(out[0])


def extract_single_frame(video_fn: str, t: float) -> Optional[np.ndarray]:
    """Seek-decode one RGB frame at time t (seconds)."""
    _require_ffmpeg()
    probe = subprocess.run(
        [_FFPROBE, "-v", "error", "-select_streams", "v:0", "-show_entries",
         "stream=width,height", "-of", "csv=p=0", video_fn],
        capture_output=True, text=True).stdout.strip()
    try:
        w, h = (int(x) for x in probe.split(",")[:2])
    except ValueError:
        return None
    cmd = [_FFMPEG, "-ss", f"{t:.3f}", "-i", video_fn, "-frames:v", "1",
           "-f", "rawvideo", "-pix_fmt", "rgb24", "-v", "error", "pipe:1"]
    raw = subprocess.run(cmd, capture_output=True).stdout
    if len(raw) < w * h * 3:
        return None
    return np.frombuffer(raw[:w * h * 3], dtype=np.uint8).reshape(h, w, 3)


def extract_frames_from_video(video_fn: str, times: Sequence[float],
                              use_multithreading: bool = True,
                              blackbar_threshold: int = 32,
                              max_perc_to_trim: float = 0.20) -> Optional[np.ndarray]:
    """Frames at the given timestamps, black bars trimmed
    (preprocess.py:83-118 surface)."""
    if use_multithreading:
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            frames = list(ex.map(lambda t: extract_single_frame(video_fn, t), times))
    else:
        frames = [extract_single_frame(video_fn, t) for t in times]
    if any(f is None for f in frames):
        return None
    frames = np.stack(frames)
    y1, y2, x1, x2 = detect_black_bars(frames, blackbar_threshold, max_perc_to_trim)
    return frames[:, y1:y2, x1:x2]


def extract_audio_waveform(video_fn: str, sr: int = 22050) -> np.ndarray:
    """Decode the audio track to mono float32 at the given rate."""
    _require_ffmpeg()
    cmd = [_FFMPEG, "-i", video_fn, "-ac", "1", "-ar", str(sr), "-f", "f32le",
           "-v", "error", "pipe:1"]
    raw = subprocess.run(cmd, capture_output=True).stdout
    waveform = np.frombuffer(raw, dtype=np.float32).copy()
    waveform /= max(np.abs(waveform).max(), 1.0)
    return waveform


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------


def segments_from_arrays(frames: np.ndarray, waveform: np.ndarray,
                         times: List[Dict], sr: int = 22050,
                         playback_speed: int = 1, device="cuda") -> List[Dict]:
    """Decode-independent segment builder: frames [N, Hc, Wc, 3] + waveform +
    per-segment {'start_time','end_time','mid_time'} -> segment dicts with
    'frame' and 'spectrogram' ([3, 60, 65], computed on device in one batch).
    """
    if len(frames) != len(times):
        raise ValueError(f"{len(frames)} frames for {len(times)} segment times")
    seg_len = int(sr * 5.0)

    desired_final = int(sr * max(t["end_time"] for t in times))
    if waveform.size < desired_final:
        waveform = np.concatenate(
            [waveform, np.zeros(desired_final - waveform.size, np.float32)])

    clips = []
    for t in times:
        start = int(sr * t["start_time"])
        end = int(sr * t["end_time"])
        wav = waveform[start:end]
        if wav.size < seg_len:  # center-pad short segments (zero-shot variant)
            left = (seg_len - wav.size) // 2
            right = seg_len - wav.size - left
            wav = np.concatenate([np.zeros(left, np.float32), wav,
                                  np.zeros(right, np.float32)])
        clips.append(wav[:seg_len])

    specs = batch_make_spectrogram(np.stack(clips), playback_speed=playback_speed, sr=sr,
                                   device=device).cpu().numpy()
    out = []
    for i, t in enumerate(times):
        seg = dict(t)
        seg["frame"] = frames[i]
        seg["spectrogram"] = specs[i]
        seg["idx"] = i
        out.append(seg)
    return out


def video_to_segments(video_fn: str, time_interval: float = 5.0,
                      segment_start_time: float = 0.0,
                      num_segments_max: Optional[int] = None, device="cuda") -> List[Dict]:
    """Video file -> list of 5-s segments with frame + spectrogram
    (preprocess.py:185-271 surface)."""
    duration = video_duration(video_fn) - 1.0
    if duration < 5:
        raise ValueError(f"Video {video_fn} is too short")

    times = []
    st = segment_start_time
    while (st + time_interval) < duration:
        et = min(duration, st + time_interval)
        times.append({"start_time": st, "end_time": et, "mid_time": (st + et) / 2.0})
        st = et
        if num_segments_max is not None and len(times) >= num_segments_max:
            break

    frames = extract_frames_from_video(video_fn, [t["mid_time"] for t in times])
    if frames is None:
        raise ValueError(f"frame extraction failed for {video_fn}")
    waveform = extract_audio_waveform(video_fn)
    return segments_from_arrays(frames, waveform, times, device=device)


def video_to_segments_zero_shot(video_fn: str, time_interval: float = 1.0,
                                times: Optional[List[Dict]] = None,
                                device="cuda") -> List[Dict]:
    """Caller-provided segment times; short segments center-padded to 5 s
    (preprocess.py:274-346 surface)."""
    if times is None:
        raise ValueError("video_to_segments_zero_shot needs the segment times")
    frames = extract_frames_from_video(video_fn, [t["mid_time"] for t in times])
    if frames is None:
        raise ValueError(f"frame extraction failed for {video_fn}")
    waveform = extract_audio_waveform(video_fn)
    # zero-shot variant: segments shorter than 5 s are center-padded; segments
    # >= 5 s are re-centered around mid_time
    fixed = []
    for t in times:
        t = dict(t)
        if (t["end_time"] - t["start_time"]) >= 5.0:
            t["start_time"] = t["mid_time"] - 2.5
            t["end_time"] = t["mid_time"] + 2.5
        fixed.append(t)
    return segments_from_arrays(frames, waveform, fixed, device=device)


def video_to_segments_for_action_segmentation(video_fn: str,
                                              time_interval: float = 1.0,
                                              segment_start_time: float = 0.5,
                                              device="cuda") -> List[Dict]:
    """Dense per-second predictions over a whole video
    (preprocess.py:349-460 surface): 1-second frame segments; each PAIR of
    consecutive segments shares one ~4.79 s audio window whose two
    subsegments (pad_size=0 spectrogram) are assigned one per segment."""
    duration = video_duration(video_fn) - 0.5
    times = []
    st = segment_start_time
    while (st + time_interval) < duration:
        et = min(duration, st + time_interval)
        times.append({"start_time": st, "end_time": et, "mid_time": (st + et) / 2.0})
        st = et

    frames = extract_frames_from_video(video_fn, [t["mid_time"] for t in times])
    if frames is None:
        raise ValueError(f"frame extraction failed for {video_fn}")
    waveform = extract_audio_waveform(video_fn)
    return dense_segments_from_arrays(frames, waveform, times, device=device)


def dense_segments_from_arrays(frames: np.ndarray, waveform: np.ndarray,
                               times: List[Dict], sr: int = 22050,
                               device="cuda") -> List[Dict]:
    """Decode-independent core of the action-segmentation variant: audio over
    each consecutive segment pair -> pad_size=0 spectrogram -> one [1, 60, 65]
    subsegment per 1-second segment."""
    desired_final = int(sr * max(t["end_time"] for t in times))
    if waveform.size < desired_final:
        waveform = np.concatenate(
            [waveform, np.zeros(desired_final - waveform.size, np.float32)])

    total_audio_len = int(sr * 4.79)
    start_pad = int(sr * 0.05)
    spectrograms = []
    end_idx = 0
    for i in range(len(times) // 2):
        start_idx = int(sr * times[2 * i]["start_time"])
        end_idx = int(sr * times[2 * i + 1]["end_time"])
        wav = waveform[start_idx:end_idx]
        end_pad = max(total_audio_len - wav.size - start_pad, 0)
        wav = np.concatenate([np.zeros(start_pad, np.float32), wav,
                              np.zeros(end_pad, np.float32)])[:total_audio_len]
        spec = make_spectrogram(wav, pad_size=0, sr=sr, device=device).cpu().numpy()
        spectrograms.append(spec[0, None])
        spectrograms.append(spec[1, None])
    if len(spectrograms) != len(times):  # odd count: one more window
        wav = waveform[end_idx:]
        wav = wav[:total_audio_len - start_pad]
        end_pad = total_audio_len - wav.size - start_pad
        wav = np.concatenate([np.zeros(start_pad, np.float32), wav,
                              np.zeros(end_pad, np.float32)])
        spec = make_spectrogram(wav, pad_size=0, sr=sr, device=device).cpu().numpy()
        spectrograms.append(spec[0, None])

    out = []
    for i, (f, s, t) in enumerate(zip(frames, spectrograms, times)):
        seg = dict(t)
        seg["frame"] = f
        seg["spectrogram"] = s
        seg["idx"] = i
        out.append(seg)
    return out


def preprocess_video(video_segments: List[Dict], output_grid_size: Tuple[int, int],
                     verbose: bool = False, device="cuda") -> Dict[str, np.ndarray]:
    """Segments -> model inputs (preprocess.py:484-551 surface).

    Each segment dict needs 'frame' ([H, W, 3]) and 'spectrogram' ([3, 60, 65]),
    plus either 'text' (str or token list) with use_text_as_input=True
    (default), or use_text_as_input=False to feed the audio.

    :return: {'images' [N, hw, 768], 'audio_clips' [3N, 60, 65],
              'tokens' [160], 'subseg_idxs' [160]}
    """
    if len(video_segments) > 8:
        raise ValueError("at most 8 segments are supported")
    encoder = get_tokenizer()

    frames = np.stack([np.asarray(s["frame"]) for s in video_segments])
    if frames.dtype != np.uint8 and frames.max() > 1.5:
        frames = frames.astype(np.uint8)
    images = batch_preprocess_images(frames, output_grid_size, device=device).cpu().numpy()

    subseg_idxs: List[int] = []
    audio_clips = []
    tokens_out: List[int] = []
    for i, seg in enumerate(video_segments):
        if seg.get("use_text_as_input", True):
            txt = seg.get("text", "")
            if isinstance(txt, str):
                txt_tok = encoder.encode(txt).ids
            else:
                txt_tok = list(txt)
            if verbose:
                print(f"Segment {i}: text input: {txt}")
            audio_clips.append(np.zeros([3, 60, 65], dtype=np.float32))
            subseg_idxs.extend([i * 3] * len(txt_tok))
            tokens_out.extend(txt_tok)
        else:
            if verbose:
                print(f"Segment {i}: audio input")
            audio_clips.append(np.asarray(seg["spectrogram"]))
            tokens_out.extend([AUDIOSPAN] * 18)
            subseg_idxs.extend((i * 3 + np.arange(18) // 6).tolist())

    if len(tokens_out) >= 160:
        tokens_out = tokens_out[:160]
        subseg_idxs = subseg_idxs[:160]
    while len(tokens_out) < 160:
        tokens_out.append(0)
        subseg_idxs.append(-1)

    return {
        "images": images,
        "audio_clips": np.stack(audio_clips).reshape(-1, 60, 65).astype(np.float32),
        "tokens": np.array(tokens_out, dtype=np.int32),
        "subseg_idxs": np.array(subseg_idxs, dtype=np.int32),
    }
