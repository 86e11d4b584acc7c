#!/usr/bin/env python
"""Cut a local video into model-ready segments with its subtitles attached:
the counterpart of ``demo/load_video.py`` in the PyTorch port, composed
from the port's WebVTT word timing (``utils/subtitles.py``) and ffmpeg
segmentation (``preprocess.video_to_segments``, spectrograms on the card).

No download path: it takes a local video and a local WebVTT file (the
JAX demo fetches both from YouTube with yt-dlp). Runs on the CUDA card
unless ``device="cpu"`` (``--device cpu``) is given.

Library use:
    from demo.load_video_torch import load_video
    segments = load_video("talk.mp4", "talk.en.vtt", start_time=0.0)  # 8 x 5-s segments
    # each segment dict gains segment['sub'] = its midpoint-bucketed words

CLI: python demo/load_video_torch.py VIDEO.mp4 -vtt VIDEO.en.vtt [-start 0.0]
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def attach_subtitles(segments: List[Dict], words: List[Dict]) -> List[Dict]:
    """Bucket transcript words into the segments by their midpoints."""
    from merlot_reserve_tpu_torch.utils.subtitles import words_to_segments

    for seg, sub in zip(segments, words_to_segments(words, segments)):
        seg["sub"] = sub
    return segments


def load_video(video_fn: str, vtt_fn: Optional[str] = None, start_time: float = 0.0,
               num_segments_max: int = 8, device="cuda") -> List[Dict]:
    """5-s segments of ``video_fn`` from ``start_time``, each with ``sub``:
    the words of ``vtt_fn`` (none without one) whose midpoints fall in it."""
    from merlot_reserve_tpu_torch.preprocess import video_to_segments
    from merlot_reserve_tpu_torch.utils.device import resolve_device
    from merlot_reserve_tpu_torch.utils.subtitles import parse_vtt

    device = resolve_device(device)  # refuse before decoding anything
    words = []
    if vtt_fn is not None:
        with open(vtt_fn, encoding="utf-8") as f:
            words = parse_vtt(f.read())
    segments = video_to_segments(video_fn, time_interval=5.0, segment_start_time=start_time,
                                 num_segments_max=num_segments_max, device=device)
    return attach_subtitles(segments, words)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("video")
    ap.add_argument("-vtt", default=None, help="local WebVTT subtitles")
    ap.add_argument("-start", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    segs = load_video(args.video, args.vtt, start_time=args.start, device=args.device)
    for s in segs:
        print(f"[{s['start_time']:.1f}-{s['end_time']:.1f}] {s.get('sub', '')}")
    return segs


if __name__ == "__main__":
    main()
