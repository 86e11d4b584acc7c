"""WebVTT subtitle parsing with YouTube word-level timing (a copy of the JAX
package's ``utils/subtitles.py``).
"""

from __future__ import annotations

import re
from typing import Dict, List

_TS = re.compile(r"(\d+):(\d{2}):(\d{2})[.,](\d{3})")
_CUE = re.compile(
    r"(\d+:\d{2}:\d{2}[.,]\d{3})\s*-->\s*(\d+:\d{2}:\d{2}[.,]\d{3})")
_WORD_TS = re.compile(r"<(\d+:\d{2}:\d{2}[.,]\d{3})>")
_TAG = re.compile(r"</?c[^>]*>")


def _to_seconds(ts: str) -> float:
    m = _TS.match(ts)
    h, mi, s, ms = (int(g) for g in m.groups())
    return h * 3600 + mi * 60 + s + ms / 1000.0


def parse_vtt(text: str) -> List[Dict]:
    """VTT text -> [{'word', 'start', 'end'}] with word-level times where
    available (cue-level interpolation otherwise)."""
    lines = text.replace("\r\n", "\n").split("\n")
    words: List[Dict] = []
    seen = set()

    i = 0
    while i < len(lines):
        m = _CUE.search(lines[i])
        if not m:
            i += 1
            continue
        cue_start, cue_end = _to_seconds(m.group(1)), _to_seconds(m.group(2))
        i += 1
        payload = []
        while i < len(lines) and lines[i].strip() and not _CUE.search(lines[i]):
            payload.append(lines[i])
            i += 1
        body = " ".join(payload)
        if not body.strip():
            continue

        if _WORD_TS.search(body):
            # word-level: split on inline timestamps
            parts = _WORD_TS.split(body)
            # parts = [w0, ts1, w1, ts2, w2, ...]
            t_prev = cue_start
            for j in range(0, len(parts), 2):
                chunk = _TAG.sub("", parts[j]).strip()
                t_next = (_to_seconds(parts[j + 1]) if j + 1 < len(parts)
                          else cue_end)
                for w in chunk.split():
                    key = (w, round(t_prev, 2))
                    if key not in seen:
                        seen.add(key)
                        words.append({"word": w, "start": t_prev, "end": t_next})
                t_prev = t_next
        else:
            # plain cue: distribute words uniformly; skip rolled-up repeats
            toks = _TAG.sub("", body).split()
            if not toks:
                continue
            dt = (cue_end - cue_start) / len(toks)
            for j, w in enumerate(toks):
                start = cue_start + j * dt
                key = (w, round(start, 2))
                if key not in seen:
                    seen.add(key)
                    words.append({"word": w, "start": start, "end": start + dt})
    words.sort(key=lambda d: d["start"])
    return words


def words_to_segments(words: List[Dict], segment_bounds: List[Dict]) -> List[str]:
    """Bucket words into segments by midpoint time (the demo's subtitle
    assignment, load_video.py:276-397)."""
    out = []
    for seg in segment_bounds:
        mid_ok = [w["word"] for w in words
                  if seg["start_time"] <= (w["start"] + w["end"]) / 2 < seg["end_time"]]
        out.append(" ".join(mid_ok))
    return out
