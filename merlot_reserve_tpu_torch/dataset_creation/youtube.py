"""YouTube acquisition for dataset creation (reference
data/download_youtube.py: a yt-dlp wrapper with rate-limit handling,
language filtering and subtitle fetch), and the acceptance screening. The
port's copy of ``merlot_reserve_tpu/dataset_creation/youtube.py``. The
downloads run yt-dlp in a subprocess and raise when it is not on the PATH;
the parsing and screening are pure Python. VTT parsing is
``utils/subtitles.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from shutil import which
from typing import Dict, List, Optional

from merlot_reserve_tpu_torch.utils.subtitles import parse_vtt


def _ytdlp() -> str:
    for name in ("yt-dlp", "youtube-dl"):
        if which(name):
            return name
    raise RuntimeError("yt-dlp/youtube-dl not found on PATH — required for "
                       "YouTube acquisition (offline tooling).")


def download_video(video_id: str, out_dir: str, max_height: int = 360,
                   rate_limit: Optional[str] = "1M", retries: int = 3) -> str:
    """Download one video at <=max_height with auto-subtitles; returns the
    video path. Retries with backoff on rate limiting."""
    tool = _ytdlp()
    out_tmpl = os.path.join(out_dir, f"{video_id}.%(ext)s")
    cmd = [tool, f"https://www.youtube.com/watch?v={video_id}",
           "-f", f"bestvideo[height<={max_height}]+bestaudio/best[height<={max_height}]",
           "--write-auto-subs", "--sub-langs", "en", "--sub-format", "vtt",
           "-o", out_tmpl, "--no-playlist"]
    if rate_limit:
        cmd += ["--limit-rate", rate_limit]
    for attempt in range(retries):
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode == 0:
            for ext in ("mp4", "mkv", "webm"):
                p = os.path.join(out_dir, f"{video_id}.{ext}")
                if os.path.exists(p):
                    return p
            raise FileNotFoundError(f"download reported success but no file for {video_id}")
        if "429" in res.stderr or "rate" in res.stderr.lower():
            time.sleep(30 * (attempt + 1))
            continue
        raise RuntimeError(f"download failed for {video_id}: {res.stderr[-500:]}")
    raise RuntimeError(f"rate-limited out of retries for {video_id}")


def fetch_metadata(video_id: str) -> Dict:
    """Title/description/tags/duration via yt-dlp -J."""
    tool = _ytdlp()
    res = subprocess.run(
        [tool, f"https://www.youtube.com/watch?v={video_id}", "-J",
         "--no-playlist", "--skip-download"],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"metadata fetch failed: {res.stderr[-300:]}")
    meta = json.loads(res.stdout)
    return {
        "title": meta.get("title", ""),
        "description": meta.get("description", ""),
        "tags": " ".join(meta.get("tags", []) or []),
        "duration": float(meta.get("duration") or 0.0),
        "language": meta.get("language") or "",
        "categories": list(meta.get("categories") or []),
    }


def is_probably_english(meta: Dict) -> bool:
    """Cheap language gate (the reference used CLD3, which the port lacks): accept
    declared English or mostly-ASCII titles."""
    lang = (meta.get("language") or "").lower()
    if lang.startswith("en"):
        return True
    title = meta.get("title", "")
    if not title:
        return False
    ascii_frac = sum(c.isascii() for c in title) / len(title)
    return ascii_frac > 0.9


GAMING_KEYWORDS = ("gameplay", "playthrough", "walkthrough", "fortnite",
                   "minecraft", "speedrun", "let's play", "lets play")


def is_gaming_video(meta: Dict) -> bool:
    text = (meta.get("title", "") + " " + meta.get("tags", "")).lower()
    return any(k in text for k in GAMING_KEYWORDS)


def load_subtitle_words(out_dir: str, video_id: str) -> List[Dict]:
    """Parse the downloaded auto-sub VTT into timed words."""
    for suffix in (".en.vtt", ".en-US.vtt", ".vtt"):
        p = os.path.join(out_dir, f"{video_id}{suffix}")
        if os.path.exists(p):
            with open(p) as f:
                return parse_vtt(f.read())
    return []


# ---------------------------------------------------------------------------
# acquisition screening (download_youtube.py:286-430 semantics)
# ---------------------------------------------------------------------------

# English function words for the CLD3-free language proxy: real English ASR
# text is saturated with these; transliterated/other-language text is not.
_EN_STOPWORDS = frozenset(
    "the a an and or but if of to in on at for with is are was were be been "
    "i you he she it we they this that have has had do does did not no yes "
    "so what when where how why which who your my his her its our their".split())


def words_per_30s(word_times) -> List[int]:
    """Word-density histogram over 30-second bins (download_youtube.py:
    356-366): the reference rejects videos whose densest 30s window has
    fewer than 50 ASR words — sparse narration trains poorly."""
    times = [float(t) for t in word_times]
    if not times:
        return [0]
    n_bins = int(max(times) // 30) + 1
    counts = [0] * n_bins
    for t in times:
        counts[min(int(t // 30), n_bins - 1)] += 1
    return counts


def looks_english(title: str, description: str, transcript_words) -> bool:
    """CLD3-free English gate (download_youtube.py:372-393 used CLD3 with
    p >= 0.8 over title + filtered description + transcript). Proxy: the
    same text pool must be mostly ASCII and carry a healthy English
    function-word rate."""
    desc_tok = [w for w in (description or "").split()
                if "#" not in w and "http" not in w and "@" not in w
                and "www" not in w][:100]
    words = ((title or "").split() + desc_tok
             + [str(w) for w in transcript_words])
    if not words:
        return False
    text = " ".join(words)
    ascii_frac = sum(c.isascii() for c in text) / max(len(text), 1)
    stop_rate = sum(1 for w in words
                    if w.strip(".,!?\"'").lower() in _EN_STOPWORDS) / len(words)
    return ascii_frac > 0.9 and stop_rate > 0.12


def screen_video(meta: Dict, transcript: List[Dict], *,
                 max_duration_min: float = 20.0,
                 min_words_per_30s: int = 50,
                 skip_gaming: bool = True) -> Dict:
    """The reference's acceptance pipeline as one pure decision
    (download_youtube.py:286-430), minus the thumbnail stages — those live
    in dataset_creation/filters.py (cosine-sim static filter, expected-COCO
    objects) and compose downstream exactly as the reference does.

    :param meta: fetch_metadata output (may include 'categories')
    :param transcript: timed words (load_subtitle_words output:
        dicts with 'word' and 'start')
    :return: {'ok': bool, 'fail_reason': str|None, plus the reference's
        diagnostic fields ('_words_per_30s', ...)}
    """
    info: Dict = {"ok": False, "fail_reason": None}

    if not transcript:
        info["fail_reason"] = "no transcript"
        return info

    duration = float(meta.get("duration") or 0.0)
    if duration <= 0:
        # distinct reason: live streams / partial metadata report no duration
        info["fail_reason"] = "unknown duration"
        return info
    if duration > max_duration_min * 60:
        info["fail_reason"] = "video too long"
        return info

    cats = meta.get("categories") or []
    if skip_gaming and ("Gaming" in cats or is_gaming_video(meta)):
        info["fail_reason"] = "gaming"
        return info

    starts = [w.get("start", 0.0) for w in transcript]
    density = words_per_30s(starts)
    info["_words_per_30s"] = density
    if max(density) < min_words_per_30s:
        info["fail_reason"] = "word density too low"
        return info

    words = [w.get("word", "") for w in transcript]
    if not looks_english(meta.get("title", ""), meta.get("description", ""),
                         words):
        info["fail_reason"] = "maybe not english"
        return info

    info["ok"] = True
    return info
