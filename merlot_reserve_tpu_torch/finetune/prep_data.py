"""Finetuning data preparation (the port's copy of
``merlot_reserve_tpu/finetune/prep_data.py``).

VCR (reference finetune/vcr/prep_data.py:53-225): the referenced boxes are
*rendered* into the pixels, each person or object box drawn
semi-transparently in a color fixed by its name, and detection-tag tokens
([1, 3]) are rewritten into plain text ("Person 2 and Person 4"). The
scripts pre-render the image and its left-right flip.

TVQA (finetune/tvqa/prep_data.py:134-338): 7 segments of about 4.667 s
around the localized QA span; subtitles bucketed by midpoint;
relative-localization tokens prepended to the query.
"""

from __future__ import annotations

import colorsys
import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from merlot_reserve_tpu_torch.tokenizer import START, get_tokenizer


def color_for_name(name: str) -> Tuple[int, int, int]:
    """Deterministic saturated color from a name hash (prep_data.py:53-60)."""
    h = int(hashlib.sha256(name.encode("utf-8")).hexdigest(), 16)
    hue = (h % 1024) / 1024.0
    r, g, b = colorsys.hsv_to_rgb(hue, 0.85, 0.95)
    return int(r * 255), int(g * 255), int(b * 255)


def draw_boxes_on_image(img: np.ndarray, boxes: Sequence[Sequence[float]],
                        names: Sequence[str], alpha: float = 0.4,
                        thickness_frac: float = 0.01) -> np.ndarray:
    """Render name-colored semi-transparent box borders into the image.

    :param img: [H, W, 3] uint8
    :param boxes: [(x1, y1, x2, y2)] pixel coords
    :param names: box owner names (color key)
    """
    out = img.astype(np.float32).copy()
    h, w = img.shape[:2]
    t = max(int(min(h, w) * thickness_frac), 2)
    for box, name in zip(boxes, names):
        x1, y1, x2, y2 = (int(v) for v in box)
        x1, x2 = np.clip([x1, x2], 0, w - 1)
        y1, y2 = np.clip([y1, y2], 0, h - 1)
        color = np.asarray(color_for_name(name), np.float32)

        def blend(region):
            return (1 - alpha) * region + alpha * color

        out[y1:y1 + t, x1:x2] = blend(out[y1:y1 + t, x1:x2])
        out[max(y2 - t, 0):y2, x1:x2] = blend(out[max(y2 - t, 0):y2, x1:x2])
        out[y1:y2, x1:x1 + t] = blend(out[y1:y2, x1:x1 + t])
        out[y1:y2, max(x2 - t, 0):x2] = blend(out[y1:y2, max(x2 - t, 0):x2])
    return np.clip(out, 0, 255).astype(np.uint8)


_GENDER_NEUTRAL = "Person"


def rewrite_detection_tags(tokens: List, object_names: Sequence[str]) -> str:
    """VCR token streams mix words and detection-index lists; rewrite
    ``[1, 3]`` into "Person 1 and Person 3" (prep_data.py:103-160 behavior,
    with simple list joining)."""
    words: List[str] = []
    for tok in tokens:
        if isinstance(tok, (list, tuple)):
            refs = []
            for idx in tok:
                name = object_names[idx] if idx < len(object_names) else "object"
                label = _GENDER_NEUTRAL if name == "person" else name
                refs.append(f"{label} {idx + 1}")
            if len(refs) == 1:
                words.append(refs[0])
            else:
                words.append(" and ".join([", ".join(refs[:-1]), refs[-1]])
                             if len(refs) > 2 else " and ".join(refs))
        else:
            words.append(str(tok))
    return detokenize(words)


def detokenize(words: Sequence[str]) -> str:
    """Moses-style detokenization (attach punctuation, contractions)."""
    out = ""
    for w in words:
        if not out:
            out = w
        elif w in {".", ",", "!", "?", ";", ":", "%", ")", "]", "'s", "'re",
                   "'ve", "'ll", "'d", "n't", "'m"}:
            out += w
        elif out.endswith(("(", "[", "$")):
            out += w
        else:
            out += " " + w
    return out


def tvqa_segment_times(ts_start: float, ts_end: float, duration: float,
                       num_segments: int = 7,
                       segment_length: float = 4.6667) -> List[Dict]:
    """Center ``num_segments`` windows on the localized QA span
    (tvqa prep_data.py:134-200 behavior)."""
    mid = (ts_start + ts_end) / 2.0
    total = num_segments * segment_length
    start = np.clip(mid - total / 2.0, 0.0, max(duration - total, 0.0))
    return [{"start_time": start + i * segment_length,
             "end_time": start + (i + 1) * segment_length,
             "mid_time": start + (i + 0.5) * segment_length}
            for i in range(num_segments)]


def relative_localization_tokens(ts_start: float, ts_end: float,
                                 seg_times: List[Dict], encoder=None) -> List[int]:
    """Prepend "X to Y" relative-position tokens (tvqa prep_data.py:300-338)."""
    enc = encoder or get_tokenizer()
    t0 = seg_times[0]["start_time"]
    t1 = seg_times[-1]["end_time"]
    span = max(t1 - t0, 1e-5)
    rel_s = int(np.clip(round((ts_start - t0) / span * 100), 0, 100))
    rel_e = int(np.clip(round((ts_end - t0) / span * 100), 0, 100))
    return enc.encode(f"{rel_s} to {rel_e}").ids + [START]
