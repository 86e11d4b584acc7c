"""Port parity: ``finetune/prep_data.py`` and the two prep scripts
(``scripts/prep_vcr_torch.py``, ``scripts/prep_tvqa_torch.py``) against the
JAX package's module and its scripts ``scripts/prep_vcr.py`` and
``scripts/prep_tvqa.py``, run under PIL with
``merlot_reserve_tpu.preprocess``'s three ffmpeg helpers replaced by the
test's arrays.

Tolerances: prep_data's outputs exactly (colors, drawn pixels, rewritten
text, segment times, localization tokens); in the records every integer and
id exactly; the TVQA magic number within 1e-5 relative (the JAX package's
spectrogram against the port's on the CPU: f32 products summed in another
order); decoded JPEG pixels (the data library's encoder against PIL's, and
the spectrogram planes quantized from those two spectrograms, on the 64
mel columns the JAX script stores) within a mean absolute difference of 2
levels, ``tests/test_native.py``'s native-vs-PIL limit.
"""

import json
import sys

import numpy as np
import pytest

import merlot_reserve_tpu.preprocess as jax_preprocess
from merlot_reserve_tpu.data import tfrecord as jtf
from merlot_reserve_tpu.finetune import prep_data as JPD
from merlot_reserve_tpu_torch import load_config
from merlot_reserve_tpu_torch import preprocess as port_preprocess
from merlot_reserve_tpu_torch.data.native import decode_jpeg_native, encode_jpeg_native
from merlot_reserve_tpu_torch.finetune import prep_data
from merlot_reserve_tpu_torch.finetune.data import finetune_batches
from scripts import prep_tvqa as jax_prep_tvqa
from scripts import prep_vcr as jax_prep_vcr
from scripts.prep_tvqa_torch import main as tvqa_main
from scripts.prep_tvqa_torch import segment_times, tvqa_record
from scripts.prep_vcr_torch import main as vcr_main
from scripts.prep_vcr_torch import vcr_record

JPEG_MEAN_TOL = 2.0
MAGIC_RTOL = 1e-5
TINY = dict(hidden_size=64, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
            span_num_layers=2, size_per_head=32, output_grid=(4, 4), use_bfloat16=False)


def _smooth_image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 180 // h + 30, xx * 180 // w + 20, (yy + xx) * 90 // (h + w) + 70], -1)
    return np.clip(base + rng.integers(-6, 7, base.shape), 0, 255).astype(np.uint8)


def test_prep_data_matches_jax():
    for name in ("person", "dog", "Person", "a b", "", "käse"):
        assert prep_data.color_for_name(name) == JPD.color_for_name(name)
    img = _smooth_image(60, 90, 0)
    boxes = [(5, 4, 50, 40), (-3, 10, 200, 59.7), (30, 30, 31, 31)]
    names = ["person", "dog", "cup"]
    np.testing.assert_array_equal(prep_data.draw_boxes_on_image(img, boxes, names),
                                  JPD.draw_boxes_on_image(img, boxes, names))
    objects = ["person", "person", "dog", "chair"]
    for tokens in (["Why", "is", [0], "looking", "at", [1, 2], "?"],
                   [[0, 1, 3], "are", "n't", "here", ",", "(", "yes", ")", "."],
                   [[7], "'s", "hat", "costs", "$", "5", "%"]):
        assert prep_data.rewrite_detection_tags(tokens, objects) == \
            JPD.rewrite_detection_tags(tokens, objects)
    for case in ((20.0, 25.0, 120.0), (0.0, 3.0, 20.0), (110.0, 119.0, 120.0), (5.0, 6.0, 10.0)):
        got, want = prep_data.tvqa_segment_times(*case), JPD.tvqa_segment_times(*case)
        assert got == want
        assert prep_data.relative_localization_tokens(case[0], case[1], got) == \
            JPD.relative_localization_tokens(case[0], case[1], want)


def _records(path):
    return [jtf.parse_example(r) for r in jtf.read_records(path, check_crc=True)]


def _assert_same_record(got, want, images):
    """Every feature equal but the JPEGs in ``images`` ({key: channels}),
    which decode within the codec limit."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k in images:
            a, b = decode_jpeg_native(got[k][0], images[k]), decode_jpeg_native(v[0], images[k])
            assert a.shape == b.shape and np.abs(a.astype(int) - b).mean() < JPEG_MEAN_TOL, k
        elif isinstance(v, list):
            assert got[k] == v, k
        elif k != "magic_number":
            np.testing.assert_array_equal(got[k], v, err_msg=k)


VCR_ANNS = [
    {"id": "vcr-0", "boxes": [[10, 8, 60, 50], [70, 20, 110, 70]], "names": ["person", "dog"],
     "qa_query": ["Why", "is", [0], "looking", "at", [1], "?"],
     "qa_choices": [["Because", [1], "is", "cute", "."], ["No", "reason", "."],
                    [[0, 1], "are", "friends", "."], ["It", "'s", "hungry", "."]],
     "qa_label": 2, "qar_query": ["Why", "?"],
     "qar_choices": [["a"], ["b", [0]], ["c", "!"], ["d", "'s"]], "qar_label": 1},
    {"id": "vcr-1", "boxes": [], "names": [], "qa_query": ["What", "now", "?"],
     "qa_choices": [["x"], ["y"], ["z"], ["w"]], "qa_label": 0, "qar_query": ["So", "?"],
     "qar_choices": [["1"], ["2"], ["3"], ["4"]], "qar_label": 3},
]


def test_prep_vcr_matches_jax_script(tmp_path, monkeypatch):
    """The JAX script and the port's main on one manifest of a JPEG (PIL
    and the data library decode it, each package encodes), vcr_record on
    the data library's decode of it gives main's bytes; the port's records
    read by finetune_batches."""
    jpg = tmp_path / "img.jpg"
    jpg.write_bytes(encode_jpeg_native(_smooth_image(90, 120, 1), 95))
    manifest = tmp_path / "vcr.jsonl"
    manifest.write_text("".join(json.dumps(dict(a, image_path=str(jpg))) + "\n"
                                for a in VCR_ANNS))
    out_j = str(tmp_path / "vcr_jax.tfrecord")
    monkeypatch.setattr(sys, "argv", ["prep_vcr.py", "-manifest", str(manifest), "-out", out_j])
    jax_prep_vcr.main()
    out_t = str(tmp_path / "vcr_port.tfrecord")
    vcr_main(["-manifest", str(manifest), "-out", out_t])
    image = decode_jpeg_native(jpg.read_bytes())
    records = list(jtf.read_records(out_t))
    for ann, want, record in zip(VCR_ANNS, _records(out_j), records):
        assert vcr_record(ann, image) == record
        _assert_same_record(jtf.parse_example(record), want, {"image": 3, "image_fliplr": 3})
    assert len(records) == len(VCR_ANNS)
    cfg = load_config("base", **TINY).replace_data(lang_seq_len=48)
    batch = next(finetune_batches([out_t], cfg, "vcr", batch_size=2, repeat=False))
    assert batch["image"].shape[0] == 2 and np.isfinite(batch["image"]).all()


TVQA_ANNS = [
    {"id": "tvqa-0", "ts_start": 20.0, "ts_end": 26.5, "question": "What does she hold?",
     "answers": ["a cup", "a dog", "nothing", "a phone", "keys"], "label": 3,
     "subtitles": [{"word": w, "start": 9.0 + 1.3 * i, "end": 9.5 + 1.3 * i}
                   for i, w in enumerate("so this is the thing we will see now".split() * 3)]},
    {"id": "tvqa-1", "ts_start": 1.0, "ts_end": 2.0, "question": "Who?",
     "answers": ["me", "you", "them", "us", "it"], "label": 0},
]


def test_prep_tvqa_matches_jax_script(tmp_path, monkeypatch):
    """The JAX script, its ffmpeg helpers returning the test's arrays,
    against tvqa_record on the same arrays (spectrograms on the CPU), and
    the port's main with the port's helpers replaced alike, which writes
    tvqa_record's bytes; the port's records read by finetune_batches."""
    rng = np.random.default_rng(2)
    duration = 40.0
    frames = np.stack([_smooth_image(72, 128, 10 + i) for i in range(7)])
    waveform = (0.1 * rng.standard_normal(int(22050 * duration))).astype(np.float32)
    asked = []

    def extract_frames(path, times):
        asked.append(list(times))
        return frames

    for mod in (jax_preprocess, port_preprocess):
        monkeypatch.setattr(mod, "video_duration", lambda path: duration)
        monkeypatch.setattr(mod, "extract_frames_from_video", extract_frames)
        monkeypatch.setattr(mod, "extract_audio_waveform", lambda path, sr=22050: waveform)
    manifest = tmp_path / "tvqa.jsonl"
    manifest.write_text("".join(json.dumps(dict(a, video_path="v.mp4")) + "\n"
                                for a in TVQA_ANNS))
    out_j = str(tmp_path / "tvqa_jax.tfrecord")
    monkeypatch.setattr(sys, "argv", ["prep_tvqa.py", "-manifest", str(manifest), "-out", out_j])
    jax_prep_tvqa.main()
    out_t = str(tmp_path / "tvqa_port.tfrecord")
    tvqa_main(["-manifest", str(manifest), "-out", out_t, "--device", "cpu"])
    assert asked[0] == asked[len(TVQA_ANNS)] == [t["mid_time"] for t in
                                                  segment_times(TVQA_ANNS[0], duration)]
    images = {f"c{i:02d}/image_encoded": 3 for i in range(7)}
    port_records = list(jtf.read_records(out_t))
    assert len(port_records) == len(TVQA_ANNS)
    for ann, want, from_main in zip(TVQA_ANNS, _records(out_j), port_records):
        record = tvqa_record(ann, frames, waveform, duration, device="cpu")
        assert record == from_main
        got = jtf.parse_example(record)
        specs = {k: got.pop(k) for k in list(got) if k.endswith("spec_encoded")}
        _assert_same_record(got, {k: v for k, v in want.items() if k not in specs}, images)
        np.testing.assert_allclose(got["magic_number"], want["magic_number"], rtol=MAGIC_RTOL)
        for k, v in specs.items():
            # the port stores the 65th column (the playback speed) that
            # finetune/data.py reads; the JAX script stores 64
            a, b = decode_jpeg_native(v[0], 1), decode_jpeg_native(want[k][0], 1)
            assert a.shape == (180, 65) and b.shape == (180, 64)
            assert np.abs(a[:, :64].astype(int) - b).mean() < JPEG_MEAN_TOL, k
    cfg = load_config("base", **TINY).replace_data(lang_seq_len=48, num_segments=7)
    batch = next(finetune_batches([out_t], cfg, "tvqa", batch_size=2, repeat=False))
    assert batch["audio_clips"].shape[:3] == (2, 7, 3) and np.isfinite(batch["audio_clips"]).all()
