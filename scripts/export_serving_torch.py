#!/usr/bin/env python
"""Build a serving artifact of the PyTorch port from a checkpoint: the
counterpart of ``scripts/export_serving.py``, with its flags but one
platform per artifact (``--device``; JAX's ``-platforms`` lowers one
artifact for several).

    python scripts/export_serving_torch.py base.yaml -ckpt /path/ckpt_750000 \\
        -out /path/artifact -batch_size 8 -num_segments 8

The artifact directory (``torch.export`` programs, f16 params, manifest)
then serves through ``merlot_reserve_tpu_torch.export.load_serving_artifact``
on a host with torch and no model code, on the device it was exported for.
Runs on the CUDA card unless ``--device cpu`` is given. See
``merlot_reserve_tpu_torch/export.py``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def example_video(num_segments: int, grid, lang_seq_len: int):
    """A shape-defining ``preprocess_video`` output (per segment either text
    or 18 AUDIOSPAN tokens; the exported programs need only the shapes)."""
    import numpy as np

    from merlot_reserve_tpu_torch.tokenizer import AUDIOSPAN

    tokens = np.zeros(lang_seq_len, np.int32)
    tokens[:18] = AUDIOSPAN
    subseg = np.zeros(lang_seq_len, np.int32)
    subseg[:18] = np.arange(18) // 6
    return {"images": np.zeros((num_segments, grid[0] * grid[1], 768), np.float32),
            "audio_clips": np.zeros((3 * num_segments, 60, 65), np.float32),
            "tokens": tokens, "subseg_idxs": subseg}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="YAML config path or name (base/large)")
    ap.add_argument("-ckpt", required=True)
    ap.add_argument("-out", required=True)
    ap.add_argument("-batch_size", type=int, default=8)
    ap.add_argument("-num_segments", type=int, default=8)
    ap.add_argument("-num_options", type=int, default=64)
    ap.add_argument("-output_grid_h", type=int, default=12)
    ap.add_argument("-output_grid_w", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.export import export_serving_artifact
    from merlot_reserve_tpu_torch.models import MerlotReserve
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params
    from merlot_reserve_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    grid = (args.output_grid_h, args.output_grid_w)
    cfg = load_config(args.config, output_grid=grid)
    model = MerlotReserve(cfg, device="meta")  # the shapes only: the params are inputs
    params = pretrained_params(args.ckpt, cfg.model.scan_layers)
    manifest = export_serving_artifact(
        model, params, example_video(args.num_segments, grid, cfg.data.lang_seq_len),
        args.out, batch_size=args.batch_size, num_options=args.num_options, device=device)
    print(f"wrote {args.out}: { {k: v for k, v in manifest.items() if k != 'param_order'} }")
    return manifest


if __name__ == "__main__":
    main()
