#!/usr/bin/env python
"""Zero-shot video mask-infilling demo of the PyTorch port: the counterpart
of ``demo/demo_video.py``. Eight segments (one text prompt ending in
<|MASK|>, the rest audio): embed the video, rank a label space against the
MASK hidden states.

No download path: the weights come from a local checkpoint (``-ckpt``: a
``ckpt_<step>`` file or a directory of them, written by either package or
the reference's release), not ``from_pretrained``. Runs on the CUDA card
unless ``--device cpu`` is given.

Usage: python demo/demo_video_torch.py VIDEO.mp4 -ckpt CKPT [--model large] [--grid 18,32] \\
           --prompt "in this video i'll be<|MASK|>" --options "making coffee,going backpacking"
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def mask_infill(model, segments, prompt, options, grid, device="cuda", verbose=False):
    """The prompt on the first segment, audio on the rest -> [num_masks,
    num_options] probabilities (``zero_shot.rank_options``)."""
    from merlot_reserve_tpu_torch.preprocess import preprocess_video
    from merlot_reserve_tpu_torch.zero_shot import rank_options

    segments = [dict(s, use_text_as_input=False) for s in segments]
    segments[0].update(text=prompt, use_text_as_input=True)
    video_pre = preprocess_video(segments, output_grid_size=grid, verbose=verbose,
                                 device=device)
    return rank_options(model, video_pre, options)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("video")
    ap.add_argument("-ckpt", required=True, help="local checkpoint (file or directory)")
    ap.add_argument("--model", default="large",
                    help="the checkpoint's config: 'base', 'large' or a YAML path")
    ap.add_argument("--grid", default="18,32")
    ap.add_argument("--prompt", default="in this video i'll be<|MASK|>")
    ap.add_argument("--options", required=True, help="comma-separated label space")
    ap.add_argument("--start_segment", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch.models import PretrainedMerlotReserve
    from merlot_reserve_tpu_torch.preprocess import video_to_segments
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params
    from merlot_reserve_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    grid = tuple(int(x) for x in args.grid.split(","))
    model = PretrainedMerlotReserve.from_params(args.model, pretrained_params(args.ckpt),
                                                image_grid_size=grid, device=device)
    segments = video_to_segments(args.video, device=device)
    segments = segments[args.start_segment:args.start_segment + 8]
    options = [o.strip() for o in args.options.split(",")]
    probs = mask_infill(model, segments, args.prompt, options, grid, device, verbose=True)
    for i, probs_i in enumerate(probs):
        print(f"MASK {i}:")
        for idx in (-probs_i).argsort()[:10]:
            print(f"  {float(probs_i[idx]) * 100:5.1f}%  {options[int(idx)]}")
    return probs


if __name__ == "__main__":
    main()
