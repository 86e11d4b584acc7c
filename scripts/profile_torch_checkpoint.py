#!/usr/bin/env python3
"""What asynchronous checkpoints cost the pretraining loop of the
PyTorch/CUDA port, on one CUDA card.

Runs ``run_pretraining`` with the full-width base pretrainer on the dummy
batch of 8 (``joint_attention_impl="flash"``, random weights from a seed,
warmup 1, lr 1e-5, as ``chip_smoke.py`` phase 5) for ``--steps`` steps
twice: without checkpoints, and with an ``output_dir`` saving every
``--save-every`` steps (``AsyncCheckpointer``: a device snapshot, then a
copy to pinned host memory and the write on a thread). Prints each step's
time on the host clock (the step ends when its metrics reach ``log_fn``,
``log_every=0``), so the steps after each save show what the writer
thread takes from the loop. The checkpoints go to the gitignored
``_smoke_ckpt/`` in the checkout and are removed at the end.

Run from the root of a checkout: ``python3 scripts/profile_torch_checkpoint.py``.
Writes ``chiprun_out/profile_torch_checkpoint.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def step_times(cfg, batch, steps, output_dir, save_every):
    """Host ms of each step of one ``run_pretraining`` run (the first
    includes building the model)."""
    from merlot_reserve_tpu_torch.training.pretrain import run_pretraining

    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_pretraining(cfg, itertools.repeat(batch), num_steps=steps, output_dir=output_dir,
                    save_every=save_every, log_every=0,
                    log_fn=lambda step, metrics: stamps.append(time.perf_counter()),
                    device="cuda", seed=0)
    return [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--save-every", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_checkpoint: needs a CUDA card", file=sys.stderr)
        return 2
    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.data.dummy import make_dummy_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = load_config("base", joint_attention_impl="flash")
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, num_warmup_steps=1, learning_rate=1e-5))
    batch = make_dummy_batch(cfg, 8, seed=0)
    ckpt_dir = ROOT / "_smoke_ckpt"
    out = {"card": card, "steps": args.steps, "save_every": args.save_every}
    try:
        for label, output_dir in (("no_checkpoints", None),
                                  ("checkpoints", str(ckpt_dir / "profile"))):
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            ms = step_times(cfg, batch, args.steps, output_dir, args.save_every)
            out[label] = ms
            print(f"[checkpoint] {label}: step ms on the host clock "
                  f"{[round(t, 1) for t in ms]} ({card})", flush=True)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    saved_after = [s for s in range(args.save_every, args.steps, args.save_every)]
    out["steps_after_a_save"] = {s + 1: out["checkpoints"][s] for s in saved_after}
    print(f"[checkpoint] the step after each save (step: ms): {out['steps_after_a_save']}; "
          f"without checkpoints the median step is "
          f"{sorted(out['no_checkpoints'][1:])[(args.steps - 1) // 2]:.1f} ms", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_torch_checkpoint.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
