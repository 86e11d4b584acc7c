#!/usr/bin/env python
"""Pod readiness on one card: run the full production pretraining step of a
multi-card layout as one stand-in rank, and report per layout its peak
memory beside the planner's, its collectives and its kernel launches.

The counterpart of ``scripts/pod_readiness.py``, which compiles a layout's
step for TPU chips it does not have. Here each rank that holds something
of its own (rank 0, and one rank per pipeline stage) joins the layout's
job alone on torch's fake process group (``parallel.distributed.
initialize_standin``), builds its train state through ``ShardPlan`` and
``ShardedOptimizer`` from a seeded full model, and takes ``--steps`` steps
on its rows of a dummy batch (``parallel/readiness.py``). H100 nodes of 8
cards take the place of v5e slices: dp8 is one node; dp16, dcn16 and
dcn16tp2 are two (``dcn_dp=2``); dp64 is eight.

Per layout it prints one JSON line: ``hbm_highwater_gib`` (the largest
role's ``torch.cuda.max_memory_allocated`` over the steps, its state
included), ``planner_total_gib`` (``parallel.memory.estimate_train_hbm``),
the comm audit of rank 0's last step (``collectives``,
``collective_total_mib_per_step``, ``collective_count``,
``intra_inter_split`` by 8-card node, ``top_collectives``) and each role's
kernel launches per step. NCCL's own buffers are not in the peaks: a fake
group allocates none (every row says so). Loss values are meaningless on a
stand-in and are not reported. ``--rows FILE`` appends each layout's row in
the keys of ``docs/pod_readiness_results.jsonl`` (``compile``: "clean" when
every role's steps ran, else the OOM), with the card's name and power limit,
to ``FILE`` (``docs/pod_readiness_results_torch.jsonl``).

Usage (on the card):
  python scripts/pod_readiness_torch.py [--config base|large]
      [--batch-per-chip 1] [--unroll] [--remat] [--layouts dp8,...]
      [--steps 2] [--rows docs/pod_readiness_results_torch.jsonl]
On the CPU at tiny widths (hidden 64, 2 layers a tower; no peaks):
  python scripts/pod_readiness_torch.py --tiny --layouts dp8,dp2pp2tp2
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_LAYOUTS = "dp8,dp4xsp2,dp2pp2tp2,dcn16"
TINY_MODEL = dict(hidden_size=64, joint_num_layers=2, vit_num_layers=2, audio_num_layers=2,
                  span_num_layers=2, size_per_head=32, output_grid=(4, 4), use_bfloat16=False)
TINY_DATA = dict(num_segments=4, num_segment_groups=2, seq_len=80, lang_seq_len=40,
                 num_text_spans_to_include=8)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of card 0 ("not measured"
    where there is no ``nvidia-smi``)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def config(name: str, tiny: bool, unroll: bool, remat: bool):
    from merlot_reserve_tpu_torch import load_config

    over = dict(scan_layers=not unroll, gradient_checkpoint=remat,
                tower_gradient_checkpoint=remat)
    if tiny:
        return load_config(name, **TINY_MODEL, **over).replace_data(**TINY_DATA)
    return load_config(name, **over)


def jsonl_row(row, config_name: str, card: str, flags: str) -> dict:
    """A row in the keys of the JAX package's pod readiness rows, with the
    card's name and power limit."""
    name, _, power = card.partition(", ")
    remat = " remat" if row["remat"] else ""
    out = {"name": f"{config_name} {row['layout']}{remat}", "config": config_name,
           "batch": row["batch"], "remat": row["remat"], "zero1_dp": row["zero1_dp"],
           "sp": row["sp"], "tp": row["tp"], "pp": row["pp"], "dcn": row["dcn"],
           "measured_gib": round(row["hbm_highwater_gib"], 3) if "hbm_highwater_gib" in row
           else None,
           "compile": row["run"],
           "source": f"stand-in rank, scripts/pod_readiness_torch.py {flags}",
           "tower_remat": row["tower_remat"], "sp_impl": row["sp_impl"],
           "segment_sp": row["segment_sp"], "segments": row["segments"],
           "layout": row["key"], "highwater_rank": row.get("highwater_rank"),
           "planner_total_gib": round(row["planner_total_gib"], 3),
           "card": name, "power_limit": power, "standin": True,
           "nccl_buffers": row["nccl_buffers"]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="base", choices=["base", "large"])
    ap.add_argument("--batch-per-chip", type=int, default=1)
    ap.add_argument("--unroll", action="store_true",
                    help="unrolled layers (scan_layers off: per-layer leaves for ZeRO-1)")
    ap.add_argument("--remat", action="store_true",
                    help="gradient checkpointing on every tower (both remat knobs)")
    ap.add_argument("--layouts", default=DEFAULT_LAYOUTS,
                    help="comma list of dp8,dp4xsp2,dp4xsp2ulysses,dp4xtp2,dp2pp2tp2,dp16,"
                         "dcn16,dcn16tp2,dp64,longvideo")
    ap.add_argument("--steps", type=int, default=2, help="steps per role; the peak spans them")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths on the CPU: the same collectives' structure, no peaks")
    ap.add_argument("--rows", default=None,
                    help="append each layout's row (the JAX rows' keys) to this JSONL file")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch.parallel import readiness

    device = "cpu" if args.tiny else "cuda"
    flags = (f"--config {args.config} --batch-per-chip {args.batch_per_chip} --steps {args.steps}"
             + " --unroll" * args.unroll + " --remat" * args.remat)
    card = card_line() if device == "cuda" else "cpu"
    for key in args.layouts.split(","):
        if key not in readiness.LAYOUTS:
            raise SystemExit(f"unknown layout {key!r}; want one of {sorted(readiness.LAYOUTS)}")
        cfg = config(args.config, args.tiny, args.unroll, args.remat)
        t0 = time.perf_counter()
        row = readiness.run_layout(cfg, key, args.batch_per_chip, args.steps, device)
        row.update(config=args.config, card=card, seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        if args.rows and device == "cuda":
            with open(args.rows, "a") as f:
                f.write(json.dumps(jsonl_row(row, args.config, card, flags)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
