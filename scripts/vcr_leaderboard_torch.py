#!/usr/bin/env python
"""VCR leaderboard submission of the PyTorch port: the counterpart of
``scripts/vcr_leaderboard.py``, with its flags. At test time the rationale
query is conditioned on each candidate answer (records carry ids like
"<annot_id>-<n>_<conditionee>", annot_id being "split-number"); the
probabilities of every conditioning merge into one CSV row per annot_id,
the batches' padding rows left out. Runs on the CUDA card unless
``--device cpu`` is given.

Usage: python scripts/vcr_leaderboard_torch.py base -ckpt CKPT -test_fns 'test*' -out sub.csv
"""

import argparse
import csv
import glob
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def merge_predictions(out, ids, probs) -> None:
    """Fold one batch into ``out`` ({annot_id: {column: probability}}):
    ``probs`` [B, 2, 4] (QA, then QA->R under the record's conditionee);
    rows whose id is 'pad' are left out."""
    for id_i, p_i in zip(ids, probs):
        if id_i == "pad":
            continue
        annot_id = "-".join(id_i.split("-")[:2])
        conditionee = id_i.split("_")[-1]
        row = {f"answer_{i}": float(p_i[0, i]) for i in range(4)}
        for i in range(4):
            row[f"rationale_conditioned_on_{conditionee}_{i}"] = float(p_i[1, i])
        out[annot_id].update(row)


def write_submission(out, path: str) -> int:
    """The CSV: annot_id, then the sorted columns; rows by annot_id's
    number. Returns the number of rows."""
    annot_ids = sorted(out.keys(), key=lambda a: int(a.split("-")[1]))
    cols = sorted({c for row in out.values() for c in row})
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["annot_id"] + cols)
        for a in annot_ids:
            missing = [c for c in cols if c not in out[a]]
            if missing:
                raise ValueError(f"missing columns for {a}: {missing}")
            w.writerow([a] + [out[a][c] for c in cols])
    return len(annot_ids)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="YAML config path or name (base/large)")
    ap.add_argument("-ckpt", required=True)
    ap.add_argument("-test_fns", required=True)
    ap.add_argument("-out", default="vcr_submission.csv")
    ap.add_argument("-batch_size", type=int, default=32)
    ap.add_argument("-output_grid_h", type=int, default=18)
    ap.add_argument("-output_grid_w", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.finetune.data import finetune_batches
    from merlot_reserve_tpu_torch.finetune.models import MerlotReserveVCR
    from merlot_reserve_tpu_torch.finetune.train import vcr_pred_step
    from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors
    from merlot_reserve_tpu_torch.training.trainer import TrainState
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params
    from merlot_reserve_tpu_torch.utils.device import resolve_device
    from merlot_reserve_tpu_torch.utils.weights import load_flax_params

    device = resolve_device(args.device)
    cfg = load_config(args.config, output_grid=(args.output_grid_h, args.output_grid_w))
    cfg = cfg.replace_data(lang_seq_len=144)
    model = MerlotReserveVCR(cfg, device=device)
    load_flax_params(model, pretrained_params(args.ckpt, cfg.model.scan_layers))
    state = TrainState(model=model.eval(), optimizer=None)

    out = defaultdict(dict)
    for ids, batch in finetune_batches(sorted(glob.glob(args.test_fns)), cfg, "vcr",
                                       args.batch_size, is_training=False, repeat=False,
                                       return_ids=True):
        logprobs = vcr_pred_step(state, batch_to_tensors(batch, device))["logprobs"]
        merge_predictions(out, ids, np.exp(logprobs.float().cpu().numpy()))
    n = write_submission(out, args.out)
    print(f"wrote {n} rows to {args.out}")
    return out


if __name__ == "__main__":
    main()
