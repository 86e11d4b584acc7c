#!/usr/bin/env python
"""TVQA finetuning with audio and subtitles, of the PyTorch port: the
counterpart of ``scripts/finetune_tvqa.py``, with its flags and recipe
(batch 32, lang_seq_len 256, 7 segments, 3 epochs over 122,112 examples,
lr 5e-6 with half an epoch of warmup, bias correction, eps 1e-6;
``-scan_minibatch`` recommended for large). Batches come from
``finetune.data.finetune_batches`` over the TFRecords; after each epoch a
validation pass prints the audio, text and joint accuracy (padded rows
left out) and the state is saved without its optimizer; ``-test_fns``
writes leaderboard predictions, one JSON per stream. Runs on the CUDA card
unless ``--device cpu`` is given.

Usage: python scripts/finetune_tvqa_torch.py large -ckpt CKPT -train_fns 'train*' \
           -val_fns 'val*' -output_dir OUT
"""

import argparse
import dataclasses
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_SIZE = 122_112
STREAMS = ("audio", "text", "joint")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="YAML config path or name (base/large)")
    ap.add_argument("-ckpt", required=True)
    ap.add_argument("-train_fns", required=True)
    ap.add_argument("-val_fns", default="")
    ap.add_argument("-test_fns", default="")
    ap.add_argument("-output_dir", default="")
    ap.add_argument("-lr", type=float, default=5e-6)
    ap.add_argument("-ne", type=int, default=3)
    ap.add_argument("-batch_size", type=int, default=32)
    ap.add_argument("-train_size", type=int, default=TRAIN_SIZE,
                    help="examples per epoch (the schedule's unit)")
    ap.add_argument("-scan_minibatch", action="store_true")
    ap.add_argument("-log_every", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.finetune.data import finetune_batches
    from merlot_reserve_tpu_torch.finetune.models import (MerlotReserveTVQA,
                                                          adapt_pretrained_params)
    from merlot_reserve_tpu_torch.finetune.train import (create_finetune_state,
                                                         run_finetuning, tvqa_loss_fn,
                                                         tvqa_pred_step)
    from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors
    from merlot_reserve_tpu_torch.parallel.mesh import activate_mesh
    from merlot_reserve_tpu_torch.training.pretrain import config_mesh
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params
    from merlot_reserve_tpu_torch.utils.device import resolve_device
    from merlot_reserve_tpu_torch.utils.weights import load_flax_params

    device = resolve_device(args.device)
    steps_per_epoch = args.train_size // args.batch_size
    cfg = load_config(args.config).replace_data(lang_seq_len=256, num_segments=7)
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, learning_rate=args.lr, num_train_steps=args.ne * steps_per_epoch,
        num_warmup_steps=steps_per_epoch // 2, do_bias_correction=True, eps=1e-6))

    model = MerlotReserveTVQA(cfg, device=device)
    params = pretrained_params(args.ckpt, cfg.model.scan_layers)
    load_flax_params(model, adapt_pretrained_params(params, cfg.model.hidden_size))
    state = create_finetune_state(cfg, model)
    mesh = config_mesh(cfg, device)

    def predictions(state, fns):
        """(id, {stream: prediction}) of every example in ``fns`` but the pads."""
        for ids, batch in finetune_batches(sorted(glob.glob(fns)), cfg, "tvqa",
                                           args.batch_size, is_training=False, repeat=False,
                                           return_ids=True):
            preds = tvqa_pred_step(state, batch_to_tensors(batch, device))
            preds = {s: preds[f"preds_{s}"].cpu().numpy() for s in STREAMS}
            for i, ex_id in enumerate(ids):
                if ex_id != "pad":
                    yield ex_id, {s: int(preds[s][i]) for s in STREAMS}, int(batch["labels"][i])

    def evaluate(state):
        hits = [[p[s] == label for s in STREAMS] for _, p, label in predictions(
            state, args.val_fns)]
        return {s: sum(h[j] for h in hits) / len(hits) for j, s in enumerate(STREAMS)}

    batches = finetune_batches(sorted(glob.glob(args.train_fns)), cfg, "tvqa",
                               args.batch_size, seed=123456)
    record = run_finetuning(state, batches, tvqa_loss_fn, steps_per_epoch, args.ne, mesh=mesh,
                            scan_minibatch=args.scan_minibatch,
                            evaluate=evaluate if args.val_fns else None,
                            output_dir=args.output_dir, log_every=args.log_every)

    if args.test_fns:
        # leaderboard submission: one {id: prediction} JSON per stream
        out = {s: {} for s in STREAMS}
        with activate_mesh(mesh):
            for ex_id, preds, _ in predictions(state, args.test_fns):
                for s in STREAMS:
                    out[s][ex_id.split("~")[0]] = preds[s]
        for stream, pred_dict in out.items():
            out_fn = os.path.join(args.output_dir or ".", f"prediction_test_public_{stream}.json")
            with open(out_fn, "w") as f:
                json.dump(pred_dict, f)
            print(f"wrote {len(pred_dict)} predictions to {out_fn}")
    return record


if __name__ == "__main__":
    main()
