#!/usr/bin/env python
"""VCR finetuning (QA and QA->R jointly) of the PyTorch port: the
counterpart of ``scripts/finetune_vcr.py``, with its flags and recipe
(batch 32, lang_seq_len 144, grid 18x32, 5 epochs over 212,736 examples,
lr 1e-5 with half an epoch of warmup, bias correction, eps 1e-6, weight
decay toward the pretrained weights). Batches come from
``finetune.data.finetune_batches`` over the TFRecords; after each epoch a
validation pass prints each task's accuracy (padded rows left out) and the
state is saved without its optimizer. Runs on the CUDA card unless
``--device cpu`` is given.

Usage: python scripts/finetune_vcr_torch.py base -ckpt CKPT -train_fns 'train*.tfrecord' \
           -val_fns 'val*.tfrecord' -output_dir OUT
"""

import argparse
import dataclasses
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_SIZE = 212_736


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="YAML config path or name (base/large)")
    ap.add_argument("-ckpt", required=True)
    ap.add_argument("-train_fns", required=True)
    ap.add_argument("-val_fns", default="")
    ap.add_argument("-output_dir", default="")
    ap.add_argument("-lr", type=float, default=1e-5)
    ap.add_argument("-ne", type=int, default=5, help="epochs")
    ap.add_argument("-batch_size", type=int, default=32)
    ap.add_argument("-train_size", type=int, default=TRAIN_SIZE,
                    help="examples per epoch (the schedule's unit)")
    ap.add_argument("-output_grid_h", type=int, default=18)
    ap.add_argument("-output_grid_w", type=int, default=32)
    ap.add_argument("-scan_minibatch", action="store_true")
    ap.add_argument("-log_every", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.finetune.data import finetune_batches
    from merlot_reserve_tpu_torch.finetune.models import (MerlotReserveVCR,
                                                          adapt_pretrained_params)
    from merlot_reserve_tpu_torch.finetune.train import (create_finetune_state,
                                                         run_finetuning, vcr_loss_fn,
                                                         vcr_pred_step)
    from merlot_reserve_tpu_torch.models.pretrainer import batch_to_tensors
    from merlot_reserve_tpu_torch.training.pretrain import config_mesh
    from merlot_reserve_tpu_torch.utils.checkpoint import pretrained_params
    from merlot_reserve_tpu_torch.utils.device import resolve_device
    from merlot_reserve_tpu_torch.utils.weights import load_flax_params

    device = resolve_device(args.device)
    steps_per_epoch = args.train_size // args.batch_size
    cfg = load_config(args.config, output_grid=(args.output_grid_h, args.output_grid_w))
    cfg = cfg.replace_data(lang_seq_len=144)
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, learning_rate=args.lr, num_train_steps=args.ne * steps_per_epoch,
        num_warmup_steps=steps_per_epoch // 2, do_bias_correction=True, eps=1e-6))

    model = MerlotReserveVCR(cfg, device=device)
    params = pretrained_params(args.ckpt, cfg.model.scan_layers)
    load_flax_params(model, adapt_pretrained_params(params, cfg.model.hidden_size,
                                                    drop_audio=True))
    state = create_finetune_state(cfg, model)

    def evaluate(state):
        """qa and qar accuracy over the validation files."""
        right, total = [0, 0], 0
        for ids, batch in finetune_batches(sorted(glob.glob(args.val_fns)), cfg, "vcr",
                                           args.batch_size, is_training=False, repeat=False,
                                           return_ids=True):
            preds = vcr_pred_step(state, batch_to_tensors(batch, device))["preds"]
            keep = [i for i, x in enumerate(ids) if x != "pad"]
            hits = preds.cpu().numpy()[keep] == batch["labels"][keep]
            right = [right[t] + int(hits[:, t].sum()) for t in (0, 1)]
            total += len(keep)
        return {"qa": right[0] / total, "qar": right[1] / total}

    batches = finetune_batches(sorted(glob.glob(args.train_fns)), cfg, "vcr", args.batch_size,
                               seed=123456)
    return run_finetuning(state, batches, vcr_loss_fn, steps_per_epoch, args.ne,
                          mesh=config_mesh(cfg, device), scan_minibatch=args.scan_minibatch,
                          evaluate=evaluate if args.val_fns else None,
                          output_dir=args.output_dir, log_every=args.log_every)


if __name__ == "__main__":
    main()
