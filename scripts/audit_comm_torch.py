#!/usr/bin/env python
"""Audit the collectives of a training layout's step, without the cards.

The counterpart of ``scripts/audit_comm.py`` (which lowers the JAX step on
a virtual CPU mesh and reads the HLO): one stand-in rank of the layout
(``parallel.distributed.initialize_standin``, torch's fake process group)
takes one full training step, and ``parallel.comm`` records every
collective it issues. Prints one JSON object: per kind of collective its
count and bytes per step (with counts by dtype, axis and purpose, and
bytes by purpose), the totals, the split by 8-card node
(``intra_inter``), and the layout. Bytes are those of each op's result
buffer, as the JAX audit counts them.

On the CPU with ``--tiny`` (64 hidden, 2 layers a tower: the same
collectives' structure), on the card at full width without it.

Examples:
  python scripts/audit_comm_torch.py base --dp 4 --batch 4 --tiny
  python scripts/audit_comm_torch.py base --dp 2 --tp 2 --tiny
  python scripts/audit_comm_torch.py base --dp 2 --sp 2 --impl ring:flash --tiny
  # long video on the card: full-base bytes at joint seq 2560
  python scripts/audit_comm_torch.py base --dp 2 --sp 2 --impl ring:flash --segments 80
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--batch", type=int, default=None, help="global batch (default: dp)")
    ap.add_argument("--impl", default="ring:flash",
                    help="joint_attention_impl of an sp > 1 layout ('ring:flash', "
                         "'ulysses', 'ulysses:flash')")
    ap.add_argument("--segments", type=int, default=None,
                    help="long-video mode: scale the data to an N-segment video")
    ap.add_argument("--no-zero1", action="store_true",
                    help="every master and moment whole on every rank")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths on the CPU (the collectives' structure); without it "
                         "full width on the card")
    ap.add_argument("--rank", type=int, default=0, help="the rank that stands in")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch.parallel import comm, readiness
    from scripts.pod_readiness_torch import config

    cfg = config(args.config, args.tiny, unroll=False, remat=False)
    model = {}
    if args.sp > 1:
        model.update(seq_shard_axis="sp", joint_attention_impl=args.impl)
    if args.pp > 1:
        model.update(pipeline_axis="pp")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))
    if args.segments is not None:
        d, m = cfg.data, cfg.model
        per_seg = (m.output_grid[0] * m.output_grid[1]) // (m.vit_pooling_ratio ** 2)
        seq = d.lang_seq_len + (args.segments // d.num_segment_groups) * per_seg
        cfg = cfg.replace_data(num_segments=args.segments, seq_len=seq)
        print(f"# long-video: {args.segments} segments -> joint seq {seq}", file=sys.stderr)
    batch = args.batch or args.dp
    if batch % args.dp:
        raise SystemExit(f"--batch {batch} does not split over --dp {args.dp}")
    mesh = dict(dp=args.dp, tp=args.tp, sp=args.sp, pp=args.pp)
    layout = readiness.Layout("audit", mesh, batch)
    role = readiness.run_role(cfg, layout, args.rank, batch // args.dp, steps=1,
                              device="cpu" if args.tiny else "cuda", keep_records=True,
                              zero1=not args.no_zero1)
    records = role["records"][-1]
    summary = comm.summarize_records(records)
    summary["intra_inter"] = comm.split_intra_inter(records, readiness.NODE_CARDS)
    summary["layout"] = {**mesh, "batch": batch, "tiny": args.tiny,
                         "impl": args.impl if args.sp > 1 else None, "segments": args.segments,
                         "seq_len": cfg.data.seq_len, "zero1": not args.no_zero1,
                         "rank": args.rank, "world": layout.world, "standin": True}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
