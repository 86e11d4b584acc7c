"""Read the numbers that decide ``correct`` over many seeds in one process,
for setting a cell's limits (not part of a benchmark run).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 --mode program --seconds 3

``program``: a run of the cell per seed (a short window), its readings;
``control``: the reference computed with float8 products against the
reference in float32 on the same inputs, no program; ``half_batch``,
``unchanged``, ``altered``: a run with that fault planted in the program
(``harness/faults.py``); ``look`` (training cells): the checked steps
alone, and for the program, the reference in bf16 and the control, each
against the reference in float32, the leaves with the widest gaps of the
first gradient and of the change; ``f32look``: the same for the program
run in float32 (parameters, compute and Adam's moments, which correct
their bias there; the reference follows), the witness that
its arithmetic is the reference's where bf16 is not in the way. One JSON
line per seed, standard output.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def look(cell, seed: int, device="cuda", witnesses=("bf16", "fp8"), top: int = 4):
    """The widest leaf gaps of each side against the float32 reference."""
    import torch

    from harness import checks

    drv = cell.driver(seed, device)
    drv.setup()
    drv.release()
    f32 = drv.reference("f32")
    sides = {"program": drv.readings}
    sides.update({kind: drv.reference(kind) for kind in witnesses})
    keep = checks.kept_leaves(f32["grad_norms"])
    names = [n for n, k in zip(drv.names, keep.tolist()) if k]
    out = {"dropped": [n for n, k in zip(drv.names, keep.tolist()) if not k]}
    for side, got in sides.items():
        out[side] = checks.training_numbers(got, f32)
        for key in ("grad", "change"):
            gaps = checks.leaf_gaps(got[key + "_norms"], f32[key + "_norms"], keep)
            order = torch.argsort(-gaps)[:top].tolist()
            out[side][key + "_widest"] = [
                [names[j], float(gaps[j]),
                 float(got[key + "_norms"][keep][j]), float(f32[key + "_norms"][keep][j])]
                for j in order]
    del drv
    return out


def f32_look(cell, seed: int, device="cuda"):
    """``look`` at the program run in float32 as a whole."""
    from merlot_reserve_tpu_torch.training import trainer

    cell = copy.copy(cell)
    cell.config = copy.deepcopy(cell.config)
    cell.config.model.use_bfloat16 = False
    cell.config.optimizer.use_bfloat16_adam = False
    cell.config.optimizer.do_bias_correction = True  # f32 Adam always corrects it
    orig = trainer.train_step
    trainer.train_step = lambda state, batch, *a, **k: orig(state, batch, False)
    try:
        return look(cell, seed, device, witnesses=())
    finally:
        trainer.train_step = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program",
                    choices=("program", "control", "look", "f32look", "half_batch", "unchanged",
                             "altered"))
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
    sys.path[:0] = [str(BENCH), str(ROOT)]

    import torch

    from harness import faults
    from harness.cell import load_cell
    from harness.runner import run

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.mode == "control":
            drv = cell.driver(seed, "cuda")
            drv.make_inputs()
            out = {"readings": drv.control_numbers()}
            del drv
        elif args.mode in ("look", "f32look"):
            out = {"readings": (look if args.mode == "look" else f32_look)(cell, seed)}
        else:
            fault = faults.FAULTS.get(args.mode, faults.none)
            with fault():
                out, _ = run(cell, seed, args.seconds, bool(args.trace), "cuda")
        out = {"workload": args.workload, "mode": args.mode, "seed": seed,
               "seconds": time.perf_counter() - t0, **out}
        print(json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
