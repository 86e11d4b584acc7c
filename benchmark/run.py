"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; every file they need is found by name under ``benchmark/``.
The run sets up (weights and inputs from ``--seed``, every shape warmed),
measures for ``--seconds``, checks what the timed path produced against the
plain reference, and prints one JSON object as the last line of standard
output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a profiler trace of the
window's first iterations. The numbers compared, each beside its limit,
end standard error and the result line.

It needs a CUDA card (exit 2 without one), the program's package beside
this directory (exit 2 without it), and leaves no JAX loaded (exit 3).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the host paces these cells, and idle
    # worker threads only contend with the one that feeds the card
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [str(BENCH), str(ROOT)]

    import torch

    torch.set_num_threads(1)

    from harness.cell import load_cell
    from harness.runner import forbidden_modules, run

    cell = load_cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import merlot_reserve_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program (merlot_reserve_tpu_torch) is not importable: {e}", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, lines = run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
