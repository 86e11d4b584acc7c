#!/usr/bin/env python
"""Refit ``parallel/memory.py``'s layout coefficients against measured peaks.

The counterpart of ``scripts/fit_memory_model.py``. Two corpora constrain
the port's planner:

  1. ``docs/pod_readiness_results_torch.jsonl``: the peaks of stand-in
     ranks on the card (``scripts/pod_readiness_torch.py``), each layout's
     full training step. Target: every row within 25% (held by
     ``tests/test_torch_pod_readiness.py``).
  2. The single-card peaks of ``memory.MEASURED_PEAKS`` (``fit_errors()``,
     held within 3% by ``tests/test_torch_parallel.py``); the layout
     coefficients do not enter them, and this script prints them to show so.

A rank's peak is the larger of two phases (``parallel/memory.py``): the
backward (resident state and the activations, which move with
``_TP_SPLIT_SHARE`` and each ``_SP_TENSORS`` entry) and the update
(resident state and the ``_UPDATE_*_BYTES`` terms). The JAX planner's
backward gradients and pipeline stream fit 0 on these rows and are no
longer terms. Each phase is linear
in its own coefficients, so the rows' phase totals are worked out once per
coefficient and the search for the assignment with the least largest
relative error over the rows runs on them (``scipy.optimize.
differential_evolution``, seeded, within ``BOUNDS``), then rounds to
``--step`` and reports through the planner itself. Apply the values to the
literals at the top of ``merlot_reserve_tpu_torch/parallel/memory.py`` by
hand: the planner does not depend on this script. Then ``--write-planner``
rewrites every row's ``planner_total_gib`` from the planner as it stands.

Usage: python scripts/fit_memory_model_torch.py [--rows FILE] [--step 0.05]
       python scripts/fit_memory_model_torch.py --write-planner
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from merlot_reserve_tpu_torch.parallel import memory, readiness  # noqa: E402
from scripts.pod_readiness_torch import config  # noqa: E402

ROWS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs",
                    "pod_readiness_results_torch.jsonl")
BACKWARD = ("_TP_SPLIT_SHARE",)
UPDATE = ("_UPDATE_ZERO_BYTES", "_UPDATE_SHARD_BYTES", "_UPDATE_WHOLE_BYTES")
BOUNDS = {"_TP_SPLIT_SHARE": (0, 1), "_UPDATE_ZERO_BYTES": (0, 16), "_UPDATE_SHARD_BYTES": (0, 24),
          "_UPDATE_WHOLE_BYTES": (0, 24), "_SP_TENSORS": (0, 8)}


def coefficient_names():
    return list(BACKWARD) + [f"_SP_TENSORS[{k}]" for k in sorted(memory._SP_TENSORS)] \
        + list(UPDATE)


def get(name):
    if name.startswith("_SP_TENSORS["):
        return memory._SP_TENSORS[name[len("_SP_TENSORS["):-1]]
    return getattr(memory, name)


def put(name, value):
    if name.startswith("_SP_TENSORS["):
        memory._SP_TENSORS[name[len("_SP_TENSORS["):-1]] = value
    else:
        setattr(memory, name, value)


def load_rows(path=ROWS):
    return [r for r in (json.loads(line) for line in open(path) if line.strip())
            if r.get("measured_gib") is not None]


def plans(rows):
    """``estimate_train_hbm`` of every row's layout, at the current coefficients."""
    out = []
    for r in rows:
        layout = readiness.LAYOUTS[r["layout"]]
        cfg = readiness.layout_config(config(r["config"], False, False, r["remat"]), layout)
        out.append(readiness.plan(cfg, layout, r["batch"]))
    return out


def predict(rows):
    """The planner's total (GiB) for every row."""
    return np.array([e["total"] for e in plans(rows)]) / memory.GIB


def phase_terms(rows):
    """Per row, in GiB: the resident bytes; the activations at every
    activation coefficient 0 and their slope in each; and per local
    parameter of each kind the update's and the backward's multipliers."""
    act_names = [n for n in coefficient_names() if n not in UPDATE]
    saved = {n: get(n) for n in act_names}
    try:
        for n in act_names:
            put(n, 0.0)
        zero = plans(rows)
        slopes = []
        for n in act_names:
            put(n, 1.0)
            slopes.append([e["activation_bytes"] for e in plans(rows)])
            put(n, 0.0)
    finally:
        for n, v in saved.items():
            put(n, v)
    act0 = np.array([e["activation_bytes"] for e in zero])
    terms = {"resident": np.array([e["resident_bytes"] for e in zero]),
             "act0": act0, "act_names": act_names,
             "act_slopes": np.array(slopes).T - act0[:, None],
             "local": np.array([e["local_params"] for e in zero]),
             "zero": np.array([e["zero1_params"] for e in zero]),
             "zero_dp": np.array([float(r["zero1_dp"]) for r in rows])}
    return {k: v / memory.GIB if isinstance(v, np.ndarray) and k != "zero_dp" else v
            for k, v in terms.items()}


def totals(t, c):
    """Every row's planned total (GiB) for coefficients ``c`` (name -> value)."""
    act = t["act0"] + t["act_slopes"] @ np.array([c[n] for n in t["act_names"]])
    update = (c["_UPDATE_ZERO_BYTES"] * t["zero"]
              + c["_UPDATE_SHARD_BYTES"] * t["zero"] / t["zero_dp"]
              + c["_UPDATE_WHOLE_BYTES"] * (t["local"] - t["zero"]))
    return t["resident"] + np.maximum(act, update)


def report(rows, label):
    pred = predict(rows)
    measured = np.array([r["measured_gib"] for r in rows])
    err = pred / measured - 1
    print(f"{label}: " + ", ".join(f"{n}={get(n):g}" for n in coefficient_names()))
    for r, p, e in zip(rows, pred, err):
        print(f"  {r['name']:58s} batch {r['batch']:3d} pred {p:7.3f} meas "
              f"{r['measured_gib']:7.3f} GiB  err {e:+.3f}")
    print(f"  worst |err| {np.abs(err).max():.3f} over {len(rows)} rows")
    for name, e in memory.fit_errors().items():
        print(f"  single card {name:36s} err {e:+.4f}")
    return np.abs(err).max()


def main(argv=None):
    from scipy.optimize import differential_evolution

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", default=ROWS)
    ap.add_argument("--step", type=float, default=0.05, help="rounding of the fit values")
    ap.add_argument("--write-planner", action="store_true",
                    help="rewrite the rows' planner_total_gib from the planner, and fit nothing")
    args = ap.parse_args(argv)
    if args.write_planner:
        rows = [json.loads(line) for line in open(args.rows) if line.strip()]
        for r, p in zip(rows, predict(rows)):
            r["planner_total_gib"] = round(float(p), 3)
        with open(args.rows, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        return None
    rows = load_rows(args.rows)
    current = report(rows, "current")
    t = phase_terms(rows)
    measured = np.array([r["measured_gib"] for r in rows])
    names = coefficient_names()
    check = totals(t, {n: get(n) for n in names})
    assert np.allclose(check, predict(rows), rtol=1e-9), "the phase terms miss the planner"
    # the planner carries no term that no row measures
    unmoved = [n for i, n in enumerate(t["act_names"]) if not np.any(t["act_slopes"][:, i])]
    assert not unmoved, f"no row moves {unmoved}"

    def worst(x):
        return np.abs(totals(t, dict(zip(names, x))) / measured - 1).max()

    bounds = [BOUNDS["_SP_TENSORS" if n.startswith("_SP_") else n] for n in names]
    res = differential_evolution(worst, bounds, seed=0, tol=1e-10, maxiter=3000, popsize=40,
                                 polish=True)
    for n, v in zip(names, res.x):
        put(n, round(float(np.round(v / args.step) * args.step), 6))
    best = report(rows, "best (rounded)")
    print(json.dumps({"current_worst": current, "best_worst": best,
                      "best": {n: get(n) for n in names}}))
    return {n: get(n) for n in names}


if __name__ == "__main__":
    main()
