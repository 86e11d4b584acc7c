"""Pluggable experiment tracking: the port of
``merlot_reserve_tpu/utils/experiment.py`` (the wandb slot of the
reference's pretraining loop: wandb.init on host 0 with the config dict,
commit_every_nsteps=50, silent unless host 0). ``JsonlTracker`` writes the
same files and lines as the JAX package's.

Design: a tiny Tracker protocol so the training loops never import a
tracking backend directly. Backends:

* ``JsonlTracker`` — dependency-free default: run directory with
  ``config.json`` + append-only ``metrics.jsonl`` (one record per logged
  step; crash-safe since every line is fsync-able and self-contained).
* ``WandbTracker`` — uses wandb when installed (construction raises
  ImportError otherwise, which ``make_tracker`` surfaces plainly).
* ``MultiTracker`` / ``NullTracker`` — composition and the host-0 off
  switch.

``make_tracker`` builds from a spec string so YAML/CLI configs can select
backends: "none", "jsonl:/path/to/rundir", "wandb:project[:entity]".
Non-zero hosts always get NullTracker (reference semantics: only host 0
logs).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, Optional


class Tracker:
    """Protocol: what training loops are allowed to call."""

    def log_config(self, config: Dict[str, Any]) -> None:  # pragma: no cover
        pass

    def log(self, step: int, metrics: Dict[str, float]) -> None:  # pragma: no cover
        pass

    def finish(self) -> None:  # pragma: no cover
        pass


class NullTracker(Tracker):
    pass


class JsonlTracker(Tracker):
    """Run directory with config.json and append-only metrics.jsonl."""

    def __init__(self, run_dir: str, run_name: Optional[str] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._path = os.path.join(run_dir, "metrics.jsonl")
        self._f = open(self._path, "a", buffering=1)  # line-buffered
        self._t0 = time.time()
        self._last: Optional[tuple] = None  # (step, wall) for it/s
        meta = {"run_name": run_name or os.path.basename(run_dir),
                "started_unix": self._t0}
        with open(os.path.join(run_dir, "run.json"), "w") as f:
            json.dump(meta, f)

    def log_config(self, config: Dict[str, Any]) -> None:
        def _clean(x):
            if isinstance(x, dict):
                return {k: _clean(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [_clean(v) for v in x]
            if isinstance(x, (str, int, float, bool)) or x is None:
                return x
            return repr(x)

        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            json.dump(_clean(config), f, indent=2)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        now = time.time()
        rec = {"step": int(step), "wall": round(now - self._t0, 3)}
        if self._last is not None and step > self._last[0]:
            dt = now - self._last[1]
            if dt > 0:
                rec["steps_per_sec"] = round((step - self._last[0]) / dt, 4)
        self._last = (step, now)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = repr(v)
        self._f.write(json.dumps(rec) + "\n")

    def finish(self) -> None:
        if not self._f.closed:
            self._f.close()


class WandbTracker(Tracker):
    """wandb backend (the reference's semantics). Lazy import: raises
    ImportError at construction when wandb isn't installed."""

    def __init__(self, project: str, entity: Optional[str] = None,
                 name: Optional[str] = None, commit_every: int = 50):
        import wandb

        self._wandb = wandb
        self._run = wandb.init(project=project, entity=entity, name=name)
        self._commit_every = commit_every

    def log_config(self, config: Dict[str, Any]) -> None:
        self._run.config.update(config, allow_val_change=True)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self._wandb.log(metrics, step=step,
                        commit=step % self._commit_every == 0)

    def finish(self) -> None:
        self._run.finish()


class MultiTracker(Tracker):
    def __init__(self, trackers: Iterable[Tracker]):
        self.trackers = list(trackers)

    def log_config(self, config):
        for t in self.trackers:
            t.log_config(config)

    def log(self, step, metrics):
        for t in self.trackers:
            t.log(step, metrics)

    def finish(self):
        for t in self.trackers:
            t.finish()


def make_tracker(spec: Optional[str], host_index: int = 0,
                 run_name: Optional[str] = None) -> Tracker:
    """Build a tracker from a spec string; non-zero hosts get NullTracker.

    Specs: None/"none" | "jsonl:<run_dir>" | "wandb:<project>[:<entity>]",
    or several joined with "+".
    """
    if host_index != 0 or not spec or spec == "none":
        return NullTracker()
    parts = spec.split("+")
    trackers = []
    for part in parts:
        kind, _, rest = part.partition(":")
        if kind == "jsonl":
            trackers.append(JsonlTracker(rest or "runs/default",
                                         run_name=run_name))
        elif kind == "wandb":
            project, _, entity = rest.partition(":")
            trackers.append(WandbTracker(project or "merlot_reserve_tpu",
                                         entity=entity or None,
                                         name=run_name))
        elif kind == "none":
            continue
        else:
            raise ValueError(f"unknown tracker spec {part!r}")
    if not trackers:
        return NullTracker()
    if len(trackers) == 1:
        return trackers[0]
    return MultiTracker(trackers)
