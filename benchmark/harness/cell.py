"""The manifest (``BENCHMARK.json``) and one cell of it, with every file the
cell needs found by name: its configuration, its traffic mix, the mix's
driver, its limits, and the readers of its per-layer metrics."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List

from harness import config as config_mod

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def manifest(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _safe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", name)


@dataclass
class Cell:
    name: str
    entry: Dict[str, Any]
    config: Any
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, Callable] = field(default_factory=dict)

    def driver(self, seed: int, device):
        mod = _module(BENCH_DIR / "drivers" / f"{self.traffic['driver']}.py",
                      f"bench_driver_{_safe(self.traffic['driver'])}")
        return mod.Driver(self, seed, device)


def reports(metric: Dict[str, Any], workload: str, end_to_end: List[Dict[str, Any]]) -> bool:
    """Whether ``workload`` reports this metric: it is listed under the
    metric's ``workloads``, or, where the metric has none, the workload
    reports the end-to-end metric it moves (per-layer) or every cell does
    (end-to-end)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in end_to_end if m["name"] == metric["moves"])
        return reports(moved, workload, end_to_end)
    return True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    traffic = json.loads((BENCH_DIR / "traffic" / f"{entry['traffic']}.json").read_text())
    cfg = config_mod.load(root / conf["file"], traffic)
    limits = json.loads((BENCH_DIR / "limits" / f"{name}.json").read_text())
    e2e = [m for m in man["end_to_end"] if reports(m, name, man["end_to_end"])]
    layer = [m for m in man["per_layer"] if reports(m, name, man["end_to_end"])]
    cell = Cell(name, entry, cfg, traffic, {k: float(v) for k, v in limits["limits"].items()},
                e2e, layer)
    for m in layer:
        cell.readers[m["name"]] = _module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                                          f"bench_metric_{_safe(m['name'])}").read
    return cell
