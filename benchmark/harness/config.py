"""A benchmark configuration: the sizes a cell runs, read from
``benchmark/configs/<name>.json`` with the traffic mix's shape overrides
applied, as plain objects that the frozen generator, the FLOP counts and
the reference read; and the program's own configuration built from the
same values and checked against them."""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict


class Section:
    """One group of settings (model, data, optimizer) as attributes."""

    def __init__(self, values: Dict[str, Any]):
        for k, v in values.items():
            setattr(self, k, tuple(v) if isinstance(v, list) else v)

    def as_dict(self) -> Dict[str, Any]:
        return dict(vars(self))


class ModelSection(Section):
    @property
    def num_heads(self) -> int:
        return self.hidden_size // self.size_per_head

    @property
    def vit_seq_len(self) -> int:
        return self.output_grid[0] * self.output_grid[1]

    @property
    def vit_grid_pooled(self):
        return tuple(g // self.vit_pooling_ratio for g in self.output_grid)

    @property
    def vit_pooled_seq_len(self) -> int:
        h, w = self.vit_grid_pooled
        return h * w


class DataSection(Section):
    @property
    def num_segments_per_group(self) -> int:
        return self.num_segments // self.num_segment_groups


class BenchConfig:
    """``model``, ``data`` and ``optimizer`` of one cell."""

    def __init__(self, name: str, port_config: str, model, data, optimizer):
        self.name = name
        self.port_config = port_config
        self.model = ModelSection(model)
        self.data = DataSection(data)
        self.optimizer = Section(optimizer)


def load(path: Path, traffic: Dict[str, Any]) -> BenchConfig:
    """The configuration file with the traffic mix's ``model`` and ``data``
    overrides (shapes and the recompute a long mix needs) applied."""
    raw = json.loads(Path(path).read_text())
    model = dict(raw["model"], **traffic.get("model", {}))
    data = dict(raw["data"], **traffic.get("data", {}))
    return BenchConfig(raw["name"], raw["port_config"], model, data, dict(raw["optimizer"]))


def port_config(cfg: BenchConfig):
    """The program's configuration for this cell: its named yaml with this
    cell's values, each checked against what the program then holds, so a
    cell runs the sizes its files state whatever the yaml says later."""
    from merlot_reserve_tpu_torch.config import load_config

    pc = load_config(cfg.port_config)
    pc = pc.replace_model(**{k: v for k, v in cfg.model.as_dict().items()
                             if getattr(pc.model, k) != v})
    pc = pc.replace_data(**{k: v for k, v in cfg.data.as_dict().items()
                            if getattr(pc.data, k) != v})
    import dataclasses

    pc = dataclasses.replace(pc, optimizer=dataclasses.replace(
        pc.optimizer, **{k: v for k, v in cfg.optimizer.as_dict().items()
                         if getattr(pc.optimizer, k) != v}))
    for section in ("model", "data", "optimizer"):
        ours, theirs = getattr(cfg, section).as_dict(), getattr(pc, section)
        for k, v in ours.items():
            if getattr(theirs, k) != v:
                raise ValueError(f"{section}.{k}: the program holds {getattr(theirs, k)!r}, "
                                 f"the cell states {v!r}")
    return pc


def with_overrides(cfg: BenchConfig, **model) -> BenchConfig:
    """A copy with model values replaced (the tests' tiny widths)."""
    out = copy.deepcopy(cfg)
    for k, v in model.items():
        setattr(out.model, k, v)
    return out
