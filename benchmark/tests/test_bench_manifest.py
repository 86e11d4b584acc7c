"""BENCHMARK.json against the benchmark's contract: names, units, keys,
what each metric moves and where it is reported, and every file a cell
needs, found by name."""

import json
import math
import re
from pathlib import Path

import pytest

from conftest import BENCH, ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WORKLOADS = [w["name"] for w in MAN["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == TOP_KEYS
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert MAN["command"][1] == "benchmark/run.py"
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = [c["name"] for c in MAN["configs"]] + WORKLOADS + \
        [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["reduced"] == []
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_setup_s_and_every_cell_reports_enough():
    from harness.cell import reports

    e2e = MAN["end_to_end"]
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    for w in WORKLOADS:
        mine = [m["name"] for m in e2e if reports(m, w, e2e)]
        assert "setup_s" in mine and len(mine) >= 2, w
        assert any(reports(m, w, e2e) for m in MAN["per_layer"]), w


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    from harness.cell import reports

    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["workloads"] and set(m["workloads"]) <= set(WORKLOADS)
        for w in m["workloads"]:
            assert reports(e2e[m["moves"]], w, MAN["end_to_end"]), (m["name"], w)


def test_each_layer_is_named_as_perf_md_lists_it():
    perf = (ROOT / "PERF.md").read_text()
    section = perf[perf.index("## 3. Layers"):perf.index("## 4. Cells")]
    rows = [r.split("|")[1].strip() for r in section.splitlines() if r.startswith("| ")]
    for m in MAN["per_layer"]:
        assert m["layer"] in rows, m["layer"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cells_files_are_found_by_name(workload):
    from harness.cell import load_cell

    cell = load_cell(workload)
    assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").exists()
    assert cell.limits and all(math.isfinite(v) and v > 0 for v in cell.limits.values())
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    for m in MAN["configs"]:
        assert (ROOT / m["file"]).is_file() and m["file"].startswith("benchmark/")


def test_files_under_paths_have_names_of_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))), p


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_config_files_hold_what_the_port_runs(name):
    """Each configuration file's values are what the program's named yaml
    gives (nothing was cut), and the harness builds the port's config
    from them without a difference."""
    from harness.config import load, port_config

    conf = next(c for c in MAN["configs"] if c["name"] == name)
    cfg = load(ROOT / conf["file"], {})
    from merlot_reserve_tpu_torch.config import load_config

    theirs = load_config(cfg.port_config)
    for section in ("model", "data", "optimizer"):
        for k, v in getattr(cfg, section).as_dict().items():
            assert getattr(getattr(theirs, section), k) == v, (section, k)
    port_config(cfg)
