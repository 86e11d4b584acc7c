"""What a run loads: no module whose top-level name is jax, jaxlib, flax or
the JAX package (compared whole: the port's name begins with the JAX
package's), and a reference that imports nothing of the program."""

import ast
import subprocess
import sys

from conftest import BENCH, ROOT

PROGRAM = "merlot_reserve_tpu_torch"


def test_forbidden_names_are_compared_whole():
    from harness import runner

    before = dict(sys.modules)
    try:
        sys.modules.pop("merlot_reserve_tpu", None)
        sys.modules.setdefault("merlot_reserve_tpu_torch_fake", object())
        assert "merlot_reserve_tpu" not in runner.forbidden_modules()
        sys.modules["merlot_reserve_tpu.models"] = object()
        assert runner.forbidden_modules() == ["merlot_reserve_tpu"] or \
            "merlot_reserve_tpu" in runner.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def test_a_tiny_run_loads_nothing_forbidden():
    """Every module a run loads, in a fresh process: the harness, both
    drivers, every metric reader, the reference and the program, through a
    tiny run of each kind of cell on the CPU with the trace on."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, {str(ROOT)!r}]
import torch
torch.set_num_threads(2)
from conftest import tiny_cell
from harness.runner import run, forbidden_modules
for name in ("base.pretrain.b8", "large.serve.offline"):
    run(tiny_cell(name), 3, 0.2, True, "cpu")
import calibrate, run as entry
print("FORBIDDEN", forbidden_modules())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "FORBIDDEN []" in p.stdout


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in (PROGRAM, "merlot_reserve_tpu", "jax", "flax", "harness",
                               "drivers"), (path.name, name)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "merlot_reserve_tpu"), \
                (path, name)


def test_run_fails_without_the_program_or_a_card(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, a run
    exits with a code other than 0 and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "base.pretrain.b8",
                        "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()
