"""Build the port's CUDA sources (``csrc/<name>.cu``) with nvcc into shared
libraries with a plain C interface, and load them with ctypes.

Each library is built at first use into ``_build/`` inside the package
(listed in ``.gitignore``), named by a hash of its source, the shared
headers ``csrc/*.cuh`` and the flags, so a changed source or header is
rebuilt and an unchanged one is not. Nothing is built or loaded at import
time. Under ``utils.profiling.log_compiles`` every build or load is logged
(name, built or cached, seconds).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's output, with -Xptxas -v's register/spill lines


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "with the CUDA toolkit, on a machine with the card")
    return path


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, every shared
    header (``csrc/*.cuh``, which a source may include) and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str) -> Built:
    target = _target(name)
    if target.exists():
        return Built(target, 0.0, "")
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, target)  # atomic: another process never loads half a file
    return Built(target, time.perf_counter() - t0, proc.stdout)


def build(names: Sequence[str]) -> Dict[str, Built]:
    """Compile each named source that is not built yet, one nvcc process per
    source, all started together. Raises with nvcc's output on a failure,
    after every nvcc has ended."""
    from merlot_reserve_tpu_torch.utils.profiling import log_compile

    BUILD_DIR.mkdir(exist_ok=True)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        built = dict(zip(names, pool.map(_compile, names)))
    for name, b in built.items():
        log_compile("kernel build", name, "built" if b.seconds else "cached", b.seconds)
    return built


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed. Callers
    cache what they load."""
    from merlot_reserve_tpu_torch.utils.profiling import log_compile

    path = build([name])[name].path
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(path))
    log_compile("kernel load", name, path.name, time.perf_counter() - t0)
    return lib
