"""The JAX package's native data library, built once for the port's parity
tests whose JAX side decodes through it.

``merlot_reserve_tpu.data.native._load`` builds ``libmerlot_native.so``
beside its source at first use, with g++ writing straight onto the path
that it then loads, and caches the result for the life of the process. Test
workers that start at once on a tree without the library race on that file:
one that loads it half-written gets ``None``, and the JAX side silently
falls back to PIL, so a bit-for-bit comparison fails for a reason that has
nothing to do with the port. ``use_jax_native()`` builds the same source
with the same g++ command into a private temporary file, renames it into
place (a worker sees the whole library or none), points the JAX module at
it and asserts that it loads. A missing library then fails with its own
message. The JAX package is not edited.
"""

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

from merlot_reserve_tpu.data import native as jnative

ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = ROOT / "tests" / "_build"  # gitignored


def _library_path() -> Path:
    """Where the library is built, named by a hash of its source."""
    src = Path(jnative._NATIVE_DIR) / "merlot_native.cc"
    tag = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libmerlot_native-jax-{tag}.so"


def _build(target: Path) -> None:
    src = Path(jnative._NATIVE_DIR) / "merlot_native.cc"
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=target.name + ".", suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        # the command of merlot_reserve_tpu/data/native.py's _load
        proc = subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", str(src),
                               "-o", tmp, "-ljpeg"], capture_output=True, text=True)
        assert proc.returncode == 0, (f"building the JAX package's native library failed "
                                      f"(exit {proc.returncode}):\n{proc.stderr[-3000:]}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def use_jax_native() -> str:
    """Build (once) and load the JAX package's native library in this
    process; returns its path. Fails when it cannot be built or loaded."""
    target = _library_path()
    if not target.exists():
        _build(target)
    jnative._SO_PATH = str(target)
    jnative._load.cache_clear()
    assert jnative.native_available(), (
        f"the JAX package's native library {target} does not load: its side of the "
        "comparisons would fall back to PIL")
    return str(target)
