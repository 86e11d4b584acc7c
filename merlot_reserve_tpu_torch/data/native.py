"""ctypes bindings for the port's host data plane (``csrc/merlot_native.cc``):
TFRecord reading, tf.train.Example parsing, JPEG decode and encode, the
fused resize, pad and patchify, and Pillow's 8-bit resize.

The port of ``merlot_reserve_tpu/data/native.py``. The library is built with
g++ at first use into ``_build/`` inside the package (gitignored), named by
its JPEG codec and a hash of its source and flags. The codec is libjpeg where
the compiler finds ``jpeglib.h``, else nvJPEG from the CUDA toolkit
(``$CUDA_HOME``, default ``/usr/local/cuda``). There is no fallback: when
neither codec is there, or the build or the load fails, ``load`` raises, and
so does every function here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "merlot_native.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")  # the JAX package's build
CODECS = {1: "libjpeg", 2: "nvjpeg"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the port's data library is built with g++")
    return path


def _codec_flags() -> Tuple[str, List[str]]:
    """(codec, extra g++ arguments): libjpeg where the compiler finds its
    header, else nvJPEG from the CUDA toolkit; raises when neither is there."""
    probe = subprocess.run([_cxx(), "-E", "-x", "c++", "-"], input="#include <jpeglib.h>\n",
                           capture_output=True, text=True)
    if probe.returncode == 0:
        return "libjpeg", ["-ljpeg"]
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if os.path.exists(os.path.join(cuda, "include", "nvjpeg.h")):
        lib = os.path.join(cuda, "lib64")
        return "nvjpeg", ["-DMN_NVJPEG", f"-I{cuda}/include", f"-L{lib}", f"-Wl,-rpath,{lib}",
                          "-lnvjpeg", "-lcudart"]
    raise RuntimeError("no JPEG codec: neither libjpeg (jpeglib.h) nor the CUDA toolkit's "
                       f"nvJPEG ({cuda}/include/nvjpeg.h) was found")


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises with g++'s output when the build fails."""
    codec, extra = _codec_flags()
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join((*CXXFLAGS, *extra)).encode())
    target = BUILD_DIR / f"libmerlot_native-{codec}-{key.hexdigest()[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_cxx(), *CXXFLAGS, str(SOURCE), "-o", str(tmp), *extra],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name} ({codec}, exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, target)  # atomic: another process never loads half a file
    return target


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mn_reader_open.restype = ctypes.c_void_p
    lib.mn_reader_open.argtypes = [ctypes.c_char_p]
    lib.mn_reader_next.restype = ctypes.c_int64
    lib.mn_reader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(_u8p)]
    lib.mn_reader_close.restype = None
    lib.mn_reader_close.argtypes = [ctypes.c_void_p]
    lib.mn_example_parse.restype = ctypes.c_void_p
    lib.mn_example_parse.argtypes = [_u8p, ctypes.c_int64]
    lib.mn_example_free.restype = None
    lib.mn_example_free.argtypes = [ctypes.c_void_p]
    lib.mn_feature_num_bytes.restype = ctypes.c_int64
    lib.mn_feature_num_bytes.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mn_feature_bytes.restype = ctypes.c_int64
    lib.mn_feature_bytes.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.POINTER(_u8p)]
    lib.mn_feature_ints.restype = ctypes.c_int64
    lib.mn_feature_ints.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))]
    lib.mn_feature_floats.restype = ctypes.c_int64
    lib.mn_feature_floats.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.mn_jpeg_codec.restype = ctypes.c_int
    lib.mn_jpeg_codec.argtypes = []
    lib.mn_last_error.restype = ctypes.c_char_p
    lib.mn_last_error.argtypes = []
    lib.mn_free.restype = None
    lib.mn_free.argtypes = [ctypes.c_void_p]
    lib.mn_decode_jpeg.restype = ctypes.c_int
    lib.mn_decode_jpeg.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), _u8p]
    lib.mn_encode_jpeg.restype = ctypes.c_int
    lib.mn_encode_jpeg.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(_u8p), ctypes.POINTER(ctypes.c_int64)]
    lib.mn_resize_patchify_k.restype = None
    lib.mn_resize_patchify_k.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    lib.mn_resize_u8.restype = ctypes.c_int
    lib.mn_resize_u8.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, _u8p]
    return lib


def load() -> ctypes.CDLL:
    """The library, built first if needed. Raises when it cannot be built or
    loaded, or when no JPEG codec is found."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib


def jpeg_codec() -> str:
    """'libjpeg' or 'nvjpeg': the codec the library was built with."""
    return CODECS[load().mn_jpeg_codec()]


def _error(what: str) -> RuntimeError:
    return RuntimeError(f"{what}: {load().mn_last_error().decode(errors='replace')}")


def read_records_native(path: str) -> Iterator[bytes]:
    """Iterate raw record payloads (the native framing reader; CRCs are not
    checked: ``tfrecord.read_records(check_crc=True)`` does that)."""
    lib = load()
    handle = lib.mn_reader_open(os.fsencode(path))
    if not handle:
        raise IOError(f"cannot open {path}")
    try:
        ptr = _u8p()
        while True:
            n = lib.mn_reader_next(handle, ctypes.byref(ptr))
            if n < 0:
                return
            yield ctypes.string_at(ptr, n)
    finally:
        lib.mn_reader_close(handle)


class NativeExample:
    """A parsed tf.train.Example with typed feature reads."""

    def __init__(self, record: bytes):
        self._lib = load()
        buf = (ctypes.c_uint8 * len(record)).from_buffer_copy(record)
        self._h = self._lib.mn_example_parse(buf, len(record))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mn_example_free(self._h)
            self._h = None

    def bytes_list(self, key: str) -> List[bytes]:
        k = key.encode()
        out = []
        for i in range(max(self._lib.mn_feature_num_bytes(self._h, k), 0)):
            ptr = _u8p()
            n = self._lib.mn_feature_bytes(self._h, k, i, ctypes.byref(ptr))
            out.append(ctypes.string_at(ptr, n))
        return out

    def int64s(self, key: str) -> np.ndarray:
        ptr = ctypes.POINTER(ctypes.c_int64)()
        n = self._lib.mn_feature_ints(self._h, key.encode(), ctypes.byref(ptr))
        if n <= 0:  # missing (< 0) or present but empty (0: a NULL data pointer)
            return np.zeros(0, np.int64)
        return np.ctypeslib.as_array(ptr, shape=(n,)).copy()

    def floats(self, key: str) -> np.ndarray:
        ptr = ctypes.POINTER(ctypes.c_float)()
        n = self._lib.mn_feature_floats(self._h, key.encode(), ctypes.byref(ptr))
        if n <= 0:
            return np.zeros(0, np.float32)
        return np.ctypeslib.as_array(ptr, shape=(n,)).copy()


def decode_jpeg_native(data: bytes, channels: int = 3) -> np.ndarray:
    """JPEG bytes -> [h, w, 3] (channels 3) or [h, w] (channels 1) uint8."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    lib = load()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.mn_decode_jpeg(buf, len(data), channels, ctypes.byref(h), ctypes.byref(w), None):
        raise _error("jpeg decode failed")
    out = np.empty((h.value, w.value, 3) if channels == 3 else (h.value, w.value), np.uint8)
    if lib.mn_decode_jpeg(buf, len(data), channels, ctypes.byref(h), ctypes.byref(w),
                          out.ctypes.data_as(_u8p)):
        raise _error("jpeg decode failed")
    return out


def encode_jpeg_native(pixels: np.ndarray, quality: int = 90) -> bytes:
    """[h, w, 3] (RGB) or [h, w] (grayscale) uint8 -> baseline JPEG bytes
    (4:2:0 chroma for RGB)."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    if pixels.ndim not in (2, 3) or (pixels.ndim == 3 and pixels.shape[2] != 3):
        raise ValueError(f"expected [h, w] or [h, w, 3] uint8, got {pixels.shape}")
    lib = load()
    channels = 1 if pixels.ndim == 2 else 3
    out, n = _u8p(), ctypes.c_int64()
    if lib.mn_encode_jpeg(pixels.ctypes.data_as(_u8p), pixels.shape[0], pixels.shape[1],
                          channels, int(quality), ctypes.byref(out), ctypes.byref(n)):
        raise _error("jpeg encode failed")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.mn_free(out)


def resize_patchify_native(rgb: np.ndarray, grid, kernel: int, patch: int = 16,
                           scale_mult: float = 1.0, off_y: int = 0, off_x: int = 0) -> np.ndarray:
    """[h, w, 3] uint8 -> [grid_h*grid_w, patch*patch*3] float32 in [0, 1]:
    aspect-preserving resize into the grid box times ``scale_mult`` with one
    of the antialiased Pillow filters (``kernel`` in ``RESIZE_KERNELS``
    order: 0 BICUBIC, 1 BILINEAR, 2 BOX, 3 HAMMING, 4 LANCZOS, 5 NEAREST),
    crop at (``off_y``, ``off_x``), zero pad, patchify."""
    lib = load()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [h, w, 3] uint8, got {rgb.shape}")
    if not 0 <= kernel < len(RESIZE_KERNELS):
        raise ValueError(f"kernel must be in [0, {len(RESIZE_KERNELS)}), got {kernel}")
    gh, gw = grid
    out = np.empty((gh * gw, patch * patch * 3), np.float32)
    lib.mn_resize_patchify_k(rgb.ctypes.data_as(_u8p), rgb.shape[0], rgb.shape[1], gh, gw,
                             patch, float(scale_mult), int(off_y), int(off_x), int(kernel),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def resize_native(pixels: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[h, w, 3] or [h, w] uint8 -> [out_h, out_w(, 3)] uint8: Pillow's
    bilinear ``Image.resize`` of an 8-bit image, bit for bit."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    if pixels.ndim not in (2, 3) or (pixels.ndim == 3 and pixels.shape[2] != 3):
        raise ValueError(f"expected [h, w] or [h, w, 3] uint8, got {pixels.shape}")
    lib = load()
    channels = 1 if pixels.ndim == 2 else 3
    out = np.empty((out_h, out_w, 3) if channels == 3 else (out_h, out_w), np.uint8)
    if lib.mn_resize_u8(pixels.ctypes.data_as(_u8p), pixels.shape[0], pixels.shape[1], channels,
                        int(out_h), int(out_w), out.ctypes.data_as(_u8p)):
        raise _error("resize failed")
    return out


# the per-image random resize kernels, in the JAX package's
# pil_resize_methods() order (Pillow's six filters, sorted by name)
RESIZE_KERNELS = ("BICUBIC", "BILINEAR", "BOX", "HAMMING", "LANCZOS", "NEAREST")
BILINEAR = 1
