"""A pure-Python codec for the msgpack that flax's serialization writes.

``flax.serialization.msgpack_serialize`` writes a tree of maps with string
keys whose leaves are nil, bools, ints, floats, strings, bytes, arrays and
two extension types:

  * ext 1 (ndarray): the payload is itself msgpack, the array
    ``[shape, dtype name, C-order bytes]``;
  * ext 3 (numpy scalar): the same payload for a 0-d array.

Arrays above ``MAX_CHUNK_SIZE`` bytes are written as a map
``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0":
flat array, ...}}``, which ``unpackb`` joins back into one array.

Array leaves decode to CPU ``torch.Tensor``s straight from the buffer
(``torch.frombuffer``: "bfloat16" is ``torch.bfloat16``, so no numpy type
for it is needed), and tensors encode to the same bytes. Neither the
``msgpack`` package nor flax nor ``ml_dtypes`` is needed.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, List

import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3

DTYPES = {
    "float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float64": torch.float64, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "bool": torch.bool,
}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


class MsgpackError(ValueError):
    pass


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data):
        self.view = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.view):
            raise MsgpackError("truncated msgpack data")
        out = self.view[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sized = {0xC4: (">B", self.bin), 0xC5: (">H", self.bin), 0xC6: (">I", self.bin),
                 0xD9: (">B", self.str), 0xDA: (">H", self.str), 0xDB: (">I", self.str),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map),
                 0xC7: (">B", self.ext), 0xC8: (">H", self.ext), 0xC9: (">I", self.ext)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def bin(self, n: int) -> memoryview:
        return self.take(n)

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise MsgpackError(f"unsupported msgpack extension type {code}")
        inner = _Reader(payload)
        shape, name, buf = inner.obj()
        if isinstance(name, memoryview):
            name = str(name, "utf-8")
        return _tensor_from_buffer(buf, name, shape)


def _tensor_from_buffer(buf, name: str, shape) -> torch.Tensor:
    if name not in DTYPES:
        raise MsgpackError(f"unsupported array dtype {name!r}")
    dtype = DTYPES[name]
    numel = 1
    for d in shape:
        numel *= d
    if numel * dtype.itemsize != len(buf):
        raise MsgpackError(f"array of shape {shape} and dtype {name} has {len(buf)} bytes")
    if numel == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(buf, dtype=dtype).reshape(tuple(shape))


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data) -> Any:
    """Decode one msgpack object (bytes, bytearray or memoryview). Array
    leaves are CPU tensors that share ``data``'s memory (``bytes`` are
    copied first, since tensors cannot hold read-only memory)."""
    if isinstance(data, bytes):
        data = bytearray(data)
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.view):
        raise MsgpackError(f"{len(reader.view) - reader.pos} trailing bytes after the object")
    return _unchunk(out)


def load(path) -> Any:
    """Decode the msgpack file at ``path`` (into writable tensors)."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    return unpackb(data)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _int(x: int) -> bytes:
    if 0 <= x <= 0x7F:
        return bytes([x])
    if -32 <= x < 0:
        return bytes([x + 0x100])
    if x >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < limit:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if x >= -limit:
                return bytes([code]) + struct.pack(fmt, x)
    raise MsgpackError(f"integer {x} does not fit in 64 bits")


def _header(n: int, fix_base, fix_limit, codes) -> bytes:
    if fix_base is not None and n < fix_limit:
        return bytes([fix_base | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise MsgpackError(f"length {n} does not fit in 32 bits")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _header(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + raw


def _bin_header(n: int) -> bytes:
    return _header(n, None, 0, (0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _header(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _tensor(t: torch.Tensor, out: List) -> None:
    if t.dtype not in DTYPE_NAMES:
        raise MsgpackError(f"unsupported tensor dtype {t.dtype}")
    t = t.detach().to("cpu").contiguous()
    data = memoryview(t.reshape(-1).view(torch.uint8).numpy()) if t.numel() else b""
    inner = (bytes([0x90 | 3]) + _header(t.dim(), 0x90, 16, (None, 0xDC, 0xDD))
             + b"".join(_int(d) for d in t.shape) + _str(DTYPE_NAMES[t.dtype])
             + _bin_header(len(data)))
    out += [_ext_header(EXT_NDARRAY, len(inner) + len(data)), inner, data]


def _chunk(t: torch.Tensor) -> dict:
    size = max(1, MAX_CHUNK_SIZE // t.element_size())
    flat = t.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(t.shape)},
            "chunks": {str(i): flat[s:s + size]
                       for i, s in enumerate(range(0, flat.numel(), size))}}


def _obj(x, out: List) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        out.append(_str(x))
    elif isinstance(x, (bytes, bytearray)):
        out += [_bin_header(len(x)), bytes(x)]
    elif isinstance(x, torch.Tensor):
        if x.numel() * x.element_size() > MAX_CHUNK_SIZE:
            _obj(_chunk(x), out)
        else:
            _tensor(x, out)
    elif isinstance(x, dict):
        out.append(_header(len(x), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in x.items():
            if not isinstance(k, str):
                raise MsgpackError(f"map key {k!r} is not a string")
            out.append(_str(k))
            _obj(v, out)
    elif isinstance(x, (list, tuple)):
        out.append(_header(len(x), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in x:
            _obj(v, out)
    else:
        raise MsgpackError(f"cannot encode {type(x).__name__}")


def pack_pieces(tree) -> List:
    """The msgpack encoding of ``tree`` as a list of byte pieces; a tensor's
    data is a view of its (CPU, contiguous) memory, not a copy."""
    out: List = []
    _obj(tree, out)
    return out


def packb(tree) -> bytes:
    """Encode ``tree`` (dicts with string keys, lists, None, bools, ints,
    floats, strings, bytes and tensors, which go to the CPU) as flax does."""
    return b"".join(pack_pieces(tree))


def dump(tree, f: BinaryIO) -> int:
    """Write ``packb(tree)`` to the binary file ``f`` piece by piece;
    returns the number of bytes written."""
    n = 0
    for piece in pack_pieces(tree):
        n += f.write(piece)
    return n
