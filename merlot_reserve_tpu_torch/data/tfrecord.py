"""Pure-python TFRecord + tf.train.Example codec (no TensorFlow dependency):
the port's copy of ``merlot_reserve_tpu/data/tfrecord.py``.

The reference reads its pretraining corpus through tf.data
(reference pretrain/dataloader.py:864-960). Here record IO is a small
self-contained codec: TFRecord framing is length-prefixed records with
masked-crc32c guards, and tf.Example is a protobuf with exactly three leaf
field types (bytes_list, float_list, int64_list) — small enough to parse
directly. The loader reads through the native library
(``data/native.py``); this codec writes records (``ShufflingRecordWriter``
for the dataset tools' shards) and checks CRCs.

Format references (public): TFRecord framing and the Example/Feature proto
schema from the TensorFlow documentation.
"""

from __future__ import annotations

import random
import struct
from typing import Dict, Iterator, List, Sequence, Union

import numpy as np

# ---------------------------------------------------------------------------
# masked crc32c (TFRecord framing guard)
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def read_records(path: str, check_crc: bool = False) -> Iterator[bytes]:
    """Iterate raw record payloads from a local TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            if check_crc:
                (crc,) = struct.unpack("<I", header[8:12])
                if _masked_crc(header[:8]) != crc:
                    raise IOError(f"corrupt length crc in {path}")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise IOError(f"truncated record in {path}")
            if check_crc:
                (crc,) = struct.unpack("<I", footer)
                if _masked_crc(data) != crc:
                    raise IOError(f"corrupt data crc in {path}")
            yield data


def _write_framed(f, rec: bytes):
    header = struct.pack("<Q", len(rec))
    f.write(header)
    f.write(struct.pack("<I", _masked_crc(header)))
    f.write(rec)
    f.write(struct.pack("<I", _masked_crc(rec)))


def write_records(path: str, records: Sequence[bytes]):
    with open(path, "wb") as f:
        for rec in records:
            _write_framed(f, rec)


class ShufflingRecordWriter:
    """Record writer with an in-memory shuffle buffer (the reference's
    GCSTFRecordWriter convention, data_utils.py:10-66): records accumulate
    in a buffer that, when full, writes a random half of itself, so
    neighbouring source videos spread within a shard. ``close`` writes the
    rest in random order. Same seed, same records: the JAX package's file."""

    def __init__(self, path: str, buffer_size: int = 1024, seed: int = 0):
        self._buffer_size = buffer_size
        self._rng = random.Random(seed)
        self._buffer: List[bytes] = []
        self._file = open(path, "wb")
        self.num_written = 0

    def write(self, record: bytes):
        self._buffer.append(record)
        if len(self._buffer) >= self._buffer_size:
            self._rng.shuffle(self._buffer)
            half = len(self._buffer) // 2
            self._write_all(self._buffer[:half])
            self._buffer = self._buffer[half:]

    def _write_all(self, records: Sequence[bytes]):
        for rec in records:
            _write_framed(self._file, rec)
        self.num_written += len(records)

    def close(self):
        if self._file.closed:
            return
        self._rng.shuffle(self._buffer)
        try:
            self._write_all(self._buffer)
        finally:
            self._buffer = []
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# protobuf wire format (just enough for tf.train.Example)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field_num, wire_type = key >> 3, key & 7
        if wire_type == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            yield field_num, buf[pos:pos + length]
            pos += length
        elif wire_type == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field_num, val
        elif wire_type == 5:  # 32-bit
            yield field_num, buf[pos:pos + 4]
            pos += 4
        elif wire_type == 1:  # 64-bit
            yield field_num, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire_type}")


def _zigzag_to_int(v: int) -> int:
    # int64_list values are plain varints (two's complement for negatives,
    # encoded as 10-byte varints)
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def parse_example(record: bytes) -> Dict[str, Union[List[bytes], np.ndarray]]:
    """tf.train.Example bytes -> {name: list[bytes] | float32 array | int64 array}.

    Proto schema: Example{1: Features}, Features{1: map<string, Feature>},
    map entry {1: key, 2: Feature}, Feature{1: BytesList, 2: FloatList,
    3: Int64List}, each list field 1 repeated (floats/ints may be packed).
    """
    out: Dict[str, Union[List[bytes], np.ndarray]] = {}
    features_msg = None
    for fnum, val in _iter_fields(record):
        if fnum == 1:
            features_msg = val
    if features_msg is None:
        return out

    for fnum, entry in _iter_fields(features_msg):
        if fnum != 1:
            continue
        key = None
        feature_msg = None
        for efn, ev in _iter_fields(entry):
            if efn == 1:
                key = ev.decode("utf-8")
            elif efn == 2:
                feature_msg = ev
        if key is None or feature_msg is None:
            continue

        value: Union[List[bytes], np.ndarray, None] = None
        for kind, payload in _iter_fields(feature_msg):
            if kind == 1:  # BytesList
                value = [v for fn, v in _iter_fields(payload) if fn == 1]
            elif kind == 2:  # FloatList (packed or repeated 32-bit)
                floats: List[float] = []
                for fn, v in _iter_fields(payload):
                    if fn != 1:
                        continue
                    if isinstance(v, bytes):
                        if len(v) == 4:
                            floats.append(struct.unpack("<f", v)[0])
                        else:  # packed
                            floats.extend(np.frombuffer(v, dtype="<f4").tolist())
                value = np.asarray(floats, dtype=np.float32)
            elif kind == 3:  # Int64List (packed or repeated varint)
                ints: List[int] = []
                for fn, v in _iter_fields(payload):
                    if fn != 1:
                        continue
                    if isinstance(v, bytes):  # packed varints
                        pos = 0
                        while pos < len(v):
                            x, pos = _read_varint(v, pos)
                            ints.append(_zigzag_to_int(x))
                    else:
                        ints.append(_zigzag_to_int(v))
                value = np.asarray(ints, dtype=np.int64)
        if value is not None:
            out[key] = value
    return out


# --------------------------------------------------------------------------
# encoding (tests + dataset creation)
# --------------------------------------------------------------------------


def _field(field_num: int, wire_type: int, payload: bytes) -> bytes:
    return _write_varint((field_num << 3) | wire_type) + payload


def _len_delim(field_num: int, payload: bytes) -> bytes:
    return _field(field_num, 2, _write_varint(len(payload)) + payload)


def bytes_feature(values: Sequence[bytes]) -> bytes:
    inner = b"".join(_len_delim(1, v) for v in values)
    return _len_delim(1, inner)


def float_feature(values: Sequence[float]) -> bytes:
    packed = np.asarray(values, dtype="<f4").tobytes()
    inner = _len_delim(1, packed)
    return _len_delim(2, inner)


def int64_feature(values: Sequence[int]) -> bytes:
    payload = bytearray()
    for v in values:
        if v < 0:
            v += 1 << 64
        payload += _write_varint(v)
    inner = _len_delim(1, bytes(payload))
    return _len_delim(3, inner)


def encode_example(features: Dict[str, bytes]) -> bytes:
    """{name: encoded Feature (from *_feature above)} -> Example bytes."""
    entries = b"".join(
        _len_delim(1, _len_delim(1, k.encode("utf-8")) + _field(2, 2, _write_varint(len(v)) + v))
        for k, v in sorted(features.items()))
    return _len_delim(1, entries)
