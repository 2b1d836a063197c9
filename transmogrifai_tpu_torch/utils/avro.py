"""Minimal pure-Python Avro Object Container File reader.

Replaces the reference's Avro ingestion dependency (readers/.../
CSVAutoReaders.scala, utils/.../io/avro/AvroInOut.scala) for environments
without an avro wheel. Supports the container format (magic Obj\\x01, file
metadata, sync-marked blocks; null/deflate codecs) and the datum types the
reference's record schemas use: primitives, records, enums, fixed, arrays,
maps, and unions. Schema evolution/resolution is out of scope — files are
read with their writer schema.
"""
from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Any, BinaryIO, Iterator

import numpy as np

_MAGIC = b"Obj\x01"


class AvroError(ValueError):
    pass


def _snappy_uncompress(data: bytes) -> bytes:
    """Minimal pure-Python raw-Snappy decompressor (no snappy wheel in the
    image; Avro's snappy codec frames each block as raw snappy + 4-byte
    big-endian CRC32 of the plaintext). Format: varint plaintext length,
    then tagged elements — 00 literal, 01/10/11 back-references."""
    # preamble: uncompressed length varint
    n = 0
    shift = 0
    i = 0
    while True:
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    while i < len(data):
        tag = data[i]
        i += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                length = int.from_bytes(data[i:i + extra], "little")
                i += extra
            length += 1
            out += data[i:i + length]
            i += length
            continue
        if kind == 1:  # copy with 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | data[i]
            i += 1
        elif kind == 2:  # copy with 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[i:i + 2], "little")
            i += 2
        else:  # copy with 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[i:i + 4], "little")
            i += 4
        if offset == 0 or offset > len(out):
            raise AvroError("corrupt snappy stream (bad offset)")
        start = len(out) - offset
        for k in range(length):  # overlapping copies are byte-sequential
            out.append(out[start + k])
    if len(out) != n:
        raise AvroError("corrupt snappy stream (length mismatch)")
    return bytes(out)


def _read_long(fh: BinaryIO, first: bytes | None = None) -> int:
    """Zig-zag varint (Avro long); ``first`` is an already-consumed byte."""
    shift = 0
    acc = 0
    while True:
        b = first if first is not None else fh.read(1)
        first = None
        if not b:
            raise AvroError("unexpected EOF in varint")
        v = b[0]
        acc |= (v & 0x7F) << shift
        if not v & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _read_bytes(fh: BinaryIO) -> bytes:
    n = _read_long(fh)
    data = fh.read(n)
    if len(data) != n:
        raise AvroError("unexpected EOF in bytes")
    return data


def _read_datum(fh: BinaryIO, schema: Any) -> Any:
    if isinstance(schema, str):
        kind = schema
    elif isinstance(schema, list):
        # union: long index then the selected branch
        idx = _read_long(fh)
        if not 0 <= idx < len(schema):
            raise AvroError(f"union index {idx} out of range")
        return _read_datum(fh, schema[idx])
    else:
        kind = schema["type"]

    if kind == "null":
        return None
    if kind == "boolean":
        b = fh.read(1)
        if not b:
            raise AvroError("unexpected EOF in boolean")
        return b[0] != 0
    if kind in ("int", "long"):
        return _read_long(fh)
    if kind == "float":
        return struct.unpack("<f", fh.read(4))[0]
    if kind == "double":
        return struct.unpack("<d", fh.read(8))[0]
    if kind == "bytes":
        return _read_bytes(fh)
    if kind == "string":
        return _read_bytes(fh).decode("utf-8")
    if kind == "record":
        return {
            f["name"]: _read_datum(fh, f["type"]) for f in schema["fields"]
        }
    if kind == "enum":
        idx = _read_long(fh)
        symbols = schema["symbols"]
        if not 0 <= idx < len(symbols):
            raise AvroError(f"enum index {idx} out of range")
        return symbols[idx]
    if kind == "fixed":
        size = schema["size"]
        data = fh.read(size)
        if len(data) != size:
            raise AvroError(
                f"truncated fixed: wanted {size} bytes, got {len(data)}"
            )
        return data
    if kind == "array":
        out = []
        while True:
            n = _read_long(fh)
            if n == 0:
                break
            if n < 0:  # block with byte size prefix
                n = -n
                _read_long(fh)
            for _ in range(n):
                out.append(_read_datum(fh, schema["items"]))
        return out
    if kind == "map":
        out = {}
        while True:
            n = _read_long(fh)
            if n == 0:
                break
            if n < 0:
                n = -n
                _read_long(fh)
            for _ in range(n):
                key = _read_bytes(fh).decode("utf-8")
                out[key] = _read_datum(fh, schema["values"])
        return out
    raise AvroError(f"unsupported Avro type: {kind!r}")


def read_container(fh: BinaryIO) -> Iterator[Any]:
    """Yield datums from an Avro Object Container File."""
    if fh.read(4) != _MAGIC:
        raise AvroError("not an Avro container file (bad magic)")
    meta: dict[str, bytes] = {}
    while True:
        n = _read_long(fh)
        if n == 0:
            break
        if n < 0:
            n = -n
            _read_long(fh)
        for _ in range(n):
            key = _read_bytes(fh).decode("utf-8")
            meta[key] = _read_bytes(fh)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    if codec not in ("null", "deflate", "snappy"):
        raise AvroError(f"unsupported codec: {codec}")
    sync = fh.read(16)
    while True:
        head = fh.read(1)
        if not head:
            return
        count = _read_long(fh, first=head)
        size = _read_long(fh)
        data = fh.read(size)
        if len(data) != size:
            raise AvroError("unexpected EOF in block")
        if codec == "deflate":
            data = zlib.decompress(data, -15)
        elif codec == "snappy":
            plain = _snappy_uncompress(data[:-4])
            crc = int.from_bytes(data[-4:], "big")
            if zlib.crc32(plain) & 0xFFFFFFFF != crc:
                raise AvroError("snappy block CRC mismatch")
            data = plain
        block = io.BytesIO(data)
        for _ in range(count):
            yield _read_datum(block, schema)
        marker = fh.read(16)
        if marker != sync:
            raise AvroError("sync marker mismatch (corrupt block)")


def read_avro(path: str) -> list[Any]:
    with open(path, "rb") as fh:
        return list(read_container(fh))


# ---------------------------------------------------------------------------
# writer (tests + fixture generation; null codec only)
# ---------------------------------------------------------------------------
def _write_long(out: BinaryIO, v: int) -> None:
    v = (v << 1) ^ (v >> 63)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def _write_bytes(out: BinaryIO, data: bytes) -> None:
    _write_long(out, len(data))
    out.write(data)


def _branch_accepts(kind: str, v: Any, strict: bool) -> bool:
    """Does a union branch of ``kind`` match the value's type? numbers.ABCs
    cover numpy scalars (np.float32 is Real, np.int64 is Integral)."""
    import numbers

    is_bool = isinstance(v, (bool, np.bool_))
    if kind == "boolean":
        return is_bool
    if kind in ("int", "long"):
        return not is_bool and isinstance(v, numbers.Integral)
    if kind in ("float", "double"):
        if is_bool:
            return False
        if isinstance(v, numbers.Real) and not isinstance(v, numbers.Integral):
            return True
        # relaxed pass: ints may encode as float/double
        return not strict and isinstance(v, numbers.Integral)
    if kind in ("string", "enum"):
        return isinstance(v, str)
    if kind in ("bytes", "fixed"):
        return isinstance(v, (bytes, bytearray))
    if kind in ("record", "map"):
        return isinstance(v, dict)
    if kind == "array":
        return isinstance(v, (list, tuple, np.ndarray))
    return not strict


def _write_datum(out: BinaryIO, schema: Any, v: Any) -> None:
    if isinstance(schema, list):
        # match the branch to the VALUE's type — picking the first
        # non-null branch mis-encodes multi-branch unions like
        # ["null","int","string"] for string values
        for i, branch in enumerate(schema):
            kind = branch if isinstance(branch, str) else branch["type"]
            if v is None and kind == "null":
                _write_long(out, i)
                return
        for strict in (True, False):
            for i, branch in enumerate(schema):
                kind = branch if isinstance(branch, str) else branch["type"]
                if v is None or kind == "null":
                    continue
                if _branch_accepts(kind, v, strict):
                    _write_long(out, i)
                    _write_datum(out, branch, v)
                    return
        raise AvroError(f"no matching union branch for {type(v).__name__}")
    kind = schema if isinstance(schema, str) else schema["type"]
    if kind == "null":
        return
    if kind == "boolean":
        out.write(b"\x01" if v else b"\x00")
    elif kind in ("int", "long"):
        _write_long(out, int(v))
    elif kind == "float":
        out.write(struct.pack("<f", float(v)))
    elif kind == "double":
        out.write(struct.pack("<d", float(v)))
    elif kind == "bytes":
        _write_bytes(out, v)
    elif kind == "string":
        _write_bytes(out, v.encode("utf-8"))
    elif kind == "record":
        for f in schema["fields"]:
            _write_datum(out, f["type"], v[f["name"]])
    elif kind == "enum":
        _write_long(out, schema["symbols"].index(v))
    elif kind == "array":
        if v:
            _write_long(out, len(v))
            for item in v:
                _write_datum(out, schema["items"], item)
        _write_long(out, 0)
    elif kind == "map":
        if v:
            _write_long(out, len(v))
            for k, item in v.items():
                _write_bytes(out, k.encode("utf-8"))
                _write_datum(out, schema["values"], item)
        _write_long(out, 0)
    else:
        raise AvroError(f"unsupported Avro type: {kind!r}")


def write_avro(path: str, schema: dict, records: list[Any]) -> None:
    """Write an Avro container file (null codec) — used by tests and the
    CSV→Avro conversion path (CSVToAvro.scala equivalent)."""
    sync = b"\x00" * 8 + b"tptpusyn"
    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        meta = {
            "avro.schema": json.dumps(schema).encode(),
            "avro.codec": b"null",
        }
        _write_long(fh, len(meta))
        for k, v in meta.items():
            _write_bytes(fh, k.encode())
            _write_bytes(fh, v)
        _write_long(fh, 0)
        fh.write(sync)
        block = io.BytesIO()
        for r in records:
            _write_datum(block, schema, r)
        data = block.getvalue()
        _write_long(fh, len(records))
        _write_long(fh, len(data))
        fh.write(data)
        fh.write(sync)
