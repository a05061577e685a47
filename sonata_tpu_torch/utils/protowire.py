"""Minimal protobuf wire-format codec.

The environment has grpcio but no protoc Python plugin or ``onnx``/
``protobuf`` runtime, so the framework carries its own ~200-line wire codec:
enough of proto3 (varint / 64-bit / length-delimited / 32-bit fields,
packed repeats, maps-as-entry-messages) for the ONNX weight reader
(:mod:`sonata_tpu_torch.models.import_onnx`) and, later, the gRPC message
surface.

Declarative usage::

    class Version(Message):
        FIELDS = {"version": Field(1, "string")}

    data = Version(version="1.0").encode()
    msg  = Version.decode(data)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Iterator, Optional

WIRE_VARINT = 0
WIRE_64BIT = 1
WIRE_LEN = 2
WIRE_32BIT = 5

_KIND_WIRE = {
    "string": WIRE_LEN, "bytes": WIRE_LEN, "message": WIRE_LEN,
    "map_int64_string": WIRE_LEN,
    "uint32": WIRE_VARINT, "uint64": WIRE_VARINT, "int64": WIRE_VARINT,
    "int32": WIRE_VARINT, "bool": WIRE_VARINT, "enum": WIRE_VARINT,
    "float": WIRE_32BIT, "double": WIRE_64BIT,
}


class WireError(ValueError):
    pass


def read_varint(buf, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise WireError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise WireError("malformed varint")


def write_varint(n: int) -> bytes:
    # Two's-complement 64-bit mask: negative ints (int64 map keys, enums)
    # must encode as their 10-byte varint form, and an unmasked negative
    # Python int never reaches 0 under >>= 7.
    n &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def iter_fields(buf) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, raw value) over a message buffer.

    Length-delimited values are yielded as zero-copy memoryview slices —
    important for the ONNX reader, where a voice file is ~100 MB and copies
    per tensor would spike memory at load.
    """
    pos = 0
    mv = memoryview(buf)
    while pos < len(mv):
        key, pos = read_varint(mv, pos)
        field, wire = key >> 3, key & 0x7
        if wire == WIRE_VARINT:
            value, pos = read_varint(mv, pos)
        elif wire == WIRE_64BIT:
            if pos + 8 > len(mv):
                raise WireError("truncated 64-bit field")
            value = mv[pos:pos + 8]
            pos += 8
        elif wire == WIRE_LEN:
            n, pos = read_varint(mv, pos)
            if pos + n > len(mv):
                raise WireError("truncated length-delimited field")
            value = mv[pos:pos + n]
            pos += n
        elif wire == WIRE_32BIT:
            if pos + 4 > len(mv):
                raise WireError("truncated 32-bit field")
            value = mv[pos:pos + 4]
            pos += 4
        else:
            raise WireError(f"unsupported wire type {wire}")
        yield field, wire, value


def _encode_value(num: int, kind: str, value, submsg) -> bytes:
    key = write_varint((num << 3) | _KIND_WIRE[kind])
    if kind == "string":
        payload = value.encode("utf-8")
        return key + write_varint(len(payload)) + payload
    if kind == "bytes":
        return key + write_varint(len(value)) + value
    if kind == "message":
        payload = value.encode()
        return key + write_varint(len(payload)) + payload
    if kind in ("uint32", "uint64", "int64", "int32", "enum"):
        return key + write_varint(int(value) & 0xFFFFFFFFFFFFFFFF)
    if kind == "bool":
        return key + write_varint(1 if value else 0)
    if kind == "float":
        return key + struct.pack("<f", float(value))
    if kind == "double":
        return key + struct.pack("<d", float(value))
    if kind == "map_int64_string":
        out = b""
        for k, v in value.items():
            entry = (write_varint((1 << 3) | WIRE_VARINT) + write_varint(int(k))
                     + write_varint((2 << 3) | WIRE_LEN)
                     + write_varint(len(v.encode())) + v.encode())
            out += key + write_varint(len(entry)) + entry
        return out
    raise WireError(f"unknown kind {kind}")


def _decode_value(kind: str, wire: int, raw, submsg):
    if kind == "string":
        return bytes(raw).decode("utf-8", errors="replace")
    if kind == "bytes":
        return bytes(raw)
    if kind == "message":
        return submsg.decode(raw)
    if kind in ("int64", "int32"):
        value = int(raw)
        # proto varints are two's-complement 64-bit: sign-extend negatives
        return value - (1 << 64) if value >= (1 << 63) else value
    if kind in ("uint32", "uint64", "enum"):
        return int(raw)
    if kind == "bool":
        return bool(raw)
    if kind == "float":
        return struct.unpack("<f", raw)[0]
    if kind == "double":
        return struct.unpack("<d", raw)[0]
    if kind == "map_int64_string":
        k = v = None
        for f, w, val in iter_fields(raw):
            if f == 1 and w == WIRE_VARINT:
                k = int(val)
                if k >= (1 << 63):
                    k -= 1 << 64
            elif f == 2 and w == WIRE_LEN:
                v = bytes(val).decode("utf-8", errors="replace")
        return (k, v)
    raise WireError(f"unknown kind {kind}")


def _decode_packed(kind: str, raw, submsg) -> list:
    """Decode a packed repeated scalar payload."""
    out = []
    expected = _KIND_WIRE[kind]
    if expected == WIRE_VARINT:
        mv = memoryview(raw)
        pos = 0
        while pos < len(mv):
            v, pos = read_varint(mv, pos)
            out.append(_decode_value(kind, WIRE_VARINT, v, submsg))
    else:
        width = 4 if expected == WIRE_32BIT else 8
        mv = memoryview(raw)
        if len(mv) % width:
            raise WireError("truncated packed fixed-width payload")
        for i in range(0, len(mv), width):
            out.append(_decode_value(kind, expected, mv[i:i + width],
                                     submsg))
    return out


@dataclass(frozen=True)
class Field:
    num: int
    kind: str
    message: Optional[type] = None  # for kind == "message"
    repeated: bool = False


class Message:
    """Base for declarative wire messages: subclass and define ``FIELDS``."""

    FIELDS: dict[str, Field] = {}

    def __init__(self, **kwargs):
        for name in self.FIELDS:
            f = self.FIELDS[name]
            default = [] if f.repeated else ({} if f.kind ==
                                             "map_int64_string" else None)
            setattr(self, name, kwargs.pop(name, default))
        if kwargs:
            raise TypeError(f"unknown fields: {sorted(kwargs)}")

    def encode(self) -> bytes:
        out = b""
        for name, f in self.FIELDS.items():
            value = getattr(self, name)
            if value is None:
                continue
            if f.repeated:
                for item in value:
                    out += _encode_value(f.num, f.kind, item, f.message)
            elif f.kind == "map_int64_string":
                if value:
                    out += _encode_value(f.num, f.kind, value, f.message)
            else:
                out += _encode_value(f.num, f.kind, value, f.message)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "Message":
        by_num = {f.num: (name, f) for name, f in cls.FIELDS.items()}
        msg = cls()
        for num, wire, raw in iter_fields(data):
            entry = by_num.get(num)
            if entry is None:
                continue  # unknown field: skip (proto3 semantics)
            name, f = entry
            expected = _KIND_WIRE[f.kind]
            if wire != expected:
                if (f.repeated and wire == WIRE_LEN
                        and expected in (WIRE_VARINT, WIRE_32BIT,
                                         WIRE_64BIT)):
                    # packed repeated scalars (proto3 writers pack by
                    # default)
                    getattr(msg, name).extend(
                        _decode_packed(f.kind, raw, f.message))
                # else: wire-type mismatch (malformed or incompatible
                # writer) — treat like an unknown field, don't crash mid-RPC
                continue
            value = _decode_value(f.kind, wire, raw, f.message)
            if f.repeated:
                getattr(msg, name).append(value)
            elif f.kind == "map_int64_string":
                k, v = value
                getattr(msg, name)[k] = v
            else:
                setattr(msg, name, value)
        return msg

    def __repr__(self):
        fields = ", ".join(f"{n}={getattr(self, n)!r}" for n in self.FIELDS
                           if getattr(self, n) not in (None, [], {}))
        return f"{type(self).__name__}({fields})"

    def __eq__(self, other):
        return (type(self) is type(other)
                and all(getattr(self, n) == getattr(other, n)
                        for n in self.FIELDS))
