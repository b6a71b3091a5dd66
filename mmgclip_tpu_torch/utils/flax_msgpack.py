"""Reader and writer for flax's msgpack serialization
(``flax.serialization.to_bytes``).

The JAX package stores parameter trees as flax msgpack bytes: the converted
tower weights and the ``params`` of its checkpoints.  The card's machine has
neither flax nor msgpack, so the port decodes the format itself: a msgpack
map of string keys whose array leaves are ExtType 1 records, each itself a
msgpack ``[shape, dtype name, raw C-order bytes]``; numpy scalars are
ExtType 3 records of the same form with shape ``[]``.  Arrays come back as
numpy arrays (``bfloat16`` leaves widened exactly to float32).  ``to_bytes``
writes the same bytes flax writes for a tree of numpy arrays, so the JAX
package reads the port's checkpoints.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype(np.uint16)  # widened to float32 by _array
    return np.dtype(name)


def _array(buf: bytes, dtype_name: str, shape) -> np.ndarray:
    arr = np.frombuffer(buf, dtype=_dtype(dtype_name)).reshape(tuple(shape)).copy()
    if dtype_name == "bfloat16":
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        shape, dtype_name, raw = unpackb(data)
        return _array(raw, dtype_name, shape)
    if code == _EXT_NPSCALAR:
        shape, dtype_name, raw = unpackb(data)
        return _array(raw, dtype_name, shape)[()]
    if code == _EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    raise ValueError(f"unknown flax msgpack ext type {code}")


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Tuple:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))

    def ext(self, n: int) -> Any:
        (code,) = self.unpack("b")
        data = self.take(n)
        return _ext(code, data)

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # marker -> (length format, kind)
            0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
            0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
            0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
            0xDC: ("H", "array"), 0xDD: ("I", "array"),
            0xDE: ("H", "map"), 0xDF: ("I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            (n,) = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "ext":
                return self.ext(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map(n)
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])[0]
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"invalid msgpack marker 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object; flax ext records become numpy values."""
    reader = _Reader(bytes(data))
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def from_bytes(data: bytes) -> Any:
    """flax ``serialization.to_bytes`` output -> nested dict of numpy arrays."""
    tree = unpackb(data)
    _reject_chunked(tree)
    return tree


def _reject_chunked(node: Any) -> None:
    if isinstance(node, dict):
        if "__msgpack_chunked_array__" in node:
            raise NotImplementedError(
                "flax chunked arrays (leaves over 1 GiB) are not read by the port")
        for value in node.values():
            _reject_chunked(value)


def read_file(path: str) -> Any:
    with open(path, "rb") as fh:
        return from_bytes(fh.read())


# ----------------------------------------------------------------------
# writer: the bytes msgpack-python writes for flax (smallest encodings)

def _sized(out: bytearray, n: int, fix: Tuple[int, int], markers: Tuple[int, ...]) -> None:
    """A length header: the fix form when ``n < fix[1]``, else the 8/16/32-bit
    marker (``markers`` lists them from the smallest; 0 where a width has none)."""
    if fix[0] is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for marker, fmt in zip(markers, ("B", "H", "I")):
        if marker and n < (1 << (8 * struct.calcsize(fmt))):
            out.append(marker)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(fixext[len(data)])
    else:
        _sized(out, len(data), (None, 0), (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _array_record(arr: np.ndarray) -> bytes:
    return packb([list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()])


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _array_record(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_record(np.asarray(obj)))
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj > 0:
            for marker, fmt in ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")):
                if obj < (1 << (8 * struct.calcsize(fmt))):
                    out.append(marker)
                    out += struct.pack(">" + fmt, obj)
                    return
            raise ValueError(f"integer {obj} too large for msgpack")
        else:
            for marker, fmt in ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q")):
                if obj >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    out.append(marker)
                    out += struct.pack(">" + fmt, obj)
                    return
            raise ValueError(f"integer {obj} too small for msgpack")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _sized(out, len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _sized(out, len(obj), (None, 0), (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), (0x90, 16), (0, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _sized(out, len(obj), (0x80, 16), (0, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode one object; numpy arrays and scalars become flax ext records."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def to_bytes(tree: Any) -> bytes:
    """Nested dict of numpy arrays -> the bytes ``flax.serialization.to_bytes``
    writes for the same tree as a jax pytree (keys as strings, sorted)."""
    def state_dict(node):  # keys as strings, in sorted order as jax trees hold them
        if isinstance(node, dict):
            return {str(k): state_dict(node[k]) for k in sorted(node, key=str)}
        return node

    return packb(state_dict(tree))
