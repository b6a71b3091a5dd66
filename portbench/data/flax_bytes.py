"""The flax msgpack bytes the port reads weights from
(``networks.image_encoder.convnext_tiny_clf_path``,
``networks.text_encoder.weights_path``, a checkpoint's ``params``).

A frozen copy of the writer half of ``mmgclip_tpu_torch/utils/flax_msgpack.py``
(the bytes ``flax.serialization.to_bytes`` writes), kept here so that a
change to the program cannot change the files the benchmark hands it.
Arrays may be float32, or ``Bf16`` for bfloat16 values (their 16 high bits,
which the reader widens to float32).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class Bf16:
    """bfloat16 values held as their uint16 bit patterns."""

    def __init__(self, bits: np.ndarray):
        self.bits = np.asarray(bits, np.uint16)


def _sized(out: bytearray, n: int, fix, markers) -> None:
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


def _record(shape, dtype_name: str, data: bytes) -> bytes:
    out = bytearray()
    _pack([list(shape), dtype_name, data], out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, Bf16):
        _pack_ext(out, _EXT_NDARRAY, _record(obj.bits.shape, "bfloat16", obj.bits.tobytes()))
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _record(obj.shape, obj.dtype.name, obj.tobytes()))
    elif isinstance(obj, np.generic):
        arr = np.asarray(obj)
        _pack_ext(out, _EXT_NPSCALAR, _record(arr.shape, arr.dtype.name, arr.tobytes()))
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            out.append(obj)
        elif obj > 0:
            for marker, fmt in ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")):
                if obj < (1 << (8 * struct.calcsize(fmt))):
                    out.append(marker)
                    out += struct.pack(">" + fmt, obj)
                    return
            raise ValueError(f"integer {obj} too large for msgpack")
        else:
            raise ValueError("negative integers are not written by this writer")
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


def to_bytes(tree: Any) -> bytes:
    """Nested dict of arrays -> flax bytes (keys as strings, sorted)."""
    def ordered(node):
        if isinstance(node, dict):
            return {str(k): ordered(node[k]) for k in sorted(node, key=str)}
        return node

    out = bytearray()
    _pack(ordered(tree), out)
    return bytes(out)


def write(path: str, tree: Any) -> int:
    data = to_bytes(tree)
    with open(path, "wb") as fh:
        fh.write(data)
    return len(data)
