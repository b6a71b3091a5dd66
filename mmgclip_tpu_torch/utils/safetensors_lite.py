"""Reader for the ``model.safetensors`` files of HF snapshots.

The weight converters fall back to ``model.safetensors`` when a snapshot has
no ``pytorch_model.bin`` (the JAX converters read it through
``safetensors.torch.load_file``, a package the card's machine is not assumed
to have).  The format: an 8-byte little-endian header length ``n``, ``n``
bytes of JSON mapping each tensor name to ``{"dtype", "shape",
"data_offsets": [begin, end]}`` (offsets into the data block that follows
the header; the optional ``"__metadata__"`` entry holds strings), then the
raw little-endian C-order bytes.  ``load_file`` returns the same tensors as
``safetensors.torch.load_file``.
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """``model.safetensors`` -> {name: CPU tensor}, in the header's order."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n:]
    out: Dict[str, torch.Tensor] = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        if entry["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype {entry['dtype']}")
        dtype = _DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        shape = [int(s) for s in entry["shape"]]
        count = 1
        for s in shape:
            count *= s
        if not 0 <= begin <= end <= len(body) or end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: {name} offsets {begin}:{end} do not hold "
                             f"{shape} of {entry['dtype']}")
        raw = bytearray(body[begin:end])  # a writable copy: the tensor owns its bytes
        flat = torch.frombuffer(raw, dtype=dtype) if count else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(shape)
    return out
