"""The PNG row filters undone on the card (``csrc/png_unfilter.cu``), and the
plain PyTorch version.

``png_unfilter(rows, depth)`` takes a batch of filtered scanlines of
grayscale images, ``[n, h, 1 + w * depth // 8]`` uint8 (each row its filter
byte, then its filtered bytes, as ``ingest/png_reader.py::read_png_rows``
hands them over), and returns the ``[n, h, w]`` pixels: uint16 in native
byte order for ``depth`` 16, uint8 for 8, bit-equal to the host unfilter
(``csrc/png_unfilter.c``) followed by the reader's byte swap.  A CUDA tensor
launches the kernel; a CPU tensor runs ``plain_png_unfilter``.

The filter bytes must be 0-4: the reader checks them on the host before it
hands a file over (the kernel reads any other byte as None, the plain
version raises).  A row of zeros, filter byte included, gives zeros, so the
zero images that pad a batch need nothing of their own.

The plain version walks the kernel's wavefront: step s unfilters pixel
s - y of every row y of every image at once, h + w - 1 steps in all, each
byte from its left, up and up-left neighbours of the steps before.  No
gradient: the pixels are integers.
"""

from __future__ import annotations

import ctypes

import torch

from . import count_launch
from ._build import check, load_typed

_SOURCE = "png_unfilter.cu"
_I, _P = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {"mmg_png_unfilter_rows": [_P, _P, _I, _I, _I, _I, _P]}
_DTYPES = {8: torch.uint8, 16: torch.uint16}


def _geometry(rows: torch.Tensor, depth: int):
    """-> (n, h, w, bytes per pixel), after checking the batch's form."""
    if depth not in _DTYPES:
        raise ValueError(f"png_unfilter takes 8- or 16-bit grayscale rows, got depth {depth}")
    if rows.dim() != 3 or rows.dtype != torch.uint8:
        raise ValueError(f"rows must be [n, h, 1 + stride] uint8, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    n, h, pitch = rows.shape
    bpp = depth // 8
    if (pitch - 1) % bpp or pitch < 1 + bpp:
        raise ValueError(f"a {depth}-bit row of {pitch} bytes holds no whole pixels")
    return n, h, (pitch - 1) // bpp, bpp


def plain_png_unfilter(rows: torch.Tensor, depth: int) -> torch.Tensor:
    """[n, h, 1 + w * bpp] uint8 -> [n, h, w] (uint16 at 16 bits, else uint8)."""
    n, h, w, bpp = _geometry(rows, depth)
    kind = rows[:, :, 0].long()
    if n and h and int(kind.max()) > 4:
        raise ValueError(f"unknown PNG row filter {int(kind.max())}")
    data = rows[:, :, 1:].long().reshape(n, h, w, bpp)
    # a zero row and column in front: the neighbours of the first row and column
    out = torch.zeros(n, h + 1, w + 1, bpp, dtype=torch.long, device=rows.device)
    ys = torch.arange(h, device=rows.device)
    for s in range(h + w - 1):
        y = ys[(s - ys >= 0) & (s - ys < w)]
        x = s - y
        cur = data[:, y, x]
        a, b, c = out[:, y + 1, x], out[:, y, x + 1], out[:, y, x]
        pa, pb, pc = (b - c).abs(), (a - c).abs(), (a + b - 2 * c).abs()
        paeth = torch.where((pa <= pb) & (pa <= pc), a, torch.where(pb <= pc, b, c))
        k = kind[:, y, None]
        pred = torch.where(k == 1, a, torch.where(k == 2, b, torch.where(
            k == 3, (a + b) >> 1, torch.where(k == 4, paeth, torch.zeros_like(a)))))
        out[:, y + 1, x + 1] = (cur + pred) & 0xFF
    out = out[:, 1:, 1:]
    if bpp == 1:
        return out[..., 0].to(torch.uint8)
    return ((out[..., 0] << 8) | out[..., 1]).to(torch.int32).to(torch.uint16)


def launch_png_unfilter(rows: torch.Tensor, depth: int) -> torch.Tensor:
    """Launch the CUDA kernel (CUDA tensors only; raises on any failure)."""
    if not rows.is_cuda:
        raise ValueError("launch_png_unfilter needs CUDA tensors")
    n, h, w, bpp = _geometry(rows, depth)
    rows = rows.contiguous()
    out = torch.empty((n, h, w), dtype=_DTYPES[depth], device=rows.device)
    if out.numel() == 0:
        return out
    lib = load_typed(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        code = lib.mmg_png_unfilter_rows(rows.data_ptr(), out.data_ptr(), n, h, w, bpp, stream)
    check(lib, code, "png_unfilter")
    count_launch("png_unfilter")
    return out


def png_unfilter(rows: torch.Tensor, depth: int) -> torch.Tensor:
    """Filtered scanlines -> pixels.  CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version."""
    if rows.is_cuda:
        return launch_png_unfilter(rows, depth)
    return plain_png_unfilter(rows, depth)
