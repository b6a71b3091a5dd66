"""Device-side image resize as two matrix products (port of
mmgclip_tpu/ops/resize.py).

A separable 2-D resample is ``y = R_h @ x @ R_w^T`` with ``R_h [H_out, H_in]``
and ``R_w [W_out, W_in]`` holding the 1-D weights, which are numpy constants
of the shape pair (``area``: box integration over fractional cells, the
anti-aliased choice for mammography's large downscales; ``bilinear``:
half-pixel centres).  The products lie outside any kernel of the JAX package
(XLA ran them), so here they are ``torch.matmul``.

Precision (``dataset.config.encode_resize_precision``):

* ``None`` ("default"): bf16 operands with fp32 accumulation, the TPU's
  single matrix-unit pass.  Computed as an fp32 product of operands rounded
  to bf16, which is exact for any fp32 or TF32 accumulation (a product of two
  bf16 values fits fp32's and TF32's mantissa), so it is the same number on
  every device.
* ``"highest"``: fp32 operands and accumulation; on the card this needs
  TF32 off for matmuls (PyTorch's default), and raises otherwise.

The weight builders and the host block sum are the JAX package's, copied.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """[n_out, n_in] float32 resampling matrix; rows sum to 1."""
    if method == "area":
        # output cell i integrates input interval [i*s, (i+1)*s), s = in/out
        s = n_in / n_out
        w = np.zeros((n_out, n_in), np.float32)
        for i in range(n_out):
            lo, hi = i * s, (i + 1) * s
            j0, j1 = int(np.floor(lo)), int(np.ceil(hi))
            for j in range(j0, min(j1, n_in)):
                w[i, j] = (min(j + 1, hi) - max(j, lo)) / s
        return w
    if method == "bilinear":
        # half-pixel centers (jax.image "linear" / torch align_corners=False)
        s = n_in / n_out
        w = np.zeros((n_out, n_in), np.float32)
        for i in range(n_out):
            c = (i + 0.5) * s - 0.5
            j0 = int(np.floor(c))
            f = c - j0
            w[i, min(max(j0, 0), n_in - 1)] += 1.0 - f
            w[i, min(max(j0 + 1, 0), n_in - 1)] += f
        return w
    raise ValueError(f"resize method must be 'area' or 'bilinear', got {method!r}")


@functools.lru_cache(maxsize=256)
def _block_sum_weights(n_in: int, n_out: int, k: int, method: str) -> np.ndarray:
    """[n_out, ceil(n_in/k)] float32 weights that resample integer k-block
    SUMS directly: the per-pixel resample matrix with its columns aggregated
    per block, divided by each block's TRUE pixel count (partial edge blocks
    included)."""
    w = _resize_weights(n_in, n_out, method)
    nb = -(-n_in // k)
    wp = np.zeros((n_out, nb * k), np.float32)
    wp[:, :n_in] = w
    wb = wp.reshape(n_out, nb, k).sum(-1)
    counts = np.full(nb, float(k), np.float32)
    counts[-1] = n_in - k * (nb - 1)
    return wb / counts


def host_block_sum(pixels: np.ndarray, k: int) -> np.ndarray:
    """[..., H, W] uint8/uint16 -> [..., ceil(H/k), ceil(W/k)] EXACT integer
    k x k block sums (the host half of ``encode_host_prepool``; partial edge
    blocks are zero-padded).  uint8 sums into uint16 (k <= 16: 16^2 * 255
    fits), uint16 into uint32."""
    if pixels.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"host_block_sum expects uint8/uint16 pixels, got {pixels.dtype}")
    if not 2 <= int(k) <= 16:
        raise ValueError(f"prepool block must be in [2, 16], got {k}")
    out_dtype = np.uint16 if pixels.dtype == np.uint8 else np.uint32
    *lead, h, w = pixels.shape
    hb, wb = -(-h // k), -(-w // k)
    pad = [(0, 0)] * len(lead) + [(0, hb * k - h), (0, wb * k - w)]
    x = np.pad(pixels, pad).astype(out_dtype)
    return x.reshape(*lead, hb, k, wb, k).sum(axis=(-3, -1), dtype=out_dtype)


def fit_shape(in_hw: Tuple[int, int], canvas_hw: Tuple[int, int]) -> Tuple[int, int]:
    """Aspect-preserving fit of ``in_hw`` inside ``canvas_hw``."""
    h, w = int(in_hw[0]), int(in_hw[1])
    ch, cw = int(canvas_hw[0]), int(canvas_hw[1])
    scale = min(ch / h, cw / w)
    return max(1, min(ch, round(h * scale))), max(1, min(cw, round(w * scale)))


def _matmul(a: torch.Tensor, b: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """fp32 ``a @ b`` at the resize precision (see the module docstring)."""
    if precision is None:
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    if precision != "highest":
        raise ValueError(f"resize precision must be None or 'highest', got {precision!r}")
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("encode_resize_precision 'highest' needs fp32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is True")
    return a @ b


def _weights(w: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(w).to(like.device)


def _resample(x: torch.Tensor, rh: np.ndarray, rw: np.ndarray, precision) -> torch.Tensor:
    """[n, H, W] -> [n, H_out, W_out] fp32: rows, then columns."""
    y = _matmul(_weights(rh, x), x.float(), precision)          # [n, H_out, W]
    return _matmul(y, _weights(rw, x).T, precision)             # [n, H_out, W_out]


def resize2d(x: torch.Tensor, out_hw: Tuple[int, int], method: str = "area",
             dtype=torch.float32, precision: Optional[str] = None) -> torch.Tensor:
    """Resize [..., H, W] (or NHWC [n, H, W, C]) images to ``out_hw``;
    compute in fp32, cast to ``dtype`` on the way out."""
    nhwc = x.dim() == 4
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    *lead, h_in, w_in = x.shape
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    flat = x.reshape(-1, h_in, w_in)
    y = _resample(flat, _resize_weights(h_in, h_out, method),
                  _resize_weights(w_in, w_out, method), precision)
    y = y.reshape(*lead, h_out, w_out)
    if nhwc:
        y = y.permute(0, 2, 3, 1)
    return y.to(dtype)


def _to_canvas(y: torch.Tensor, canvas_hw: Tuple[int, int]):
    n, vh, vw = y.shape
    ch, cw = int(canvas_hw[0]), int(canvas_hw[1])
    y = torch.nn.functional.pad(y, (0, cw - vw, 0, ch - vh))
    valid_hw = torch.tensor([vh, vw], dtype=torch.int32, device=y.device).expand(n, 2)
    return y, valid_hw


def resize_to_canvas(x: torch.Tensor, canvas_hw: Tuple[int, int], method: str = "area",
                     dtype=torch.float32, precision: Optional[str] = None):
    """Aspect-preserving resize of [n, H, W] images onto a fixed canvas,
    top-left, zeros elsewhere (the masked tower's convention).  Returns
    ``(canvas [n, ch, cw], valid_hw [n, 2] int32)``."""
    vh, vw = fit_shape(x.shape[1:3], canvas_hw)
    return _to_canvas(resize2d(x, (vh, vw), method=method, dtype=dtype, precision=precision),
                      canvas_hw)


def resize_to_canvas_from_block_sums(sums: torch.Tensor, native_hw: Tuple[int, int],
                                     canvas_hw: Tuple[int, int], k: int, method: str = "area",
                                     dtype=torch.float32, precision: Optional[str] = None):
    """Device half of the prepooled chain: [n, Hb, Wb] integer block sums
    (``host_block_sum``) -> the aspect-preserving resample of the block-mean
    image onto the canvas, in source intensity units; same convention and
    ``valid_hw`` as ``resize_to_canvas``."""
    h, w = int(native_hw[0]), int(native_hw[1])
    vh, vw = fit_shape((h, w), canvas_hw)
    y = _resample(sums, _block_sum_weights(h, vh, int(k), method),
                  _block_sum_weights(w, vw, int(k), method), precision)
    return _to_canvas(y.to(dtype), canvas_hw)
