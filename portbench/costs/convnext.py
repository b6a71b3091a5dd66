"""ConvNeXt costs from shapes.

Operations are the counts of ``bench.py::_convnext_layer_costs`` (the JAX
bench's): per block at an [h, w] map of c channels, the pointwise products
``16 h w c^2``, the depthwise conv ``98 h w c``, the LayerNorm ``8 h w c``,
the GELU ``15 * 4 h w c`` and the layer scale and residual ``2 h w c``.
Bytes are the least a kernel must move: each input once, each output once,
each weight once per call, never a workspace or a re-read.

``image_flops`` is the model count an MFU divides by: two operations per
multiply-add of the stem, the depthwise and pointwise convs and the
downsamples; normalisation, activation and pooling are not counted.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

DEPTHS = (3, 3, 9, 3)
DIMS = (96, 192, 384, 768)


def stage_shapes(height: int, width: int, dims: Sequence[int] = DIMS) -> List[Tuple[int, int, int]]:
    """(h, w, c) of each stage's map: ceil(/4) after the stem, ceil(/2) after
    each downsample (edges are zero-padded up to the stride)."""
    h, w = -(-height // 4), -(-width // 4)
    out = []
    for s, c in enumerate(dims):
        if s > 0:
            h, w = -(-h // 2), -(-w // 2)
        out.append((h, w, c))
    return out


def block_ops(h: int, w: int, c: int) -> int:
    """Operations of one block on one image."""
    hw = h * w
    return 16 * hw * c * c + 98 * hw * c + 8 * hw * c + 15 * 4 * hw * c + 2 * hw * c


def block_weight_bytes(c: int, dtype_bytes: int = 2) -> int:
    """Depthwise kernel and bias, pointwise kernels and biases and the layer
    scale in the tower dtype; the LayerNorm affine in float32."""
    return (49 * c + c + 4 * c * c + 4 * c + 4 * c * c + c + c) * dtype_bytes + 2 * c * 4


def block_call(n: int, h: int, w: int, c: int, dtype_bytes: int = 2) -> Tuple[int, int]:
    """(operations, minimal bytes) of one block launch over n images: x read
    once, y written once, the weights read once."""
    return n * block_ops(h, w, c), 2 * n * h * w * c * dtype_bytes + block_weight_bytes(c, dtype_bytes)


def tower_block_calls(n: int, height: int, width: int, depths: Sequence[int] = DEPTHS,
                      dims: Sequence[int] = DIMS, dtype_bytes: int = 2):
    """[(operations, bytes)] of every block launch of one tower call."""
    calls = []
    for (h, w, c), depth in zip(stage_shapes(height, width, dims), depths):
        calls += [block_call(n, h, w, c, dtype_bytes)] * depth
    return calls


def image_macs(height: int, width: int, in_channels: int = 1, depths: Sequence[int] = DEPTHS,
               dims: Sequence[int] = DIMS) -> int:
    """Multiply-adds of the tower on one image (the head excluded)."""
    shapes = stage_shapes(height, width, dims)
    h0, w0, c0 = shapes[0]
    macs = h0 * w0 * 16 * in_channels * c0
    for s, ((h, w, c), depth) in enumerate(zip(shapes, depths)):
        if s > 0:
            macs += h * w * 4 * dims[s - 1] * c
        macs += depth * (49 * h * w * c + 8 * h * w * c * c)
    return macs


def image_flops(height: int, width: int, in_channels: int = 1) -> int:
    return 2 * image_macs(height, width, in_channels)
