"""ResNet-50 costs at the ablation's pseudo-image, from shapes.

A convolution counts only the taps that land on real input: at the
``[3, 1, D]`` pseudo-image a 3x3 conv does a 1x3 conv's work and the 7x7
stem a 1x7's.  Two operations a multiply-add; BatchNorm, ReLU and pooling
are not counted, nor is the recomputation of checkpointed blocks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _taps(n: int, k: int, s: int, p: int) -> int:
    """Sum over output positions of the kernel taps that fall inside [0, n)."""
    return sum(sum(1 for i in range(k) if 0 <= o * s - p + i < n) for o in range(_out(n, k, s, p)))


def convs(width: int = 768, height: int = 1, stage_sizes: Sequence[int] = (3, 4, 6, 3),
          base: int = 64) -> List[Tuple[str, int, int, int, int]]:
    """[(name, macs, out_h, out_w, stage)] of every conv of one sample, in
    order; stage 0 is the stem, 4 is ``layer4``."""
    out = []
    h, w = height, width

    def conv(name, cin, cout, k, s, p, stage):
        nonlocal h, w
        macs = cin * cout * _taps(h, k, s, p) * _taps(w, k, s, p)
        oh, ow = _out(h, k, s, p), _out(w, k, s, p)
        out.append((name, macs, oh, ow, stage))
        return oh, ow

    h, w = conv("conv1", 3, base, 7, 2, 3, 0)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # max pool
    cin = base
    for stage, blocks in enumerate(stage_sizes):
        f = base * 2 ** stage
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            h0, w0 = h, w
            name = f"layer{stage + 1}_block{b}"
            conv(name + ".conv1", cin, f, 1, 1, 0, stage + 1)
            h, w = conv(name + ".conv2", f, f, 3, stride, 1, stage + 1)
            conv(name + ".conv3", f, 4 * f, 1, 1, 0, stage + 1)
            if cin != 4 * f or stride != 1:
                h, w = h0, w0
                h, w = conv(name + ".down_conv", cin, 4 * f, 1, stride, 0, stage + 1)
            cin = 4 * f
    return out


def forward_flops(width: int = 768, stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> int:
    return 2 * sum(m for _n, m, *_r in convs(width, 1, stage_sizes))


def train_flops_per_sample(batch: int, width: int = 768, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                           text_dim: int = 768, projection_dim: int = 512) -> float:
    """One training step's model operations per sample: the whole tower
    forward, ``layer4``'s backward (weight gradients of every conv; input
    gradients of every conv but those that read ``layer4``'s input, which
    needs none), the linear heads (the image head's input gradient too, the
    text head's weight gradient only) and the [b, b] logits forward and
    backward."""
    fwd = backward = 0
    for name, macs, *_r, stage in convs(width, 1, stage_sizes):
        fwd += macs
        if stage == 4:
            backward += macs
            if not name.startswith("layer4_block0.conv1") and not name.startswith("layer4_block0.down"):
                backward += macs
    image_dim = 64 * 2 ** (len(stage_sizes) - 1) * 4
    heads = image_dim * projection_dim * 3 + text_dim * projection_dim * 2
    logits = 3 * batch * projection_dim  # per sample: forward and two gradients of [b, b]
    return 2.0 * (fwd + backward + heads + logits)
