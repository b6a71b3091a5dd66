"""The frozen cost model."""

import pytest

from portbench.costs import convnext, resnet
from portbench.costs.peaks import peaks


def test_convnext_tiny_matches_the_published_count():
    # ConvNeXt-T, 3 channels at 224^2: 4.5 G multiply-adds (Liu et al. 2022, table 1)
    assert convnext.image_macs(224, 224, 3) == pytest.approx(4.5e9, rel=0.05)


def test_stage_shapes_round_up():
    assert convnext.stage_shapes(2294, 1914) == [(574, 479, 96), (287, 240, 192),
                                                 (144, 120, 384), (72, 60, 768)]


def test_block_bytes_count_each_input_and_output_once():
    ops, nbytes = convnext.block_call(2, 10, 10, 96)
    assert nbytes == 2 * 2 * 10 * 10 * 96 * 2 + convnext.block_weight_bytes(96)
    assert ops == 2 * convnext.block_ops(10, 10, 96)
    assert len(convnext.tower_block_calls(1, 64, 64)) == sum(convnext.DEPTHS)


def test_resnet_counts_only_real_taps():
    convs = {name: macs for name, macs, *_r in resnet.convs(768)}
    # a 3x3 conv on a one-row map does a 1x3 conv's work
    assert convs["layer1_block0.conv2"] == 64 * 64 * 3 * 192 - 64 * 64 * 2
    # the 7x7 stem: a 1x7 conv, less the taps that fall into the padding at both ends
    assert convs["conv1"] == 3 * 64 * (7 * 384 - 3 - 1 - 2)


def test_resnet50_full_image_count():
    total = sum(m for _n, m, *_r in resnet.convs(224, 224))
    assert total == pytest.approx(4.1e9, rel=0.05)


def test_training_flops_leave_out_recompute():
    fwd = resnet.forward_flops()
    per_sample = resnet.train_flops_per_sample(32)
    layer4 = 2 * sum(m for _n, m, *_r, stage in resnet.convs(768) if stage == 4)
    assert fwd + layer4 < per_sample < fwd + 2 * layer4 + 1e7


def test_peaks_of_the_card():
    h100 = peaks("NVIDIA H100 80GB HBM3")
    assert h100["bf16"] == 989e12 and h100["tf32"] == 495e12 and h100["fp32"] == 67e12
    assert peaks("some other card") is None
