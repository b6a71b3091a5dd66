"""The trace reduction and the per-layer readers on synthetic readings."""

import pytest

from portbench import manifest
from portbench.costs.peaks import peaks
from portbench.run import load_reader
from portbench.tests.micro import ROOT
from portbench.trace import DeviceTrace, Spans, breakdown

H100 = peaks("NVIDIA H100 80GB HBM3")


def _trace():
    t = DeviceTrace()
    # two sessions: windows [0, 10] and [100, 120] (ns), kernels inside
    t.sessions = [([(0, 10)], [("k1", 1, 4), ("k2", 3, 6), ("k1", 8, 9)], 0.0),
                  ([(100, 120)], [("k1", 100, 110), ("copy", 115, 130)], 0.0)]
    return t


def test_reduce_sums_sessions_and_clips_to_windows():
    spans = Spans()
    spans.records = [("store.extract", 0.0, 5e-9)]
    r = _trace().reduce(spans)
    assert r["window_s"] == pytest.approx(30e-9)
    assert r["busy_s"] == pytest.approx((5 + 1 + 10 + 5) * 1e-9)
    assert r["kernel_s"]["k1"] == pytest.approx(14e-9)
    labels = sorted(r["idle_gaps"], key=lambda g: -g[1])
    assert labels[0] == ("between spans", pytest.approx(5e-9))
    assert ("store.extract", pytest.approx(1e-9)) in r["idle_gaps"]
    b = breakdown(r)
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) <= 10


def test_nothing_to_read_gives_nothing():
    assert DeviceTrace().reduce() is None
    for metric in manifest.load(ROOT)["per_layer"]:
        assert load_reader(metric["name"])({"trace": None, "peaks": None}) is None, metric["name"]


def test_idle_share_and_roofline_readers():
    r = _trace().reduce()
    idle = load_reader("device.idle_share.store")({"trace": r})
    assert idle == pytest.approx(100 * (30 - 21) / 30)
    roof = load_reader("fused_block_roofline")
    readings = {"trace": {"kernel_s": {"void dw_kernel<float>": 0.01, "ln_mlp_kernel<bf16>": 0.09,
                                       "ln_mlp_int8_kernel": 5.0}},
                "peaks": H100, "pass_counts": [4], "batch_size": 2, "image_hw": (64, 48),
                "depths": [3, 3, 9, 3], "dims": [96, 192, 384, 768], "block_launches": 36}
    value = roof(readings)
    assert 0 < value < 100
    assert roof(dict(readings, block_launches=35)) is None


def test_training_readers():
    r = {"epoch_device_ms": [100.0, 120.0], "epoch_steps": [10, 10], "samples": 640,
         "seconds": 0.22, "batch_size": 32, "tf32": False, "stage_sizes": [3, 4, 6, 3],
         "feature_dim": 768, "text_dim": 768, "projection_dim": 512, "peaks": H100, "trace": None}
    assert load_reader("training.step_ms.resnet50")(r) == pytest.approx(11.0)
    fp32 = load_reader("train.mfu")(r)
    assert fp32 == pytest.approx(load_reader("train.mfu")(dict(r, tf32=True)) * 495 / 67)
