"""Each cell's generator end to end at micro size on the CPU (the look for a
card skipped), then with the timed path broken underneath: every fault the
cell can have turns ``correct`` false against the cell's own limits."""

import pytest

from portbench import controls
from portbench.generators import train
from portbench.run import run_cell
from portbench.tests.micro import micro

CELLS = ["store.ffdm", "train.resnet50"]


def _correct(result):
    return all(c.ok for c in result.checks)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, tmp_path):
    ctx = micro(cell, tmp_path)
    result = run_cell(ctx)
    assert _correct(result), [(c.name, c.value, c.limit) for c in result.checks]
    assert result.attempted > 0 and result.failed == 0
    assert ctx.setup_s is not None and all(v > 0 for v in result.e2e.values())


@pytest.mark.parametrize("cell,fault", [("store.ffdm", "altered_answer"),
                                        ("train.resnet50", "half_batch")])
def test_a_fault_is_not_correct(cell, fault, tmp_path):
    ctx = micro(cell, tmp_path)
    numbers = controls.CONTROLS[fault](ctx)
    limits = dict(ctx.traffic["limits"])
    assert any(value > limits.get(name, 0.0) for name, value in numbers.items()), numbers


def test_a_step_that_leaves_the_state_unchanged_reads_one(tmp_path):
    import torch

    W = "image_projection.layer.kernel"
    ref = {"rows": [[0, 1]], "loss": [1.0], "grad": {W: torch.ones(3)},
           "grad_at_start": {W: torch.ones(3)},
           "start": {W: torch.zeros(3)}, "end": {W: torch.full((3,), 0.1)}}
    observed = {"rows": [[0, 1]], "first": 0, "loss": [1.0], "grad": {W: torch.ones(3)},
                "start": {W: torch.zeros(3)}, "end": {W: torch.zeros(3)}}
    numbers = train.compare(observed, ref, [W])
    assert numbers["change_norm_gap_max"] == pytest.approx(1.0)
    assert numbers["change_norm_gap_max"] > micro("train.resnet50", tmp_path).traffic["limits"][
        "change_norm_gap_max"]
