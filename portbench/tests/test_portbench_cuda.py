"""On the card: each cell's control at the cell's own size fails the cell's
limits.  Run on a CUDA machine from the repository root:

    python -m pytest portbench/tests -m cuda -q
"""

import shutil

import pytest

from portbench import controls

CASES = [("store.ffdm", "int8", 2.0), ("train.resnet50", "reference_tf32", 2.0),
         ("train.resnet50", "half_batch", 2.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control,seconds", CASES)
def test_control_is_not_correct(cell, control, seconds):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ctx = controls.context(cell, 2 ** 31 + 77, seconds)
    try:
        numbers = controls.CONTROLS[control](ctx)
    finally:
        shutil.rmtree(ctx.workdir, ignore_errors=True)
    limits = ctx.traffic["limits"]
    assert any(value > limits.get(name, 0.0) for name, value in numbers.items()), numbers
