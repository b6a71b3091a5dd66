"""The port's multi-process rehearsals (``mmgclip_tpu_torch/parallel/
multihost.py``), as the JAX package's ``tests/test_multihost.py`` runs its
own: fresh CPU processes joined by gloo, each loading only its own rows,
against the single-process oracle from the same seed, to the JAX bounds.

Measured on this machine (CPU): ``mh_err`` 9.54e-07 at 2 and 4 processes
(the JAX rehearsal's MULTICHIP_r05 value is the same), ``pg_err`` 0,
``mh_exp_err`` 3.97e-07 for the plain data-parallel epoch.
"""

import pytest

from mmgclip_tpu_torch.parallel import multihost


@pytest.mark.parametrize("n_processes", [2, 4])
def test_global_step_matches_single_process_oracle(n_processes):
    err = multihost.run_multihost_dryrun(n_processes)
    assert err < 1e-5, err


def test_put_global_tiles_every_spec_family():
    """Replicated, batch over ``data``, a leading ``model`` axis, ``data`` at
    dim > 0 (ZeRO-1 moments) and a combined ``(data, model)`` axis."""
    assert multihost.run_put_global_dryrun(4) == 0.0


def test_real_experiment_matches_single_process():
    """One epoch of the product trainer over 2 processes equals one process
    (loss and every parameter), and a checkpoint round trip on every rank
    leaves the params unchanged."""
    err = multihost.run_multihost_experiment_dryrun(2)
    assert err < 1e-4, err


def test_backend_choice_and_torchrun_environment(monkeypatch):
    import torch

    assert multihost.choose_backend("cpu", 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    # two ranks on one card: NCCL refuses duplicate devices, so gloo
    assert multihost.choose_backend(None, 2) == "gloo"
    seen = {}

    def fake_init(backend, init_method, world_size, rank, timeout):
        seen.update(backend=backend, init_method=init_method, world_size=world_size, rank=rank)

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    monkeypatch.setattr(torch.cuda, "set_device", lambda index: seen.setdefault("device", index))
    for key, value in {"RANK": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
                       "MASTER_PORT": "29511", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(key, value)
    assert multihost.initialize_distributed() == "gloo"
    assert seen == {"backend": "gloo", "init_method": "tcp://localhost:29511", "world_size": 2,
                    "rank": 1, "device": 0}


def test_a_failing_rank_fails_the_launch_and_kills_the_rest():
    import time

    def code(rank):
        return "import sys, time\n" + ("sys.exit(3)\n" if rank == 1 else "time.sleep(60)\n")

    start = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed rc=3"):
        multihost.spawn(code, 2, 30, "never=")
    assert time.monotonic() - start < 20


def test_a_hanging_rank_times_out():
    with pytest.raises(RuntimeError, match="timed out after 2"):
        multihost.spawn(lambda rank: "import time\ntime.sleep(60)\n", 2, 2, "never=")
