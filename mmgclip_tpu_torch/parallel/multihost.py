"""Several processes, one rank each (port of mmgclip_tpu/parallel/multihost.py).

The JAX package runs one process per host over a global mesh; the port runs
one process per rank (one per card in a node, or several sharing a card)
over ``torch.distributed``:

* ``initialize_distributed`` joins the process group.  Its arguments, or
  ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``, ``LOCAL_RANK``; a ``file://`` URL in ``MASTER_ADDR``
  names a rendezvous file instead of a port), say where and who, and
  ``torchrun_session`` wraps an entry point's body in that group; the backend is chosen
  explicitly and logged: ``nccl`` when every rank of the host has a card of
  its own, ``gloo`` when ranks share a card (NCCL refuses two ranks on one
  device) or run on the CPU.
* Every rank loads the same seeded data and keeps its own rows
  (``mesh.shard_batch``): no process needs another's rows.
* ``spawn`` runs N fresh processes on this machine, each with a wall-clock
  timeout; one failing kills the rest and the parent raises.

Three rehearsals hold the layer against a single-process oracle from the
same seed, as the JAX package's do: ``run_multihost_dryrun`` (one global
contrastive step of a linear map, ``mh_err``), ``run_put_global_dryrun``
(every placement family tiles the value exactly, ``pg_err``) and
``run_multihost_experiment_dryrun`` (one epoch of the product trainer,
``mh_exp_err``, with a checkpoint round trip).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Iterator, List, Optional

import numpy as np

from ..utils.logging import logger

_SEED = 7
_ROWS = 32  # the JAX rehearsal's 4 rows per device x 8 devices
_DIM, _PROJ = 32, 16
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def choose_backend(device: Optional[str] = None, local_world_size: int = 1) -> str:
    """``nccl`` when every local rank has a card of its own, else ``gloo``."""
    import torch
    import torch.distributed as dist

    if device == "cpu" or not torch.cuda.is_available():
        return "gloo"
    if local_world_size <= torch.cuda.device_count() and dist.is_nccl_available():
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None, process_id: Optional[int] = None,
                           backend: Optional[str] = None, device: Optional[str] = None,
                           local_rank: Optional[int] = None, local_world_size: Optional[int] = None,
                           timeout_s: float = 300.0) -> str:
    """Join the process group (one call per process).  ``coordinator_address``
    is ``host:port`` (or a ``tcp://`` / ``file://`` URL); missing arguments
    come from torchrun's environment.  On the card it also selects this
    rank's device.  Returns the backend."""
    import torch
    import torch.distributed as dist

    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None:
        addr = env.get("MASTER_ADDR", "localhost")
        # a URL (file://) names the rendezvous itself: no port to collide on
        coordinator_address = addr if "://" in addr else f"{addr}:{env.get('MASTER_PORT', '29500')}"
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", process_id))
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    chosen = backend or choose_backend(device, local_world_size)
    if device != "cpu" and torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    logger.info(f"rank {process_id}/{num_processes}: process group over {chosen} "
                f"({'ranks share a card or run on the CPU' if chosen == 'gloo' else 'a card per rank'})")
    dist.init_process_group(chosen, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return chosen


@contextlib.contextmanager
def torchrun_session(device: Optional[str] = None) -> Iterator[bool]:
    """An entry point's body under torchrun: join the process group from
    torchrun's environment when ``WORLD_SIZE > 1`` and no group is joined
    yet, and leave it after (``shutdown`` on success; on an error the group
    is destroyed without the barrier, so the peers' next collective fails
    instead of waiting).  Yields whether a group is joined."""
    import torch.distributed as dist

    joined = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized()
    if joined:
        initialize_distributed(device=device)
    try:
        yield dist.is_initialized()
    except BaseException:
        if joined:
            dist.destroy_process_group()
        raise
    if joined:
        shutdown()


def process_sum(value: int) -> int:
    """``value`` summed over every rank of the process group (itself without
    one): an ``all_reduce`` of one integer, on the card under nccl."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        return int(value)
    on = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    total = torch.tensor([int(value)], dtype=torch.int64, device=on)
    dist.all_reduce(total)
    return int(total.item())


def shutdown() -> None:
    """Free the ring's workspaces, then leave the process group."""
    import torch.distributed as dist

    from .collectives import release_workspaces

    if dist.is_available() and dist.is_initialized():
        release_workspaces()
        dist.barrier()
        dist.destroy_process_group()


def spawn(make_code: Callable[[int], str], n_processes: int, timeout: float, token: str,
          env_extra: Optional[dict] = None) -> List[float]:
    """Run ``python -c make_code(rank)`` for every rank; reap in completion
    order and return the float after ``token`` from each child's output.
    Raises on any child's failure or on the timeout; never orphans a child.
    The children get no JAX settings (``XLA_FLAGS``, ``JAX_PLATFORMS``)."""
    procs = []
    found: List[float] = []

    def read(log):
        log.flush()
        log.seek(0)
        return log.read()

    try:
        for rank in range(n_processes):
            env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            env.update(env_extra or {})
            # file-backed output: an unread pipe would block a chatty child
            log = tempfile.TemporaryFile(mode="w+", encoding="utf-8", errors="replace")
            procs.append((subprocess.Popen([sys.executable, "-c", make_code(rank)], env=env, cwd=REPO,
                                           stdout=log, stderr=subprocess.STDOUT, text=True), log))
        deadline = time.monotonic() + timeout
        pending = dict(enumerate(procs))
        while pending:
            for rank in [r for r, (p, _l) in pending.items() if p.poll() is not None]:
                proc, log = pending.pop(rank)
                out = read(log)
                if proc.returncode != 0:
                    raise RuntimeError(f"rank {rank} failed rc={proc.returncode}:\n{out[-3000:]}")
                for line in out.splitlines():
                    if token in line:
                        found.append(float(line.rsplit(token, 1)[1].split()[0]))
            if pending and time.monotonic() > deadline:
                raise RuntimeError(f"ranks {sorted(pending)} timed out after {timeout}s")
            time.sleep(0.05)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if len(found) != n_processes:
        raise RuntimeError(f"expected {n_processes} reports of {token!r}, got {len(found)}")
    return found


def file_store(root: str, name: str = "pg") -> str:
    """A rendezvous URL on a file under ``root`` (no port to collide on)."""
    return "file://" + os.path.join(root, name)


# ----------------------------------------------------------------------
# the rehearsals
# ----------------------------------------------------------------------


def _worker(num_processes: int, process_id: int, init_method: str) -> None:
    """One global contrastive step of a linear map, this rank's rows only,
    against the single-process step on all rows."""
    initialize_distributed(init_method, num_processes, process_id, device="cpu")
    import torch

    from ..losses.losses import clip_loss
    from ..models.clip import l2_normalize
    from .collectives import psum
    from .contrastive import global_clip_loss
    from .mesh import create_mesh, shard_batch

    mesh = create_mesh()
    rng = np.random.default_rng(_SEED)
    img = rng.normal(size=(_ROWS, _DIM)).astype(np.float32)
    txt = rng.normal(size=(_ROWS, _DIM)).astype(np.float32)
    w0 = rng.normal(size=(_DIM, _PROJ)).astype(np.float32) * 0.1
    scale = torch.tensor(1 / 0.07)
    local_img, local_txt = (torch.from_numpy(a) for a in shard_batch(mesh, (img, txt)))
    w = torch.tensor(w0, requires_grad=True)
    loss, _labels = global_clip_loss(l2_normalize(local_img @ w), l2_normalize(local_txt @ w), scale,
                                     mesh=mesh)
    loss.backward()
    w1 = (w - 0.1 * psum(w.grad, mesh=mesh)).detach()

    w_ref = torch.tensor(w0, requires_grad=True)
    ie, te = l2_normalize(torch.from_numpy(img) @ w_ref), l2_normalize(torch.from_numpy(txt) @ w_ref)
    ref = clip_loss(scale * ie @ te.T, scale * te @ ie.T)[0]
    ref.backward()
    ref_w1 = (w_ref - 0.1 * w_ref.grad).detach()
    err = max(abs(loss.item() - ref.item()), (w1 - ref_w1).abs().max().item())
    print(f"multihost rank {process_id}/{num_processes}: loss={loss.item():.4f} mh_err={err:.2e}",
          flush=True)
    assert err < 1e-5, f"multihost step diverges from the single-process oracle: {err}"
    shutdown()


def run_multihost_dryrun(n_processes: int = 2, timeout: float = 120) -> float:
    """``n_processes`` fresh CPU processes (gloo) run the contrastive-step
    rehearsal; returns the worst rank's error."""
    with tempfile.TemporaryDirectory() as root:
        store = file_store(root)

        def code(rank: int) -> str:
            return ("from mmgclip_tpu_torch.parallel.multihost import _worker\n"
                    f"_worker({n_processes}, {rank}, {store!r})\n")

        return max(spawn(code, n_processes, timeout, "mh_err="))


def _worker_put_global(num_processes: int, process_id: int, init_method: str) -> None:
    """Every placement family the trainer uses tiles a process-identical
    value exactly: each rank's block, gathered from every rank and put back
    at its index, rebuilds the value (replicated blocks agree)."""
    initialize_distributed(init_method, num_processes, process_id, device="cpu")
    import torch
    import torch.distributed as dist

    from .mesh import DATA_AXIS, MODEL_AXIS, NamedSharding, PartitionSpec as P, create_mesh, put_global

    mesh = create_mesh(data=num_processes // 2, model=2)
    x = np.random.default_rng(3).normal(size=(8, 6)).astype(np.float32)
    worst = 0.0
    for spec in (P(), P(DATA_AXIS), P(MODEL_AXIS), P(None, DATA_AXIS), P((DATA_AXIS, MODEL_AXIS))):
        sharding = NamedSharding(mesh, spec)
        block = torch.from_numpy(np.ascontiguousarray(put_global(x, sharding)))
        blocks = [torch.empty_like(block) for _ in range(num_processes)]
        dist.all_gather(blocks, block)
        rebuilt = np.full_like(x, np.nan)
        for rank, got in enumerate(blocks):
            index = NamedSharding(type(mesh)(mesh.devices, mesh.axis_names, rank=rank), spec).block(x.shape)
            part = rebuilt[index]
            if not np.isnan(part).all():  # a replicated block: must agree with what is there
                worst = max(worst, float(np.abs(part - got.numpy()).max()))
            rebuilt[index] = got.numpy()
        worst = max(worst, float(np.nan_to_num(np.abs(rebuilt - x), nan=np.inf).max()))
        assert worst == 0.0, f"{spec}: blocks do not tile the value ({worst})"
    print(f"put_global rank {process_id}/{num_processes}: pg_err={worst:.2e}", flush=True)
    shutdown()


def run_put_global_dryrun(n_processes: int = 4, timeout: float = 120) -> float:
    """``n_processes`` (even) fresh processes on a [n/2, 2] mesh."""
    if n_processes % 2:
        raise ValueError("the put_global rehearsal lays the ranks out as [n/2, 2]")
    with tempfile.TemporaryDirectory() as root:
        store = file_store(root)

        def code(rank: int) -> str:
            return ("from mmgclip_tpu_torch.parallel.multihost import _worker_put_global\n"
                    f"_worker_put_global({n_processes}, {rank}, {store!r})\n")

        return max(spawn(code, n_processes, timeout, "pg_err="))


def _worker_experiment(num_processes: int, process_id: int, init_method: str, root: str,
                       out_path: str, overrides=None) -> None:
    """One epoch of the product trainer (``ClassifierExperiment``, the fused
    epoch) over a fixture tree on ``num_processes`` ranks; rank 0 writes the
    loss and the flattened params, then a checkpoint round trip leaves the
    params as they were."""
    if num_processes > 1:
        initialize_distributed(init_method, num_processes, process_id, device="cpu")
    import torch

    from ..config import Config, compose
    from ..data.datasets import get_dataset
    from ..data.loader import DataLoaders
    from ..training.experiment import create_experiment
    from ..weights import flatten_tree

    cfg = compose(os.path.join(REPO, "configs"), "train_binary_class_clf",
                  run_dir=os.path.join(root, f"run{num_processes}_{process_id}"))
    cfg.dataset.config.base_dataset_path = os.path.join(root, "png_archive", "2D_100micron", "0")
    cfg.dataset.config.annotated_dataset_path = os.path.join(root, "02_data_T_regions")
    cfg.dataset.config.lists_dataset_path = os.path.join(root, "lists")
    cfg.base.features_export_dir = os.path.join(root, "features")
    scratch = os.path.join(root, f"scratch{num_processes}_{process_id}")
    cfg.base.export_dir = os.path.join(scratch, "out")
    cfg.base.tensorboard_export_dir = os.path.join(scratch, "runs")
    # one checkpoint directory every rank sees; rank 0 alone writes it
    cfg.checkpoints.checkpoints_export_dir = os.path.join(root, f"ckpt{num_processes}")
    cfg.tokenizer.config.sequence_length = 32
    cfg.networks.text_encoder = Config({
        "name": "BertEncoder",
        "config": {"vocab_size": 4096, "hidden_size": 64, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "intermediate_size": 128,
                   "max_position_embeddings": 64},
    })
    cfg.scheduler.config.epochs = 1
    cfg.dataloader.train.batch_size = 8
    cfg.dataloader.valid.batch_size = 4
    cfg.dataset.eval.enum_classes = []
    for path, value in (overrides or {}).items():
        keys = path.split(".")
        node = cfg
        for k in keys[:-1]:
            if k not in node:
                node[k] = Config({})
            node = node[k]
        node[keys[-1]] = Config(value) if isinstance(value, dict) else value

    torch.manual_seed(0)
    ds = get_dataset(cfg.dataset.name)(config=cfg)
    train_split, _val = ds.random_split(ds, "train")
    exp = create_experiment("classification")(
        config=cfg,
        train_dataloader=DataLoaders(cfg, train_split).get_dataloader(
            batch_size=8, shuffle=True, drop_last=True, collate_fn=ds.collate_fn),
        valid_dataloader=None, test_dataloader=None, tokenizer=ds.tokenizer, device="cpu")
    if (int(cfg.get_path("parallel.model_axis", 1)) > 1
            and cfg.get_path("projection.config.projection_name", "") == "MoEProjectionHead"):
        assert exp._expert_sharded, "the EP rehearsal did not shard the expert weights"
    if bool(cfg.get_path("optimizer.config.zero_sharding", False)) and num_processes > 1:
        assert exp.optimizer.sharded_names(), "the ZeRO-1 rehearsal left every moment replicated"
    loss = exp.train()

    def flat() -> np.ndarray:
        tree = flatten_tree(exp._host_params())
        return np.concatenate([np.asarray(tree[k], np.float64).ravel() for k in sorted(tree)])

    before = flat()
    if exp.is_writer:
        np.savez(out_path, loss=np.float64(loss), params=before)
    exp.early_stopper(loss, 0, exp._host_params, exp.optimizer.state_dict, exp.ckp_path,
                      rng_key=exp._host_rng_key, extra=exp._scheduler_state(),
                      writer=exp.is_writer)
    exp.barrier()
    assert exp.resume(), "checkpoint round trip: resume() found no checkpoint"
    ck_err = float(np.max(np.abs(flat() - before)))
    assert ck_err == 0.0, f"checkpoint round trip changed params: {ck_err}"
    print(f"mh_exp rank {process_id}/{num_processes}: loss={loss:.6f} ck_err={ck_err:.1e} ok=1",
          flush=True)
    if num_processes > 1:
        shutdown()


def run_multihost_experiment_dryrun(n_processes: int = 2, timeout: float = 300,
                                    overrides=None) -> float:
    """One trainer epoch on one process (the oracle) and on ``n_processes``
    (gloo, CPU) over the same fixture; returns max(|loss diff|, max |param
    diff|).  ``overrides`` (dotted config paths) select the layouts (EP/TP
    via ``parallel.model_axis`` and a MoE head, PP, ZeRO-1); the oracle
    applies all but the ``parallel.*`` ones, which one process cannot host
    and which change no number."""
    from ..tools.fixtures import build_image_label_tree

    with tempfile.TemporaryDirectory() as root:
        build_image_label_tree(root, n_benign=8, n_malignant=8)
        single_out, multi_out = (os.path.join(root, f"{t}.npz") for t in ("single", "multi"))
        store = file_store(root)

        def code_for(n: int, out: str, knobs):
            def code(rank: int) -> str:
                return ("from mmgclip_tpu_torch.parallel.multihost import _worker_experiment\n"
                        f"_worker_experiment({n}, {rank}, {store!r}, {root!r}, {out!r}, "
                        f"{knobs!r})\n")
            return code

        oracle = {k: v for k, v in (overrides or {}).items() if not k.startswith("parallel.")}
        spawn(code_for(1, single_out, oracle), 1, timeout, "ok=")
        spawn(code_for(n_processes, multi_out, overrides), n_processes, timeout, "ok=")
        single, multi = np.load(single_out), np.load(multi_out)
        return max(abs(float(single["loss"]) - float(multi["loss"])),
                   float(np.max(np.abs(single["params"] - multi["params"]))))


if __name__ == "__main__":
    n = int(os.environ.get("MH_PROCESSES", 2))
    print(f"multihost dryrun ok: mh_err={run_multihost_dryrun(n):.2e}")
    print(f"multihost experiment dryrun ok: mh_exp_err={run_multihost_experiment_dryrun(n):.2e}")
