"""Collectives over per-rank tensor lists (port of
mmgclip_tpu/parallel/collectives.py).

The JAX package writes collectives inside ``shard_map``, where each device
holds one shard.  The port's single-process stand-in is a list of P per-rank
tensors: element i is what JAX's shard i holds.  ``all_gather``, ``psum``,
``pmean`` and ``reduce_scatter`` are the plain versions over such lists.

``ring_all_gather`` is the counterpart of the Pallas ring kernel: on CUDA
tensors it launches ``csrc/ring_all_gather.cu`` (P logical ranks on one
card, each with its own shard and output buffer, the ring's schedule run
among them in one cooperative launch) and raises if the launch fails or the
protocol times out; on CPU tensors it runs ``ring_all_gather_plain``.  The
protocol reports a timeout in an error word on the card; ``check_ring``
reads it (one synchronisation), which ``ring_all_gather`` does per call and
the global losses once per loss over all of their gathers.  The
kernel takes every shape and dtype (it moves bytes), where the JAX wrapper
sends ragged and 8-byte shards to XLA's ``all_gather``; the values are the
same.  The JAX package's per-call-site ``collective_id`` bookkeeping and its
VMEM tiling gate (``_ring_tileable``) are TPU matters with no counterpart.
Transport between cards (peer pointers, IPC handles) is not wired up
(ROADMAP.md).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from ..ops import count_launch
from ..ops._build import check, load_typed

_SOURCE = "ring_all_gather.cu"
_THREADS = 256
MAX_RANKS = 64
TIMEOUT_NS = 1_000_000_000  # a wait longer than this is a protocol fault
_I, _LL, _P, _U = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_uint
_SIGNATURES = {
    "mmg_ring_all_gather": [_P, _P, _I, _LL, _I, _I, _P, _P, _U, _LL, _I, _P],
    "mmg_ring_max_blocks": [_I, _I, ctypes.POINTER(_I)],
}
_MAX_GEN = 2 ** 31 - 1


# ----------------------------------------------------------------------
# plain collectives over per-rank lists
# ----------------------------------------------------------------------


def all_gather(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank gets the concatenation of all shards along dim 0."""
    full = torch.cat(list(values))
    return [full] * len(values)


def psum(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    total = torch.stack(list(values)).sum(0)
    return [total] * len(values)


def pmean(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    mean = torch.stack(list(values)).mean(0)
    return [mean] * len(values)


def reduce_scatter(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum over ranks, then rank r keeps rows ``r*chunk:(r+1)*chunk``."""
    total = torch.stack(list(values)).sum(0)
    chunk = total.shape[0] // len(values)
    return [total[r * chunk:(r + 1) * chunk].contiguous() for r in range(len(values))]


def ring_all_gather_plain(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The kernel's plain version: each rank's output is ``torch.cat`` of
    every shard."""
    return [torch.cat(list(shards)) for _ in shards]


# ----------------------------------------------------------------------
# the CUDA ring
# ----------------------------------------------------------------------

_STATE: Dict[Tuple[int, int, int], dict] = {}  # (device, ranks, blocks) -> flags, error word, gen
_MAX_BLOCKS: Dict[Tuple[int, int, int], int] = {}


def _vector_bytes(chunk_bytes: int, tensors: Sequence[torch.Tensor]) -> int:
    for vec in (16, 8, 4, 2):
        if chunk_bytes % vec == 0 and all(t.data_ptr() % vec == 0 for t in tensors):
            return vec
    return 1


def _ring_state(device: torch.device, ranks: int, blocks: int) -> dict:
    key = (device.index, ranks, blocks)
    state = _STATE.get(key)
    if state is None:
        flags = torch.zeros(max(1, ranks * (ranks - 1) * blocks), dtype=torch.int32, device=device)
        state = _STATE[key] = {"flags": flags, "error": torch.zeros(1, dtype=torch.int32, device=device),
                               "gen": 0, "seen": 0, "ranks": ranks, "blocks": blocks}
    state["gen"] += 1
    if state["gen"] >= _MAX_GEN:  # wrapped: report what is pending, clear the words, start again
        check_ring(device)
        state["flags"].zero_()
        state["error"].zero_()
        state["gen"], state["seen"] = 1, 0
    return state


def check_ring(device) -> None:
    """Raise if a ring launch on ``device`` since the last check hit its
    protocol timeout.  Reads every error word of the device at once (one
    synchronisation); a CPU device has nothing to check."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    index = torch.cuda.current_device() if device.index is None else device.index
    states = [state for key, state in _STATE.items() if key[0] == index]
    if not states:
        return
    torch.cuda.synchronize(device)
    words = torch.cat([state["error"] for state in states]).tolist()
    failed = []
    for state, word in zip(states, words):
        if word != state["seen"]:  # the kernel leaves the failing call's generation there
            state["seen"] = word
            failed.append(f"{state['ranks']} ranks x {state['blocks']} blocks")
    if failed:
        raise RuntimeError(
            f"ring_all_gather: protocol timeout (a rank waited longer than its timeout for its left "
            f"neighbour's chunk; {', '.join(failed)})")


def _launch_ring(shards: Sequence[torch.Tensor], timeout_ns: int = TIMEOUT_NS,
                 drop_step: int = -1) -> List[torch.Tensor]:
    """Queue the CUDA ring over ``shards`` (P CUDA tensors of one shape and
    dtype) -> P outputs ``[P * chunk, ...]``, without waiting for it: a
    protocol timeout shows at the next ``check_ring``.  ``drop_step``
    withholds every rank's signal of that step, which only a test of the
    timeout wants."""
    shards = [t.contiguous() for t in shards]
    ranks = len(shards)
    if not 1 <= ranks <= MAX_RANKS:
        raise ValueError(f"ring_all_gather takes 1..{MAX_RANKS} ranks, got {ranks}")
    first = shards[0]
    if not first.is_cuda:
        raise ValueError("launch_ring_all_gather needs CUDA tensors")
    for t in shards:
        if t.shape != first.shape or t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"every shard must be {first.dtype} {tuple(first.shape)} on {first.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if first.dim() == 0:
        raise ValueError("ring_all_gather gathers along dim 0; got a 0-d shard")
    device = first.device
    outs = [torch.empty((ranks * first.shape[0], *first.shape[1:]), dtype=first.dtype, device=device)
            for _ in range(ranks)]
    chunk_bytes = first.numel() * first.element_size()
    if chunk_bytes == 0:
        return outs
    vec = _vector_bytes(chunk_bytes, shards + outs)
    lib = load_typed(_SOURCE, _SIGNATURES)
    with torch.cuda.device(device):
        key = (device.index, ranks, vec)
        if key not in _MAX_BLOCKS:
            out = _I(0)
            check(lib, lib.mmg_ring_max_blocks(ranks, vec, ctypes.byref(out)), "ring_all_gather occupancy")
            _MAX_BLOCKS[key] = out.value
        cap = _MAX_BLOCKS[key]
        if cap < 1:
            raise RuntimeError(f"ring_all_gather: {ranks} ranks do not fit the card co-resident")
        n_vec = chunk_bytes // vec
        blocks = max(1, min(cap, -(-n_vec // (2 * _THREADS))))
        state = _ring_state(device, ranks, blocks)
        srcs = (ctypes.c_uint64 * ranks)(*[t.data_ptr() for t in shards])
        dsts = (ctypes.c_uint64 * ranks)(*[t.data_ptr() for t in outs])
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.mmg_ring_all_gather(
            ctypes.cast(srcs, _P), ctypes.cast(dsts, _P), ranks, chunk_bytes, vec, blocks,
            state["flags"].data_ptr(), state["error"].data_ptr(), state["gen"], int(timeout_ns),
            int(drop_step), stream)
    check(lib, code, "ring_all_gather")
    count_launch("ring_all_gather")
    return outs


def launch_ring_all_gather(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Run the CUDA ring over ``shards`` (P CUDA tensors of one shape and
    dtype) -> P outputs ``[P * chunk, ...]``; raises if the launch fails or
    the protocol times out (``check_ring``: one synchronisation)."""
    outs = _launch_ring(shards)
    check_ring(shards[0].device)
    return outs


def ring_all_gather(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-gather the leading axis around the ring: the CUDA kernel on CUDA
    tensors, ``ring_all_gather_plain`` on CPU tensors."""
    if shards[0].is_cuda:
        return launch_ring_all_gather(shards)
    return ring_all_gather_plain(shards)


class _RingAllGather(torch.autograd.Function):
    """Forward: the ring.  Backward: the tiled reduce-scatter of the
    cotangent (rank r's gradient is the sum over ranks r' of
    ``ct[r'][r*chunk:(r+1)*chunk]``), all_gather's transpose as in the JAX
    package's ``ring_all_gather_diff`` (``collectives.py:245-246``)."""

    @staticmethod
    def forward(ctx, *shards):
        if shards[0].is_cuda:
            return tuple(_launch_ring(shards))
        return tuple(ring_all_gather_plain(shards))

    @staticmethod
    def backward(ctx, *cotangents):
        return tuple(reduce_scatter(cotangents))


def ring_all_gather_diff(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Differentiable ``ring_all_gather``.  On CUDA tensors it queues the
    kernel without waiting: the caller runs ``check_ring`` once after its
    gathers, as the global losses do, so a loss of four gathers synchronises
    once."""
    return list(_RingAllGather.apply(*shards))
