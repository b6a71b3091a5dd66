"""Collectives (port of mmgclip_tpu/parallel/collectives.py).

Two forms, told apart by their first argument:

* **Over a mesh axis, one rank per process** (a tensor): ``all_gather``,
  ``psum``, ``pmean``, ``ppermute``, ``reduce_scatter`` and ``axis_index``
  over ``axis_name`` of ``mesh`` (default: the current mesh), the
  counterparts of the ``jax.lax`` collectives inside ``shard_map``.  Each is
  differentiable with its transpose as backward (all_gather <->
  reduce_scatter, ppermute -> the inverse permutation, psum -> the cotangent
  as it is, what follows a psum being replicated), so a loss differentiates
  as JAX's ``shard_map`` does: the gradient of a parameter every rank holds
  is then the ``psum`` of the ranks' gradients.  With one rank on the axis
  each is the identity.  On gloo, CUDA tensors go through the host
  explicitly.  ``reduce_scatter`` is an ``all_reduce`` followed by this
  rank's slice on every backend (gloo's reduce-scatter is missing from some
  builds; one code path on every build).
* **Over a list of P per-rank tensors in one process** (a list): the plain
  versions, element i being what rank i holds; the global losses over lists
  and the in-process ring use them.

``ring_all_gather`` is the counterpart of the Pallas ring kernel
(``csrc/ring_all_gather.cu``).  Given a tensor, it is the transport between
processes: each rank's workspace is exported with CUDA IPC once per (group,
size class), mapped by its peers, and every call writes this rank's shard
into every peer's workspace in one launch and raises one ``.sys``-scope flag
per peer (one hop: every pair of cards has a direct link; see the source).
Given a list of CUDA tensors it runs the P logical ranks of one process in
one cooperative launch.  Either way a protocol fault raises:
``check_ring`` reads the in-process error words, and for the cross-process
mode waits (polling, bounded by ``PEER_TIMEOUT_S``) for the last call of
every workspace, then raises the stuck flags itself, so the stream drains,
and raises.  ``ring_all_gather`` checks per call; ``ring_all_gather_diff``
leaves the check to its caller (the global losses check once per loss).  On
CPU tensors the ring is its plain version.  The kernel takes every shape and
dtype (it moves bytes), where the JAX wrapper sends ragged and 8-byte shards
to XLA's ``all_gather``; the values are the same.  The JAX package's
per-call-site ``collective_id`` bookkeeping and its VMEM tiling gate are TPU
matters with no counterpart.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import count_launch
from ..ops._build import check, load_typed
from ..utils.logging import logger
from .mesh import DATA_AXIS, Mesh, current_mesh

_SOURCE = "ring_all_gather.cu"
_THREADS = 256
MAX_RANKS = 64
TIMEOUT_NS = 1_000_000_000  # in one process: a wait longer than this is a protocol fault
PEER_TIMEOUT_S = 60.0  # across processes: a call not complete after this raises
_I, _LL, _P, _U = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_uint
_SIGNATURES = {
    "mmg_ring_all_gather": [_P, _P, _I, _LL, _I, _I, _P, _P, _U, _LL, _I, _P],
    "mmg_ring_max_blocks": [_I, _I, ctypes.POINTER(_I)],
    "mmg_ring_ipc_alloc": [_LL, _P, _P],
    "mmg_ring_ipc_open": [_P, _P],
    "mmg_ring_ipc_close": [_P],
    "mmg_ring_ipc_free": [_P],
    "mmg_ring_stream_ops": [ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "mmg_ring_peer_scatter": [_P, _LL, _I, _I, _P, _P, _I, _P, _U, _P],
    "mmg_ring_wait": [_P, _I, _U, _P],
    "mmg_ring_copy_out": [_P, _P, _LL, _LL, _I, _P],
    "mmg_ring_release": [_P, _I, _U],
}
_MAX_GEN = 2 ** 31 - 1
_CU_RESULT_BASE = 100000  # the source returns a CUresult r as this + r

# the cross-process workspace: a header of words, then two buffers of P slots
HEADER_BYTES = 8192
_COUNTER_WORD = 0  # the scatter kernel's count of finished blocks
_FLAG_WORD = 64  # + source rank: raised by that rank's scatter


# ----------------------------------------------------------------------
# plain collectives over per-rank lists (one process)
# ----------------------------------------------------------------------


def _list_all_gather(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank gets the concatenation of all shards along dim 0."""
    full = torch.cat(list(values))
    return [full] * len(values)


def _list_psum(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    total = torch.stack(list(values)).sum(0)
    return [total] * len(values)


def _list_pmean(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    mean = torch.stack(list(values)).mean(0)
    return [mean] * len(values)


def _list_reduce_scatter(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
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
    """Raise if a ring call on ``device`` since the last check hit its
    protocol timeout.  Waits for the last cross-process call of every
    workspace (bounded, ``PEER_TIMEOUT_S``), then reads every in-process
    error word of the device at once (one synchronisation); a CPU device has
    nothing to check."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    index = torch.cuda.current_device() if device.index is None else device.index
    _check_peer_calls(index)
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
    """Run the in-process CUDA ring over ``shards`` (P CUDA tensors of one
    shape and dtype) -> P outputs ``[P * chunk, ...]``; raises if the launch
    fails or the protocol times out (``check_ring``: one synchronisation)."""
    outs = _launch_ring(shards)
    check_ring(shards[0].device)
    return outs


def ring_all_gather(x, axis_name=DATA_AXIS, *, mesh: Optional[Mesh] = None):
    """All-gather the leading axis.  ``x`` a tensor: this rank's shard, the
    transport between the processes of ``axis_name`` on CUDA tensors (checked
    before it returns), the process group's ``all_gather`` on CPU tensors.
    ``x`` a list of per-rank shards: the in-process ring on CUDA tensors,
    ``ring_all_gather_plain`` on CPU tensors."""
    if isinstance(x, (list, tuple)):
        if x[0].is_cuda:
            return launch_ring_all_gather(x)
        return ring_all_gather_plain(x)
    if not x.is_cuda:
        return _all_gather_raw(x, mesh or current_mesh(), axis_name)
    out = _peer_ring(x, mesh or current_mesh(), axis_name)
    check_ring(x.device)
    return out


class _RingAllGather(torch.autograd.Function):
    """Forward: the in-process ring.  Backward: the tiled reduce-scatter of
    the cotangent (rank r's gradient is the sum over ranks r' of
    ``ct[r'][r*chunk:(r+1)*chunk]``), all_gather's transpose as in the JAX
    package's ``ring_all_gather_diff`` (``collectives.py:245-246``)."""

    @staticmethod
    def forward(ctx, *shards):
        if shards[0].is_cuda:
            return tuple(_launch_ring(shards))
        return tuple(ring_all_gather_plain(shards))

    @staticmethod
    def backward(ctx, *cotangents):
        return tuple(_list_reduce_scatter(cotangents))


class _PeerRingAllGather(torch.autograd.Function):
    """Forward: the cross-process transport (CUDA) or the process group's
    gather (CPU).  Backward: the reduce-scatter of the cotangent over the
    axis, as in the JAX package (``collectives.py:245-246``)."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        if x.is_cuda:
            return _peer_ring(x, mesh, axis_name)
        return _all_gather_raw(x, mesh, axis_name)

    @staticmethod
    def backward(ctx, ct):
        return _reduce_scatter_raw(ct.contiguous(), ctx.mesh, ctx.axis_name), None, None


def ring_all_gather_diff(x, axis_name=DATA_AXIS, *, mesh: Optional[Mesh] = None):
    """Differentiable ``ring_all_gather``.  On CUDA tensors it queues the
    transfer without waiting: the caller runs ``check_ring`` once after its
    gathers, as the global losses do, so a loss of four gathers waits once."""
    if isinstance(x, (list, tuple)):
        return list(_RingAllGather.apply(*x))
    return _PeerRingAllGather.apply(x, mesh or current_mesh(), axis_name)


# ----------------------------------------------------------------------
# collectives over a mesh axis, one rank per process
# ----------------------------------------------------------------------


def _dist():
    import torch.distributed as dist

    return dist


def _on_host(x: torch.Tensor, group) -> bool:
    """gloo moves CUDA tensors through the host; the port does it explicitly."""
    return x.is_cuda and _dist().get_backend(group) == "gloo"


def _all_gather_raw(x: torch.Tensor, mesh: Mesh, axis_name) -> torch.Tensor:
    group, size = mesh.group(axis_name), mesh.size(axis_name)
    if size == 1:
        return x
    y = x.detach().contiguous()
    host = _on_host(y, group)
    if host:
        y = y.cpu()
    parts = [torch.empty_like(y) for _ in range(size)]
    _dist().all_gather(parts, y, group=group)
    out = torch.cat(parts)
    return out.to(x.device) if host else out


def _all_reduce_raw(x: torch.Tensor, mesh: Mesh, axis_name) -> torch.Tensor:
    group, size = mesh.group(axis_name), mesh.size(axis_name)
    if size == 1:
        return x
    y = x.detach().contiguous().clone()
    host = _on_host(y, group)
    if host:
        y = y.cpu()
    _dist().all_reduce(y, group=group)
    return y.to(x.device) if host else y


def _reduce_scatter_raw(x: torch.Tensor, mesh: Mesh, axis_name) -> torch.Tensor:
    """Sum over the axis, then this rank's rows ``[i*chunk, (i+1)*chunk)``:
    an ``all_reduce`` and a slice on every backend (gloo's reduce-scatter is
    missing from some builds, and ``reduce_scatter_tensor`` on nccl waits
    for a machine with a card per rank to be tested and timed)."""
    size = mesh.size(axis_name)
    if size == 1:
        return x
    if x.shape[0] % size:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(x.shape)} does not split over {size} ranks")
    chunk = x.shape[0] // size
    i = mesh.index(axis_name)
    return _all_reduce_raw(x, mesh, axis_name)[i * chunk:(i + 1) * chunk].contiguous()


def _ppermute_raw(x: torch.Tensor, perm, mesh: Mesh, axis_name) -> torch.Tensor:
    """Rank ``i`` of the axis sends to ``j`` for every ``(i, j)`` in
    ``perm``; a rank that receives nothing gets zeros (``jax.lax.ppermute``)."""
    dist = _dist()
    me = mesh.index(axis_name)
    ranks = mesh.group_ranks(axis_name)
    group = mesh.group(axis_name)
    y = x.detach().contiguous()
    out = torch.zeros_like(y)
    sends = [dst for src, dst in perm if src == me]
    recvs = [src for src, dst in perm if dst == me]
    if len(sends) > 1 or len(recvs) > 1:
        raise ValueError(f"ppermute: rank {me} appears more than once in {perm}")
    if sends and sends[0] == me:  # to itself
        return y.clone()
    host = group is not None and _on_host(y, group)
    send_buf = y.cpu() if host else y
    recv_buf = torch.zeros_like(send_buf)
    ops = []
    if sends:
        ops.append(dist.P2POp(dist.isend, send_buf, ranks[sends[0]], group=group))
    if recvs:
        ops.append(dist.P2POp(dist.irecv, recv_buf, ranks[recvs[0]], group=group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if recvs:
        out = recv_buf.to(x.device) if host else recv_buf
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return _all_gather_raw(x, mesh, axis_name)

    @staticmethod
    def backward(ctx, ct):
        return _reduce_scatter_raw(ct.contiguous(), ctx.mesh, ctx.axis_name), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return _reduce_scatter_raw(x, mesh, axis_name)

    @staticmethod
    def backward(ctx, ct):
        return _all_gather_raw(ct.contiguous(), ctx.mesh, ctx.axis_name), None, None


class _Psum(torch.autograd.Function):
    """The sum is the same on every rank and what follows it runs replicated,
    so each rank's share of it takes the cotangent as it is (the transpose
    of ``psum`` in ``shard_map``: no communication)."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name):
        return _all_reduce_raw(x, mesh, axis_name)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, mesh, axis_name):
        ctx.perm, ctx.mesh, ctx.axis_name = perm, mesh, axis_name
        return _ppermute_raw(x, perm, mesh, axis_name)

    @staticmethod
    def backward(ctx, ct):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _ppermute_raw(ct, inverse, ctx.mesh, ctx.axis_name), None, None, None


def _is_list(x) -> bool:
    return isinstance(x, (list, tuple))


def all_gather(x, axis_name=DATA_AXIS, tiled: bool = True, *, mesh: Optional[Mesh] = None):
    """Concatenate every rank's ``x`` along dim 0 over ``axis_name`` (``tiled``;
    untiled stacks a new leading axis).  A list: the plain per-rank version."""
    if _is_list(x):
        return _list_all_gather(x)
    mesh = mesh or current_mesh()
    out = _AllGather.apply(x, mesh, axis_name)
    return out if tiled else out.reshape(mesh.size(axis_name), *x.shape)


def psum(x, axis_name=DATA_AXIS, *, mesh: Optional[Mesh] = None):
    if _is_list(x):
        return _list_psum(x)
    return _Psum.apply(x, mesh or current_mesh(), axis_name)


def pmean(x, axis_name=DATA_AXIS, *, mesh: Optional[Mesh] = None):
    if _is_list(x):
        return _list_pmean(x)
    mesh = mesh or current_mesh()
    return _Psum.apply(x, mesh, axis_name) / mesh.size(axis_name)


def reduce_scatter(x, axis_name=DATA_AXIS, scatter_dimension: int = 0, *,
                   mesh: Optional[Mesh] = None):
    """Sum over ``axis_name``, each rank keeping its block of
    ``scatter_dimension`` (tiled).  A list: the plain per-rank version."""
    if _is_list(x):
        return _list_reduce_scatter(x)
    mesh = mesh or current_mesh()
    moved = x.movedim(scatter_dimension, 0)
    return _ReduceScatter.apply(moved, mesh, axis_name).movedim(0, scatter_dimension)


def ppermute(x, perm, axis_name=DATA_AXIS, *, mesh: Optional[Mesh] = None):
    """Send ``x`` from axis index ``i`` to ``j`` for every ``(i, j)`` in ``perm``."""
    return _Ppermute.apply(x, [tuple(p) for p in perm], mesh or current_mesh(), axis_name)


def axis_index(axis_name=DATA_AXIS, *, mesh: Optional[Mesh] = None) -> int:
    return (mesh or current_mesh()).index(axis_name)


# ----------------------------------------------------------------------
# the ring across processes: workspaces, rendezvous, hand-offs
# ----------------------------------------------------------------------


class _Workspace:
    """This rank's IPC-exported block and its peers' mapped blocks, for one
    (group, size class).  ``peers[k]`` is rank k's base address (this rank's
    own at k == me)."""

    def __init__(self, lib, ranks: List[int], me: int, cap: int, group, device: torch.device):
        dist = _dist()
        self.lib, self.ranks, self.me, self.cap, self.device = lib, ranks, me, cap, device
        self.size = len(ranks)
        self.gen, self.seen = 0, 0
        self.pending: Optional[Tuple[int, list, torch.cuda.Event]] = None
        nbytes = HEADER_BYTES + 2 * self.size * cap
        ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(64)
        with torch.cuda.device(device):
            check(lib, lib.mmg_ring_ipc_alloc(nbytes, ctypes.byref(ptr), handle), "ring workspace alloc")
        self.base = ptr.value
        handles: List[bytes] = [b""] * self.size
        dist.all_gather_object(handles, handle.raw, group=group)  # the 64-byte handles
        self.peers: List[int] = []
        self._mapped: List[int] = []
        for k, raw in enumerate(handles):
            if k == me:
                self.peers.append(self.base)
                continue
            peer = ctypes.c_void_p()
            with torch.cuda.device(device):
                check(lib, lib.mmg_ring_ipc_open(ctypes.create_string_buffer(raw, 64),
                                                 ctypes.byref(peer)), "ring workspace map")
            self.peers.append(peer.value)
            self._mapped.append(peer.value)
        self.group = group
        self.event = torch.cuda.Event(enable_timing=False)

    def word(self, k: int, index: int) -> int:
        return self.peers[k] + 4 * index

    def slot(self, k: int, buf: int, s: int) -> int:
        return self.peers[k] + HEADER_BYTES + (buf * self.size + s) * self.cap

    def next_gen(self) -> int:
        self.gen += 1
        if self.gen >= _MAX_GEN:
            raise RuntimeError("ring_all_gather: the workspace's generation wrapped; recreate it")
        return self.gen

    def close(self) -> None:
        """Unmap the peers, wait until every peer has unmapped this block,
        then free it (an exported block is never freed while mapped)."""
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            for ptr in self._mapped:
                check(self.lib, self.lib.mmg_ring_ipc_close(ptr), "ring workspace unmap")
            self._mapped = []
            _dist().barrier(group=self.group)
            check(self.lib, self.lib.mmg_ring_ipc_free(self.base), "ring workspace free")


_WORKSPACES: Dict[Tuple, _Workspace] = {}


def _size_class(chunk_bytes: int) -> int:
    cap = 4096
    while cap < chunk_bytes:
        cap *= 2
    return cap


def stream_memory_ops() -> Dict[str, int]:
    """libcuda's stream memory operations on the current card: whether
    ``cuStreamWaitValue32`` resolves (``wait``) and the
    ``CAN_USE_STREAM_MEM_OPS_V1`` attribute (-1: not readable)."""
    lib = load_typed(_SOURCE, _SIGNATURES)
    attr, have = _I(0), _I(0)
    code = lib.mmg_ring_stream_ops(ctypes.byref(attr), ctypes.byref(have))
    _check_cu(lib, code, "stream memory operations query")
    return {"wait": have.value, "attr_v1": attr.value}


def _check_cu(lib, code: int, what: str) -> None:
    if code >= _CU_RESULT_BASE:
        raise RuntimeError(f"{what} failed: CUresult {code - _CU_RESULT_BASE}")
    if code == 801:  # cudaErrorNotSupported from mmg_ring_wait: libcuda has no stream waits
        raise RuntimeError(f"{what}: libcuda offers no cuStreamWaitValue32 "
                           "(stream memory operations), which the cross-process ring waits with")
    check(lib, code, what)


def _workspace(mesh: Mesh, axis_name, chunk_bytes: int, device: torch.device) -> _Workspace:
    ranks = mesh.group_ranks(axis_name)
    cap = _size_class(chunk_bytes)
    key = (tuple(ranks), cap, device.index)
    ws = _WORKSPACES.get(key)
    if ws is None:
        if len(ranks) > MAX_RANKS:
            raise ValueError(f"ring_all_gather takes at most {MAX_RANKS} ranks, got {len(ranks)}")
        lib = load_typed(_SOURCE, _SIGNATURES)
        ops = stream_memory_ops()
        if not ops["wait"]:
            raise RuntimeError("libcuda offers no cuStreamWaitValue32 (stream memory "
                               "operations), which the cross-process ring waits with")
        ws = _WORKSPACES[key] = _Workspace(lib, ranks, mesh.index(axis_name), cap,
                                           mesh.group(axis_name), device)
        logger.info(f"ring_all_gather: workspace for ranks {ranks}, {cap}-byte slots "
                    f"(CAN_USE_STREAM_MEM_OPS_V1 = {ops['attr_v1']})")
    return ws


def release_workspaces() -> None:
    """Unmap and free every cross-process workspace of this process (every
    rank of each group calls it, before the process group is destroyed)."""
    for key in sorted(_WORKSPACES, key=lambda k: (k[0], k[1])):
        _WORKSPACES.pop(key).close()


def _peer_ring(x: torch.Tensor, mesh: Mesh, axis_name, withhold: bool = False) -> torch.Tensor:
    """Queue the cross-process all-gather of this rank's shard ``x`` over
    ``axis_name``: rank r's ``[P * chunk, ...]`` output.  One scatter launch
    writes the shard into slot r of every rank's workspace and raises one
    flag per peer; this rank's stream then waits for the P - 1 peers' flags
    and copies its slots out.  ``withhold`` keeps this rank's flags back
    (only a test of the timeout path wants it)."""
    size = mesh.size(axis_name)
    if x.dim() == 0:
        raise ValueError("ring_all_gather gathers along dim 0; got a 0-d shard")
    if size == 1:
        return x
    x = x.contiguous()
    device = x.device
    out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=device)
    chunk = x.numel() * x.element_size()
    if chunk == 0:
        return out
    ws = _workspace(mesh, axis_name, chunk, device)
    lib, me, gen = ws.lib, ws.me, ws.next_gen()
    buf = gen % 2
    vec = _vector_bytes(chunk, [x, out])
    stream = torch.cuda.current_stream(device).cuda_stream
    blocks = max(1, min(264, -(-(chunk // vec) // (2 * _THREADS))))
    dsts = (ctypes.c_uint64 * size)(*[ws.slot(k, buf, me) for k in range(size)])
    flags = (ctypes.c_uint64 * size)(*[0 if withhold or k == me else ws.word(k, _FLAG_WORD + me)
                                       for k in range(size)])
    waited = [ws.word(me, _FLAG_WORD + k) for k in range(size) if k != me]
    addrs = (ctypes.c_uint64 * len(waited))(*waited)
    with torch.cuda.device(device):
        check(lib, lib.mmg_ring_peer_scatter(x.data_ptr(), chunk, vec, blocks, ctypes.cast(dsts, _P),
                                             ctypes.cast(flags, _P), size, ws.word(me, _COUNTER_WORD),
                                             gen, stream), "ring_all_gather (peer scatter)")
        count_launch("ring_all_gather")
        _check_cu(lib, lib.mmg_ring_wait(ctypes.cast(addrs, _P), len(waited), gen, stream),
                  "ring_all_gather (stream wait)")
        check(lib, lib.mmg_ring_copy_out(out.data_ptr(), ws.slot(me, buf, 0), chunk, ws.cap, size,
                                         stream), "ring_all_gather (copy out)")
        ws.event.record(torch.cuda.current_stream(device))
        ws.pending = (gen, waited, ws.event)
    return out


def _check_peer_calls(device_index: int, timeout_s: Optional[float] = None) -> None:
    """Wait for the last call of every cross-process workspace on the card,
    polling its event up to ``timeout_s``.  A call still waiting then has a
    peer that never delivered: raise its flags from another stream, so this
    rank's stream drains, and raise."""
    timeout_s = PEER_TIMEOUT_S if timeout_s is None else timeout_s
    failed = []
    for ws in _WORKSPACES.values():
        if ws.device.index != device_index or ws.pending is None:
            continue
        gen, waited, event = ws.pending
        ws.pending = None
        deadline = time.monotonic() + timeout_s
        while not event.query():
            if time.monotonic() > deadline:
                addrs = (ctypes.c_uint64 * len(waited))(*waited)
                with torch.cuda.device(ws.device):
                    check(ws.lib, ws.lib.mmg_ring_release(ctypes.cast(addrs, _P), len(waited), gen),
                          "ring_all_gather release")
                event.synchronize()
                failed.append(f"ranks {ws.ranks}, call {gen}")
                break
            time.sleep(20e-6)
    if failed:
        raise RuntimeError(
            f"ring_all_gather: protocol timeout across processes (a peer did not deliver its shard "
            f"within {timeout_s} s; {', '.join(failed)})")
