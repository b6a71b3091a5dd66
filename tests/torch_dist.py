"""Run a snippet of the port on N fresh CPU processes joined by gloo, for the
parallel layer's tests.

``run_ranks(world, body, tmp_path)`` starts ``world`` children through
``mmgclip_tpu_torch.parallel.multihost.spawn`` (a wall-clock timeout; one
failing child kills the rest and raises).  Each child joins a gloo group on
a file store under ``tmp_path``, runs ``body`` with ``rank``, ``world``,
``tmp`` (the directory) and ``save(obj)`` in scope, and the parent gets the
saved objects by rank.  With ``torchrun=True`` a child joins no group
itself: it gets torchrun's environment instead (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and the file store's URL as
``MASTER_ADDR``), so the entry points under test join it.  The children
import no JAX.
"""

import os
import pickle
import textwrap

from mmgclip_tpu_torch.parallel.multihost import file_store, spawn

PREAMBLE = """
import os, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from mmgclip_tpu_torch.parallel.multihost import initialize_distributed, shutdown
rank, world, tmp = {rank}, {world}, {tmp!r}
{join}

def save(obj):
    with open(os.path.join(tmp, f"out_{{rank}}.pkl"), "wb") as fh:
        pickle.dump(obj, fh)

"""

EPILOGUE = """
shutdown()
print("done=1", flush=True)
"""


def run_ranks(world: int, body: str, tmp_path, timeout: float = 240, name: str = "pg",
              torchrun: bool = False):
    tmp = str(tmp_path)
    store = file_store(tmp, name)

    def make(rank: int) -> str:
        env = {"RANK": rank, "WORLD_SIZE": world, "LOCAL_RANK": rank, "LOCAL_WORLD_SIZE": world,
               "MASTER_ADDR": store}
        join = (f"os.environ.update({ {k: str(v) for k, v in env.items()} !r})" if torchrun
                else f'initialize_distributed({store!r}, world, rank, device="cpu")')
        return (PREAMBLE.format(rank=rank, world=world, tmp=tmp, join=join)
                + textwrap.dedent(body) + EPILOGUE)

    spawn(make, world, timeout, "done=")
    out = []
    for rank in range(world):
        path = os.path.join(tmp, f"out_{rank}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as fh:
                out.append(pickle.load(fh))
        else:
            out.append(None)
    return out
