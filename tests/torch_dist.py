"""Run a snippet of the port on N fresh CPU processes joined by gloo, for the
parallel layer's tests.

``run_ranks(world, body, tmp_path)`` starts ``world`` children through
``mmgclip_tpu_torch.parallel.multihost.spawn`` (a wall-clock timeout; one
failing child kills the rest and raises).  Each child joins a gloo group on
a file store under ``tmp_path``, runs ``body`` with ``rank``, ``world``,
``tmp`` (the directory) and ``save(obj)`` in scope, and the parent gets the
saved objects by rank.  The children import no JAX.
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
initialize_distributed({store!r}, world, rank, device="cpu")

def save(obj):
    with open(os.path.join(tmp, f"out_{{rank}}.pkl"), "wb") as fh:
        pickle.dump(obj, fh)

"""

EPILOGUE = """
shutdown()
print("done=1", flush=True)
"""


def run_ranks(world: int, body: str, tmp_path, timeout: float = 240, name: str = "pg"):
    tmp = str(tmp_path)
    store = file_store(tmp, name)
    def make(rank: int) -> str:
        return (PREAMBLE.format(rank=rank, world=world, tmp=tmp, store=store)
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
