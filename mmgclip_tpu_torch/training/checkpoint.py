"""Reading the JAX package's checkpoints (port of the reading half of
mmgclip_tpu/training/checkpoint.py).

A checkpoint is a pickle of ``{epoch, val_loss, best_score, counter, params,
opt_state, rng_key, extra}`` whose ``params`` (and ``opt_state``) are flax
msgpack bytes.  The pickle holds only builtin types; the bytes are decoded
with the port's own reader (``utils.flax_msgpack``).  Writing checkpoints
comes with the training port.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

from ..utils.flax_msgpack import from_bytes
from ..utils.logging import logger


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Checkpoint file -> dict whose ``params`` is a nested dict of numpy
    arrays (``opt_state`` likewise when present).  Load the params into a
    model with ``weights.load_clip_params``."""
    with open(path, "rb") as fh:
        state = pickle.load(fh)
    out: Dict[str, Any] = {
        "epoch": state["epoch"],
        "val_loss": state["val_loss"],
        "best_score": state["best_score"],
        "counter": state["counter"],
        "extra": state.get("extra", {}),
        "params": from_bytes(state["params"]),
    }
    if state.get("opt_state") is not None:
        out["opt_state"] = from_bytes(state["opt_state"])
    if state.get("rng_key") is not None:
        out["rng_key"] = list(state["rng_key"])
    logger.info(f"Loaded checkpoint from {path} (epoch {out['epoch']}).")
    return out
