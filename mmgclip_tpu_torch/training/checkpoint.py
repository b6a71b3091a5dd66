"""Checkpoints in the JAX package's format (port of
mmgclip_tpu/training/checkpoint.py).

A checkpoint is a pickle of ``{epoch, val_loss, best_score, counter, params,
opt_state, rng_key, extra}`` whose ``params`` are flax msgpack bytes
(``utils.flax_msgpack``; the pickle holds only builtin types), so the JAX
package's ``load_checkpoint`` reads the port's files and the port reads the
JAX package's.  The optimizer state and the RNG state do not cross: the port
writes its own (the AdamW count and moments as flax msgpack bytes, the
``torch.Generator`` state as bytes) under ``torch_opt_state`` /
``torch_rng_state`` and leaves
``opt_state`` / ``rng_key`` empty, which the JAX loader skips.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

from ..utils.flax_msgpack import from_bytes, to_bytes
from ..utils.logging import logger
from ..utils.seeding import create_directory_if_not_exists


def save_checkpoint(path: str, params: Dict[str, Any], opt_state: Optional[Dict] = None,
                    epoch: int = 0, val_loss: float = float("inf"),
                    best_score: Optional[float] = None, counter: int = 0,
                    rng_state: Optional[bytes] = None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """``params``: a JAX-layout tree of numpy arrays (``weights.clip_params_tree``)."""
    create_directory_if_not_exists(os.path.dirname(path) or ".")
    state = {
        "epoch": epoch,
        "val_loss": float(val_loss),
        "best_score": best_score,
        "counter": counter,
        "params": to_bytes(params),
        "opt_state": None,
        "rng_key": None,
        "extra": extra or {},
        "torch_opt_state": to_bytes(opt_state) if opt_state is not None else None,
        "torch_rng_state": rng_state,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(state, fh)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Checkpoint file (either package's) -> dict whose ``params`` is a nested
    dict of numpy arrays; ``opt_state`` (flax bytes decoded) when the JAX
    package wrote one, ``torch_opt_state`` / ``torch_rng_state`` when the port
    did.  Load the params into a model with ``weights.load_clip_params``."""
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
    if state.get("torch_opt_state") is not None:
        out["torch_opt_state"] = from_bytes(state["torch_opt_state"])
    if state.get("torch_rng_state") is not None:
        out["torch_rng_state"] = state["torch_rng_state"]
    logger.info(f"Loaded checkpoint from {path} (epoch {out['epoch']}).")
    return out
