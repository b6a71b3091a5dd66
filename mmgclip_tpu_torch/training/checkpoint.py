"""Checkpoints in the JAX package's format (port of
mmgclip_tpu/training/checkpoint.py).

A checkpoint is a pickle of ``{epoch, val_loss, best_score, counter, params,
opt_state, rng_key, extra}`` whose ``params`` are flax msgpack bytes
(``utils.flax_msgpack``; the pickle holds only builtin types), so the JAX
package's ``load_checkpoint`` reads the port's files and the port reads the
JAX package's.

The AdamW state crosses both ways.  ``opt_state`` holds the flax bytes of
``optax.inject_hyperparams(optax.adamw)``'s state over the trainable tree
(``mmgclip_tpu/training/optim.py``), which the JAX loader restores with its
own template: the injected hyperparams, the outer count, and the inner
``ScaleByAdamState`` count and moments by parameter path.  With a freeze
mask (the ResNet fine-tune, where only ``layer4`` of the tower trains) the
state is that of ``optax.chain(optax.masked(<that>, mask),
optax.masked(optax.set_to_zero(), ~mask))``::

    {"0": {"inner_state": <the unmasked state>}, "1": {"inner_state": {}}}

in whose ``mu`` and ``nu`` every frozen leaf is an empty dict (optax's
``MaskedNode``); the port's ``AdamW.state_dict()`` holds the same empty
dicts there.  ``load_checkpoint`` maps either layout onto the port's
``AdamW.state_dict()``.  The port also keeps its own copy under
``torch_opt_state``.  The dropout key crosses both
ways too: ``rng_key`` holds ``jax.random.key_data(key).tolist()``, the two
uint32 words of the threefry key, which the port's trainer keeps as a tensor
(``utils/prng.py``).  A port checkpoint from before the key crossed has
``torch_rng_state`` and no ``rng_key``; the trainer then warns and restarts
dropout from the seeded key.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.flax_msgpack import from_bytes, to_bytes
from ..utils.logging import logger
from ..utils.seeding import create_directory_if_not_exists
from .optim import B1, B2, EPS

# optax.adamw's hyperparameters that the port keeps as constants (AdamW's
# defaults); eps_root is optax's default
_FIXED_HYPERPARAMS = {"b1": B1, "b2": B2, "eps": EPS, "eps_root": 0.0}


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a.b": leaf} -> {"a": {"b": leaf}} (the trainable tree's paths); an
    empty-dict leaf (a frozen name's moment) stays an empty dict."""
    tree: Dict[str, Any] = {}
    for name, value in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = {} if isinstance(value, dict) else np.asarray(value)
    return tree


def optax_adamw_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """``AdamW.state_dict()`` -> the state dict flax writes for
    ``optax.inject_hyperparams(optax.adamw)``'s state: ``count``,
    ``hyperparams``, ``hyperparams_states`` and ``inner_state`` (the
    ``ScaleByAdamState`` and the two empty states of weight decay and
    scaling by the rate).  A state with frozen names (empty-dict moments)
    is written as the masked chain's: that state under ``"0"``, the empty
    ``set_to_zero`` state under ``"1"``."""
    count = np.asarray(state["count"], np.int32)
    hyperparams = {name: np.asarray(value, np.float32) for name, value in _FIXED_HYPERPARAMS.items()}
    for name in ("learning_rate", "weight_decay"):
        hyperparams[name] = np.asarray(state["hyperparams"][name], np.float32)
    adam = {"count": count, "mu": _nest(state["mu"]), "nu": _nest(state["nu"])}
    out = {"count": count, "hyperparams": hyperparams, "hyperparams_states": {},
           "inner_state": {"0": adam, "1": {}, "2": {}}}
    if any(isinstance(value, dict) for value in state["mu"].values()):
        return {"0": {"inner_state": out}, "1": {"inner_state": {}}}
    return out


def _masked_moments(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A moment tree -> {dotted name: array, or {} for a frozen leaf}."""
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict) and value:
            out.update(_masked_moments(value, path + "."))
        else:
            out[path] = {} if isinstance(value, dict) else np.asarray(value)
    return out


def adamw_state_from_optax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The decoded ``opt_state`` of a JAX checkpoint, unmasked or the masked
    chain -> ``AdamW.state_dict()`` layout (moments by dotted parameter name,
    ``{}`` for a frozen name).  Raises for a layout neither package writes."""
    if isinstance(tree, dict) and set(tree) == {"0", "1"} and tree["1"] == {"inner_state": {}}:
        tree = tree["0"].get("inner_state") if isinstance(tree["0"], dict) else None
    inner = tree.get("inner_state") if isinstance(tree, dict) else None
    if not isinstance(inner, dict) or "hyperparams" not in tree or "mu" not in inner.get("0", {}):
        raise NotImplementedError(
            "this checkpoint's optimizer state is neither optax.inject_hyperparams(optax.adamw) "
            "over the trainable tree nor that state masked by a freeze mask "
            "(optax.chain(optax.masked(...), optax.masked(optax.set_to_zero(), ...))); "
            "the port cannot resume it")
    hyperparams = tree["hyperparams"]
    for name, value in _FIXED_HYPERPARAMS.items():
        if np.float32(hyperparams[name]) != np.float32(value):
            raise ValueError(f"checkpoint AdamW {name}={float(hyperparams[name])}, "
                             f"the port's AdamW has {value}")
    adam = inner["0"]
    return {"count": np.asarray(adam["count"], np.int32),
            "hyperparams": {name: np.asarray(hyperparams[name], np.float32)
                            for name in ("learning_rate", "weight_decay")},
            "mu": _masked_moments(adam["mu"]), "nu": _masked_moments(adam["nu"])}


def save_checkpoint(path: str, params: Dict[str, Any], opt_state: Optional[Dict] = None,
                    epoch: int = 0, val_loss: float = float("inf"),
                    best_score: Optional[float] = None, counter: int = 0,
                    rng_key: Optional[List[int]] = None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """``params``: a JAX-layout tree of numpy arrays (``weights.clip_params_tree``);
    ``rng_key``: the dropout key's two uint32 words."""
    create_directory_if_not_exists(os.path.dirname(path) or ".")
    state = {
        "epoch": epoch,
        "val_loss": float(val_loss),
        "best_score": best_score,
        "counter": counter,
        "params": to_bytes(params),
        "opt_state": to_bytes(optax_adamw_state(opt_state)) if opt_state is not None else None,
        "rng_key": [int(v) for v in rng_key] if rng_key is not None else None,
        "extra": extra or {},
        "torch_opt_state": to_bytes(opt_state) if opt_state is not None else None,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(state, fh)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Checkpoint file (either package's) -> dict whose ``params`` is a nested
    dict of numpy arrays; ``opt_state`` (in ``AdamW.state_dict()``'s layout)
    when the file holds one, ``rng_key`` (two uint32 words) when it holds
    a dropout key, ``torch_opt_state`` when the port wrote it.  Load the
    params into a model with
    ``weights.load_clip_params``."""
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
        out["opt_state"] = adamw_state_from_optax(from_bytes(state["opt_state"]))
    if state.get("rng_key") is not None:
        out["rng_key"] = [int(v) for v in state["rng_key"]]
    if state.get("torch_opt_state") is not None:
        out["torch_opt_state"] = from_bytes(state["torch_opt_state"])
    logger.info(f"Loaded checkpoint from {path} (epoch {out['epoch']}).")
    return out
