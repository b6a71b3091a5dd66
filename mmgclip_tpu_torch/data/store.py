"""Feature store IO (port of mmgclip_tpu/data/store.py).

Features are ``.npy`` files; ``.pth`` files from the reference's extractor
(reference: mmgclip/networks/image_features.py:107-117) load too, so an
existing store can be reused as it is.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save_features(path: str, features: np.ndarray) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not path.endswith(".npy"):
        path = path + ".npy"
    np.save(path, np.asarray(features))
    return path


def load_features(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".pth"):
        # the reference's files hold pickled tensors, hence weights_only=False
        tensor = torch.load(path, map_location="cpu", weights_only=False)
        return np.asarray(tensor.detach().numpy() if hasattr(tensor, "detach") else tensor)
    raise ValueError(f"Unknown feature file type: {path}")


def load_features_batch(paths) -> np.ndarray:
    return np.stack([load_features(p) for p in paths], axis=0)
