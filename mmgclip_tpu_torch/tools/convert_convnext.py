"""Convert the reference's ConvNeXt-Tiny classifier to the tower's weight
file (port of tools/convert_convnext.py).

    python -m mmgclip_tpu_torch.tools.convert_convnext --input classifier_convnext_tiny.pt \
        --output convnext_tiny_clf.npz [--verify] [--device cpu]

Reads a TorchScript classifier (``torch.jit.load``) or a torch checkpoint
(``torch.load``: a state dict, a ``{"model_state_dict": ...}`` dict or a
module), maps its torchvision-named state dict onto the tower's tree
(``models.convnext.torchvision_tree``: ``num_classes`` from
``classifier.2.weight``, ``in_channels`` from the stem), loads the tree into
the port's ConvNeXt-Tiny on ``--device`` (which checks every name and
shape) and writes the module's parameters as flax msgpack bytes: the file
the JAX script writes, byte for byte, and the one
``networks.image_encoder.convnext_tiny_clf_path`` reads in both packages.

A state dict without ``classifier.*`` leaves the head (``head_norm``,
``head_fc``) at the port's seeded init, where the JAX script leaves flax's
random init: those two leaves differ between the packages' files, every
other leaf is equal, and the encode path never reads the head.

``--verify`` runs the port's tower (default config, fp32, TF32 off) on
``--device`` and the TorchScript module's ``features`` + ``avgpool`` on
the CPU over one seeded 64x64 input and fails above 1e-3 max abs error.
Runs on the CUDA card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ingest.encode import resolve_device
from ..models.convnext import ConvNeXt, ConvNeXtConfig, torchvision_tree
from ..utils.flax_msgpack import to_bytes
from ..weights import load_flax_tree, module_tree

VERIFY_TOL = 1e-3


def read_classifier(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[torch.nn.Module]]:
    """-> (state dict, the TorchScript module or None)."""
    try:
        scripted = torch.jit.load(path, map_location="cpu")
    except RuntimeError:  # not a TorchScript archive: a torch checkpoint
        obj = torch.load(path, map_location="cpu", weights_only=False)
        state_dict = obj.get("model_state_dict", obj) if isinstance(obj, dict) else obj.state_dict()
        return state_dict, None
    return scripted.state_dict(), scripted


def tower_config(state_dict) -> ConvNeXtConfig:
    """ConvNeXt-Tiny with the artifact's class count and stem channels."""
    num_classes = (state_dict["classifier.2.weight"].shape[0]
                   if "classifier.2.weight" in state_dict else 2)
    in_channels = state_dict["features.0.0.weight"].shape[1]
    return replace(ConvNeXtConfig.tiny(num_classes=num_classes), in_channels=in_channels)


def load_tower(state_dict, device) -> ConvNeXt:
    """The port's ConvNeXt-Tiny on ``device`` holding the artifact's weights
    (the head at the seeded init when the artifact has none)."""
    config = tower_config(state_dict)
    module = ConvNeXt(config)
    tree = torchvision_tree(state_dict, config)["params"]
    if "head_fc" not in tree:
        tree.update({name: module_tree(getattr(module, name)) for name in ("head_norm", "head_fc")})
    return load_flax_tree(module.to(device), tree).eval()


@torch.no_grad()
def verify_features(module: ConvNeXt, scripted, x: np.ndarray) -> float:
    """Max abs error of the port's pooled features (on the module's device,
    fp32, TF32 off) against ``scripted.features`` + ``avgpool`` on the CPU,
    for NHWC ``x``."""
    device = next(module.parameters()).device
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ours = module(torch.from_numpy(x).to(device)).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    fmap = scripted.features(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    theirs = scripted.avgpool(fmap).squeeze(-1).squeeze(-1).numpy()
    return float(np.abs(ours - theirs).max())


def main(argv: Optional[List[str]] = None) -> Dict:
    """The entry point; returns ``{"output", "config", "max_abs_err"}``
    (the error None without ``--verify`` or without a TorchScript input)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="TorchScript .pt or torch checkpoint")
    parser.add_argument("--output", required=True, help="Output .npz path")
    parser.add_argument("--verify", action="store_true", help="Check numerics vs torch")
    parser.add_argument("--device", default=None,
                        help="Torch device; default the CUDA card (raises without one).")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.device)  # no card and no --device: raise before any work

    state_dict, scripted = read_classifier(args.input)
    config = tower_config(state_dict)
    print(f"Source stem has {config.in_channels} input channels.")
    module = load_tower(state_dict, device)

    err = None
    if args.verify and scripted is None:
        # the torch-side forward needs the TorchScript module; a bare state
        # dict has no callable graph to verify against
        print("WARNING: --verify needs a TorchScript input; skipping the torch oracle check.")
    if args.verify and scripted is not None:
        rng = np.random.default_rng(0)
        x = rng.normal(size=(1, 64, 64, config.in_channels)).astype(np.float32)
        err = verify_features(module, scripted, x)
        print(f"max abs feature error vs torch: {err:.3e}")
        if not err < VERIFY_TOL:
            raise RuntimeError(f"conversion verification failed: {err:.3e} >= {VERIFY_TOL}")

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "wb") as fh:
        fh.write(to_bytes({"params": module_tree(module)}))
    print(f"Wrote {args.output}")
    return {"output": args.output, "config": config, "max_abs_err": err}


if __name__ == "__main__":
    main()
