"""Convert a local HuggingFace BERT snapshot to the text tower's weight file
(port of tools/convert_bert.py).

    python -m mmgclip_tpu_torch.tools.convert_bert --input /path/to/hf_snapshot \
        --output bert_clinical.msgpack [--device cpu]

Reads ``config.json`` and ``pytorch_model.bin`` (``torch.load``) or, when
the snapshot has no ``.bin``, ``model.safetensors`` (``utils.safetensors_lite``),
drops a leading ``bert.`` from the names, maps the state dict onto the
tower's tree (``models.bert.hf_tree``), loads it into the port's
``BertEncoder`` on ``--device`` (which checks every name and shape) and
writes the module's parameters as flax msgpack bytes: the file the JAX
script writes, byte for byte, and the one
``networks.text_encoder.weights_path`` reads in both packages.  Every leaf
of the tower comes from the snapshot.  Runs on the CUDA card unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import torch

from ..ingest.encode import resolve_device
from ..models.bert import BertConfig, BertEncoder, hf_tree
from ..utils.flax_msgpack import to_bytes
from ..utils.safetensors_lite import load_file
from ..weights import load_flax_tree, module_tree


def read_hf_snapshot(path: str, prefix: str) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """-> (config.json, state dict with ``prefix`` dropped from its names)."""
    with open(os.path.join(path, "config.json")) as fh:
        hf_config = json.load(fh)
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.isfile(bin_path):
        state_dict = torch.load(bin_path, map_location="cpu", weights_only=True)
    else:
        state_dict = load_file(os.path.join(path, "model.safetensors"))
    n = len(prefix)
    return hf_config, {(k[n:] if k.startswith(prefix) else k): v for k, v in state_dict.items()}


def write_tower(module: torch.nn.Module, output: str) -> None:
    """The module's parameters as flax msgpack bytes of ``{"params": ...}``."""
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    with open(output, "wb") as fh:
        fh.write(to_bytes({"params": module_tree(module)}))


def main(argv: Optional[List[str]] = None) -> Dict:
    """The entry point; returns ``{"output", "config"}``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True,
                        help="Local HF model dir (config.json + pytorch_model.bin)")
    parser.add_argument("--output", required=True)
    parser.add_argument("--device", default=None,
                        help="Torch device; default the CUDA card (raises without one).")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.device)  # no card and no --device: raise before any work

    hf_config, state_dict = read_hf_snapshot(args.input, "bert.")
    config = BertConfig(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        num_hidden_layers=hf_config["num_hidden_layers"],
        num_attention_heads=hf_config["num_attention_heads"],
        intermediate_size=hf_config["intermediate_size"],
        max_position_embeddings=hf_config["max_position_embeddings"],
        type_vocab_size=hf_config.get("type_vocab_size", 2),
    )
    module = load_flax_tree(BertEncoder(config).to(device), hf_tree(state_dict, config)["params"])
    write_tower(module, args.output)
    print(f"Wrote {args.output} ({config})")
    return {"output": args.output, "config": config}


if __name__ == "__main__":
    main()
