"""Convert a local HuggingFace BioGPT snapshot to the causal text tower's
weight file (port of tools/convert_biogpt.py).

    python -m mmgclip_tpu_torch.tools.convert_biogpt --input /path/to/biogpt_snapshot \
        --output biogpt.msgpack [--device cpu]

Reads the snapshot as ``convert_bert`` does (``pytorch_model.bin``, else
``model.safetensors``), drops a leading ``biogpt.`` from the names, maps
the state dict onto the port's ``CausalTextEncoder`` on ``--device`` with
``models.gpt.load_biogpt_weights`` and writes the module's parameters as
flax msgpack bytes, the file the JAX script writes, byte for byte.  Every
leaf of the tower comes from the snapshot.  Runs on the CUDA card unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

from ..ingest.encode import resolve_device
from ..models.gpt import CausalTextEncoder, GPTConfig, load_biogpt_weights
from .convert_bert import read_hf_snapshot, write_tower


def main(argv: Optional[List[str]] = None) -> Dict:
    """The entry point; returns ``{"output", "config"}``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="Local HF BioGPT dir")
    parser.add_argument("--output", required=True)
    parser.add_argument("--device", default=None,
                        help="Torch device; default the CUDA card (raises without one).")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(args.device)  # no card and no --device: raise before any work

    hf_config, state_dict = read_hf_snapshot(args.input, "biogpt.")
    config = GPTConfig(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        num_hidden_layers=hf_config["num_hidden_layers"],
        num_attention_heads=hf_config["num_attention_heads"],
        intermediate_size=hf_config["intermediate_size"],
        max_position_embeddings=hf_config["max_position_embeddings"],
        scale_embedding=hf_config.get("scale_embedding", True),
    )
    module = load_biogpt_weights(CausalTextEncoder(config).to(device), state_dict)
    write_tower(module, args.output)
    print(f"Wrote {args.output} ({config})")
    return {"output": args.output, "config": config}


if __name__ == "__main__":
    main()
