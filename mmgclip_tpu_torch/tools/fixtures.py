"""Synthetic artifacts in the reference's file layouts, for offline runs of
the tools (the port's copy of what ``tools/reproduce.py --fixtures`` and
``tools/demo_run.py`` take from ``tests/fixtures.py`` and
``tools/reproduce.py:54-133``).

* ``build_image_label_tree``: the ``p{patient}{study}{view}`` PNG tree,
  JSON region annotations, patient lists and an optional ``.npy`` feature
  store, byte for byte the files of ``tests/fixtures.py``'s function.  The
  8-bit grayscale PNGs are written as Pillow writes them (adaptive row
  filters chosen among none, up, sub and Paeth by the least sum of
  absolute bytes, zlib level 6 with ``Z_FILTERED``), without Pillow, which
  the card's machine is not assumed to have.
* ``make_torch_fixtures``: the reproduce rehearsal's torch artifacts, a
  torchvision-named ConvNeXt-Tiny classifier state dict (``.pt``) and a
  tiny HF BERT snapshot, equal to the JAX tool's.
* ``TorchvisionConvNeXt``, ``write_torchscript``, ``bert_state_dict``,
  ``write_hf_snapshot``, ``write_safetensors``: full-size artifacts in the
  real formats (a TorchScript classifier traced from plain ``nn`` layers
  under torchvision's names, independent of the port's tower; an HF BERT
  snapshot as ``pytorch_model.bin`` and as a hand-written
  ``model.safetensors``).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

VIEWS = ["cl", "cr", "ml", "mr"]


def make_image_id(patient: int, study: int, view: str) -> str:
    return f"p{patient:08d}{study:02d}{view}"


# ----------------------------------------------------------------------
# 8-bit grayscale PNGs, byte-equal to Pillow's

def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_rows(pixels: np.ndarray) -> bytes:
    """Each row prefixed by its filter type: Pillow's adaptive choice, the
    first of none, up, sub, Paeth with the least sum of |signed byte|."""
    cur = pixels.astype(np.int32)
    up = np.vstack([np.zeros((1, cur.shape[1]), np.int32), cur[:-1]])
    left = np.hstack([np.zeros((cur.shape[0], 1), np.int32), cur[:, :-1]])
    upleft = np.hstack([np.zeros((cur.shape[0], 1), np.int32), up[:, :-1]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    kinds = (0, 2, 1, 4)
    candidates = np.stack([cur, cur - up, cur - left, cur - paeth]) & 0xFF  # [4, h, w]
    cost = np.where(candidates < 128, candidates, 256 - candidates).sum(axis=2)  # [4, h]
    best = np.argmin(cost, axis=0)  # the first minimum: Pillow's strict "<"
    out = bytearray()
    for r, choice in enumerate(best):
        out.append(kinds[choice])
        out += candidates[choice, r].astype(np.uint8).tobytes()
    return bytes(out)


def png_l8_bytes(pixels: np.ndarray) -> bytes:
    """A [h, w] uint8 array as the PNG bytes ``Image.fromarray(a, "L").save``
    writes (one IDAT chunk: images whose compressed rows stay under 64 KiB)."""
    h, w = pixels.shape
    compressor = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    idat = compressor.compress(_filter_rows(pixels)) + compressor.flush()
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _png_chunk(b"IDAT", idat) + _png_chunk(b"IEND", b""))


def write_png(path: str, size: int = 64, seed: int = 0, intensity_range=(0, 256)) -> None:
    rng = np.random.default_rng(seed)
    arr = rng.integers(*intensity_range, size=(size, size), dtype=np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(png_l8_bytes(arr))


# ----------------------------------------------------------------------
# the image-label tree

def make_region(is_malign=False, is_mass=False, arch=False, calc=False, margin=None, shape=None):
    properties = {}
    if margin is not None:
        properties["mass_margin"] = margin
    if shape is not None:
        properties["mass_shape"] = shape
    return {
        "is_mass": is_mass,
        "is_malign": is_malign,
        "is_architectural_distortion": arch,
        "is_calcification_cluster": calc,
        "is_individual_calcification": False,
        "properties": properties,
    }


def build_image_label_tree(
    root: str,
    n_benign: int = 6,
    n_malignant: int = 6,
    image_size: int = 32,
    features_dim: int = 768,
    feature_store: bool = True,
    separable: bool = False,
    pixel_class_signal: bool = False,
) -> Tuple[str, str, str, str]:
    """Returns (base_dataset_path, annotated_path, lists_path, features_dir)."""
    # the real store prefix: <...>/2D_100micron/0/<pid[:2]>/<pid>/st<study>
    base = os.path.join(root, "png_archive", "2D_100micron", "0")
    annotated = os.path.join(root, "02_data_T_regions")
    lists_dir = os.path.join(root, "lists")
    features_dir = os.path.join(root, "features")
    os.makedirs(os.path.join(annotated, "02_benign"), exist_ok=True)
    os.makedirs(os.path.join(annotated, "02_stl"), exist_ok=True)
    os.makedirs(lists_dir, exist_ok=True)

    rng = np.random.default_rng(0)
    benign_patients: List[str] = []
    malig_patients: List[str] = []

    def emit(i: int, benign: bool):
        patient = 2000000 + i if benign else 2100000 + i
        pid = f"{patient:08d}"
        (benign_patients if benign else malig_patients).append(pid)
        view = VIEWS[i % len(VIEWS)]
        image_id = make_image_id(patient, 2, view)
        png_path = os.path.join(base, pid[:2], pid, "st02", f"{image_id}.png")
        # pixel_class_signal: the classes separate in pixel space
        # (intensity bands), so runs that encode from PNGs can learn
        intensity = (0, 256)
        if pixel_class_signal:
            intensity = (0, 128) if benign else (128, 256)
        write_png(png_path, size=image_size, seed=i, intensity_range=intensity)

        if benign:
            regions = {}
            if i % 2 == 0:
                regions["r0"] = make_region(is_mass=True, margin="Circumscribed", shape="Oval")
        else:
            regions = {
                "r0": make_region(
                    is_malign=True, is_mass=(i % 3 != 0), arch=(i % 4 == 0), calc=(i % 3 == 0),
                    margin="Spiculated" if i % 3 != 0 else None,
                    shape="Irregular" if i % 3 != 0 else None,
                )
            }
        annotation = {f"{image_id}_png": {"regions": regions}}
        folder = "02_benign" if benign else "02_stl"
        with open(os.path.join(annotated, folder, f"{image_id}.json"), "w") as fh:
            json.dump(annotation, fh)

        if feature_store:
            feat_path = os.path.join(features_dir, "0/02", pid[:2], pid, "st02", f"{image_id}.npy")
            os.makedirs(os.path.dirname(feat_path), exist_ok=True)
            feats = rng.normal(size=(1, features_dim, 1, 1)).astype(np.float32)
            if separable:
                # class signal: benign/malignant means differ along a subspace
                direction = np.sign(np.arange(features_dim) % 2 - 0.5).astype(np.float32)
                feats[0, :, 0, 0] += (3.0 if benign else -3.0) * direction
            np.save(feat_path, feats)

    for i in range(n_benign):
        emit(i, benign=True)
    for i in range(n_malignant):
        emit(i, benign=False)

    with open(os.path.join(lists_dir, "normal_patients.txt"), "w") as fh:
        fh.write("patient_id\n" + "\n".join(benign_patients) + "\n")
    with open(os.path.join(lists_dir, "malignant_patients.txt"), "w") as fh:
        fh.write("patient_id\n" + "\n".join(malig_patients) + "\n")

    return base, annotated, lists_dir, features_dir


# ----------------------------------------------------------------------
# the reproduce rehearsal's torch artifacts

def make_torch_fixtures(root: str) -> tuple:
    """A ConvNeXt-Tiny classifier state dict (.pt, torchvision names, a
    1-channel stem like the reference's grayscale artifact) and a tiny
    HF-format BERT snapshot dir -> (pt path, snapshot dir, its config)."""
    rng = np.random.default_rng(0)

    def t(*shape, scale=0.05):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale)

    dims, depths = (96, 192, 384, 768), (3, 3, 9, 3)
    sd = {
        "features.0.0.weight": t(dims[0], 1, 4, 4),
        "features.0.0.bias": t(dims[0]),
        "features.0.1.weight": torch.ones(dims[0]),
        "features.0.1.bias": t(dims[0]),
    }
    stage_idx, down_idx = [1, 3, 5, 7], [None, 2, 4, 6]
    for s, (c, depth) in enumerate(zip(dims, depths)):
        if s > 0:
            di, prev = down_idx[s], dims[s - 1]
            sd[f"features.{di}.0.weight"] = torch.ones(prev)
            sd[f"features.{di}.0.bias"] = t(prev)
            sd[f"features.{di}.1.weight"] = t(c, prev, 2, 2)
            sd[f"features.{di}.1.bias"] = t(c)
        for b in range(depth):
            pre = f"features.{stage_idx[s]}.{b}.block"
            sd[f"{pre}.0.weight"] = t(c, 1, 7, 7)
            sd[f"{pre}.0.bias"] = t(c)
            sd[f"{pre}.2.weight"] = torch.ones(c)
            sd[f"{pre}.2.bias"] = t(c)
            sd[f"{pre}.3.weight"] = t(4 * c, c)
            sd[f"{pre}.3.bias"] = t(4 * c)
            sd[f"{pre}.5.weight"] = t(c, 4 * c)
            sd[f"{pre}.5.bias"] = t(c)
            sd[f"features.{stage_idx[s]}.{b}.layer_scale"] = torch.full((c,), 1e-2)
    sd["classifier.0.weight"] = torch.ones(dims[-1])
    sd["classifier.0.bias"] = t(dims[-1])
    sd["classifier.2.weight"] = t(2, dims[-1])
    sd["classifier.2.bias"] = t(2)
    pt_path = os.path.join(root, "classifier_convnext_tiny.pt")
    torch.save(sd, pt_path)

    bert_dir = os.path.join(root, "hf_bert")
    os.makedirs(bert_dir, exist_ok=True)
    hf_config = {
        "vocab_size": 4096, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128,
        "max_position_embeddings": 64, "type_vocab_size": 2,
    }
    with open(os.path.join(bert_dir, "config.json"), "w") as fh:
        json.dump(hf_config, fh)
    h, i, v, p = (hf_config[k] for k in
                  ("hidden_size", "intermediate_size", "vocab_size", "max_position_embeddings"))
    bert_sd = {
        "embeddings.word_embeddings.weight": t(v, h),
        "embeddings.position_embeddings.weight": t(p, h),
        "embeddings.token_type_embeddings.weight": t(2, h),
        "embeddings.LayerNorm.weight": torch.ones(h),
        "embeddings.LayerNorm.bias": t(h),
    }
    for layer in range(hf_config["num_hidden_layers"]):
        pre = f"encoder.layer.{layer}."
        for name, shape in (
            ("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
            ("intermediate.dense", (i, h)), ("output.dense", (h, i)),
        ):
            bert_sd[pre + name + ".weight"] = t(*shape)
            bert_sd[pre + name + ".bias"] = t(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            bert_sd[pre + name + ".weight"] = torch.ones(h)
            bert_sd[pre + name + ".bias"] = t(h)
    torch.save(bert_sd, os.path.join(bert_dir, "pytorch_model.bin"))
    return pt_path, bert_dir, hf_config


# ----------------------------------------------------------------------
# full-size artifacts in the real formats

class _LayerNorm2d(nn.LayerNorm):
    """torchvision's LayerNorm2d: LN over the channels of an NCHW map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1)
        x = nn.functional.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


class _Permute(nn.Module):
    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.dims = list(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(self.dims)


class _CNBlock(nn.Module):
    """torchvision's ConvNeXt block: depthwise 7x7, LN, Linear, GELU, Linear,
    ``layer_scale`` ``[C, 1, 1]`` (``[C]`` with ``flat_layer_scale``, the
    layout the JAX converter reads), residual."""

    def __init__(self, dim: int, layer_scale: float, flat_layer_scale: bool = False):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, kernel_size=7, padding=3, groups=dim, bias=True),
            _Permute([0, 2, 3, 1]),
            nn.LayerNorm(dim, eps=1e-6),
            nn.Linear(dim, 4 * dim),
            nn.GELU(),
            nn.Linear(4 * dim, dim),
            _Permute([0, 3, 1, 2]),
        )
        shape = (dim,) if flat_layer_scale else (dim, 1, 1)
        self.layer_scale = nn.Parameter(torch.full(shape, layer_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer_scale.reshape(-1, 1, 1) * self.block(x)


class TorchvisionConvNeXt(nn.Module):
    """torchvision's ``convnext_tiny`` classifier built from plain ``nn``
    layers under its state-dict names (``features``, ``avgpool``,
    ``classifier``), seeded."""

    def __init__(self, in_channels: int = 1, num_classes: int = 2,
                 dims: Sequence[int] = (96, 192, 384, 768), depths: Sequence[int] = (3, 3, 9, 3),
                 layer_scale: float = 0.1, flat_layer_scale: bool = False, seed: int = 0):
        super().__init__()
        with torch.random.fork_rng(devices=[]):  # seeded without touching the global stream
            torch.manual_seed(seed)
            layers: List[nn.Module] = [nn.Sequential(
                nn.Conv2d(in_channels, dims[0], kernel_size=4, stride=4),
                _LayerNorm2d(dims[0], eps=1e-6))]
            for stage, (dim, depth) in enumerate(zip(dims, depths)):
                if stage > 0:
                    layers.append(nn.Sequential(
                        _LayerNorm2d(dims[stage - 1], eps=1e-6),
                        nn.Conv2d(dims[stage - 1], dim, kernel_size=2, stride=2)))
                layers.append(nn.Sequential(*[_CNBlock(dim, layer_scale, flat_layer_scale)
                                              for _ in range(depth)]))
            self.features = nn.Sequential(*layers)
            self.avgpool = nn.AdaptiveAvgPool2d(1)
            self.classifier = nn.Sequential(_LayerNorm2d(dims[-1], eps=1e-6), nn.Flatten(1),
                                            nn.Linear(dims[-1], num_classes))
            with torch.no_grad():  # LN affines away from (1, 0), so a swap would show
                for norm in self.modules():
                    if isinstance(norm, nn.LayerNorm):
                        norm.weight.add_(0.05 * torch.randn_like(norm.weight))
                        norm.bias.add_(0.05 * torch.randn_like(norm.bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(self.avgpool(self.features(x)))


def write_torchscript(module: nn.Module, path: str, example: torch.Tensor) -> None:
    """Trace ``module`` on ``example`` (NCHW) and save the TorchScript archive."""
    module.eval()
    with torch.no_grad():
        traced = torch.jit.trace(module, example)
    traced.save(path)


def bert_state_dict(hf_config: Dict, seed: int = 0, scale: float = 0.05) -> Dict[str, torch.Tensor]:
    """A seeded HF ``BertModel`` state dict (``bert.``-prefixed names, as a
    ``BertForPreTraining`` snapshot stores them) for ``hf_config``."""
    g = torch.Generator().manual_seed(seed)
    h, i = hf_config["hidden_size"], hf_config["intermediate_size"]

    def t(*shape):
        return torch.randn(*shape, generator=g) * scale

    def ln(n):
        return 1.0 + t(n)

    sd = {
        "bert.embeddings.word_embeddings.weight": t(hf_config["vocab_size"], h),
        "bert.embeddings.position_embeddings.weight": t(hf_config["max_position_embeddings"], h),
        "bert.embeddings.token_type_embeddings.weight": t(hf_config.get("type_vocab_size", 2), h),
        "bert.embeddings.LayerNorm.weight": ln(h),
        "bert.embeddings.LayerNorm.bias": t(h),
    }
    for layer in range(hf_config["num_hidden_layers"]):
        pre = f"bert.encoder.layer.{layer}."
        for name, shape in (
            ("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
            ("intermediate.dense", (i, h)), ("output.dense", (h, i)),
        ):
            sd[pre + name + ".weight"] = t(*shape)
            sd[pre + name + ".bias"] = t(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[pre + name + ".weight"] = ln(h)
            sd[pre + name + ".bias"] = t(h)
    return sd


_SAFETENSORS_DTYPES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
                       torch.float64: "F64", torch.int64: "I64", torch.int32: "I32"}


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """``model.safetensors``: 8-byte little-endian header length, the JSON
    header (names in sorted order, 8-byte padded with spaces), raw bytes."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        raw = tensors[name].detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _SAFETENSORS_DTYPES[tensors[name].dtype],
                        "shape": list(tensors[name].shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(text)) + text + b"".join(chunks))


def write_hf_snapshot(path: str, hf_config: Dict, state_dict: Dict[str, torch.Tensor],
                      kind: str = "bin") -> str:
    """``config.json`` plus ``pytorch_model.bin`` (``kind="bin"``) or
    ``model.safetensors`` (``kind="safetensors"``) under ``path``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(hf_config, fh)
    if kind == "bin":
        torch.save(state_dict, os.path.join(path, "pytorch_model.bin"))
    elif kind == "safetensors":
        write_safetensors(os.path.join(path, "model.safetensors"), state_dict)
    else:
        raise ValueError(f"kind must be 'bin' or 'safetensors', got {kind!r}")
    return path
