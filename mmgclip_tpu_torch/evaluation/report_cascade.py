"""The report-generation decision cascade as one device computation
(port of mmgclip_tpu/evaluation/report_cascade.py).

Every prompt bank is embedded once into a padded [n_banks, max_prompts, d]
table; one call then computes ALL decisions — mass type, malignancy, shape,
margin, calcification attributes, both BI-RADS branches, architectural
distortion — as a masked argmax per bank against the same image embedding.
Branching happens on the host afterwards, on integer outputs.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..models.clip import l2_normalize

BANKS: Dict[str, List[str]] = {
    "mass_type": [
        "Mammogram revealed a mass.",
        "Mammogram revealed calcifications.",
        "No findings are present.",
    ],
    "mass_malignancy": [
        "Mass suggestive of benign pathology.",
        "Mass suggestive of malignant pathology.",
    ],
    "mass_shape": ["Mass shape is oval.", "Mass shape is round.", "Mass shape is irregular."],
    "mass_margin": [
        "Mass margin is circumscribed.",
        "Mass margin is obscured.",
        "Mass margin is spiculated.",
        "Mass margin is ill defined.",
    ],
    "calc_malignancy": [
        "Calcifications suggestive of benign pathology.",
        "Calcifications suggestive of malignant pathology.",
    ],
    "calc_distribution": [
        "Mammogram revealed calcifications with diffuse distribution.",
        "Mammogram revealed calcifications with regional distribution.",
        "Mammogram revealed calcifications with grouped distribution.",
        "Mammogram revealed calcifications with linear distribution.",
        "Mammogram revealed calcifications with segmental distribution.",
    ],
    "birads_benign": ["BIRADS score of 0.", "BIRADS score of 2.", "BIRADS score of 3."],
    "birads_malignant": [
        "BIRADS score of 0.",
        "BIRADS score of 4.",
        "BIRADS score of 5.",
        "BIRADS score of 6.",
    ],
    "arch_distortion": [
        "Mammogram displayed architectural distortion.",
        "Mammography showed no evidence of architectural distortion.",
    ],
}

BANK_ORDER = list(BANKS.keys())

# run_cascade packs per-bank argmaxes base-8 into one int32 scalar
if max(len(v) for v in BANKS.values()) > 8 or 3 * len(BANK_ORDER) > 31:
    raise ValueError("prompt banks do not fit the base-8 int32 packing")


def build_prompt_table(model, tokenizer) -> tuple:
    """Embed every bank once -> padded [n_banks, max_prompts, d] table and a
    validity mask [n_banks, max_prompts] (on the model's device)."""
    max_prompts = max(len(v) for v in BANKS.values())
    rows = []
    masks = []
    for name in BANK_ORDER:
        prompts = BANKS[name]
        tokens = tokenizer(
            prompts, padding="max_length", truncation=True,
            max_length=int(model.config.tokenizer.config.sequence_length),
        )
        pooled = model.apply_text_tower(tokens)
        emb = l2_normalize(model.project_text(pooled))
        pad = max_prompts - emb.shape[0]
        rows.append(torch.nn.functional.pad(emb, (0, 0, 0, pad)))
        masks.append(torch.tensor([1] * emb.shape[0] + [0] * pad, dtype=torch.int32,
                                  device=emb.device))
    return torch.stack(rows), torch.stack(masks)


def run_cascade(image_embedding, prompt_table, prompt_mask) -> torch.Tensor:
    """All cascade decisions for one [d] L2-normalized embedding, packed
    base-8 into one int32 scalar (unpack with :func:`unpack_decisions`)."""
    sims = torch.einsum("d,bpd->bp", image_embedding, prompt_table)
    sims = torch.where(prompt_mask > 0, sims, torch.tensor(float("-inf"), device=sims.device))
    winners = torch.argmax(sims, dim=-1)  # [n_banks], each < 8
    base = 8 ** torch.arange(winners.shape[0], dtype=torch.int64, device=sims.device)
    return torch.sum(winners * base).to(torch.int32)


def run_cascade_batch(image_embeddings, prompt_table, prompt_mask) -> torch.Tensor:
    """Batched cascade: [n, d] embeddings -> packed int32 [n]."""
    sims = torch.einsum("nd,bpd->nbp", image_embeddings, prompt_table)
    sims = torch.where(prompt_mask[None] > 0, sims, torch.tensor(float("-inf"), device=sims.device))
    winners = torch.argmax(sims, dim=-1)  # [n, n_banks]
    base = 8 ** torch.arange(winners.shape[1], dtype=torch.int64, device=sims.device)
    return torch.sum(winners * base[None, :], dim=-1).to(torch.int32)


def unpack_decisions(packed: int) -> Dict[str, int]:
    """Base-8 packed scalar -> {bank_name: argmax}."""
    packed = int(packed)
    out = {}
    for name in BANK_ORDER:
        out[name] = packed % 8
        packed //= 8
    return out


def decide(model, tokenizer, image_features) -> Dict[str, int]:
    """Features ([d] or [1, d]) -> dict of decision indices: the image tower
    head, the projection, L2 norm, then :func:`run_cascade`.

    The prompt table depends only on the model's parameters and the
    tokenizer; it is cached on the model, keyed on both by identity (each
    parameter tensor with its version counter, so an in-place update is a
    new key), so repeated calls never re-run the frozen text tower."""
    with torch.inference_mode():
        feats = torch.as_tensor(image_features, dtype=torch.float32, device=model.device)
        if feats.dim() == 1:
            feats = feats[None, :]
        emb = l2_normalize(model.project_image(model.apply_image_tower(feats)))[0]
        params = [(p, p._version) for p in model.parameters()]
        cached = getattr(model, "_cascade_table_cache", None)
        if (cached is None or cached[1] is not tokenizer or len(cached[0]) != len(params)
                or any(a is not b or va != vb for (a, va), (b, vb) in zip(cached[0], params))):
            table, mask = build_prompt_table(model, tokenizer)
            model._cascade_table_cache = (params, tokenizer, table, mask)
        _, _, table, mask = model._cascade_table_cache
        return unpack_decisions(run_cascade(emb, table, mask).item())  # one scalar read
