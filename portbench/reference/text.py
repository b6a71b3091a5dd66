"""WordPiece over a ``vocab.txt`` and BERT-base, plain.

The tokenizer is HF ``BertTokenizer``'s algorithm (lower case, accents
stripped, punctuation split, greedy longest-match WordPiece, ``[CLS] ...
[SEP]``, truncation that keeps ``[SEP]`` last, padding with ``[PAD]``).
The encoder is BERT (Devlin et al. 2019): token + position + type
embeddings and a LayerNorm, then post-LN layers of multi-head attention and
a GELU MLP; the pooled text feature is the hidden state of the last valid
token.  Weights come as the benchmark's tree (``qkv_kernel`` ``[L, H, 3,
heads, dh]``, kernels ``[in, out]``).
"""

from __future__ import annotations

import math
import unicodedata
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


class WordPiece:
    def __init__(self, vocab_path: str):
        with open(vocab_path, encoding="utf-8") as fh:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(fh) if line.rstrip("\n")}
        self.pad, self.unk = self.vocab["[PAD]"], self.vocab["[UNK]"]
        self.cls, self.sep = self.vocab["[CLS]"], self.vocab["[SEP]"]

    def _words(self, text: str) -> List[str]:
        out = []
        for word in text.split():
            word = "".join(c for c in unicodedata.normalize("NFD", word.lower())
                           if unicodedata.category(c) != "Mn")
            current = ""
            for ch in word:
                if _punct(ch):
                    if current:
                        out.append(current)
                        current = ""
                    out.append(ch)
                else:
                    current += ch
            if current:
                out.append(current)
        return out

    def _pieces(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk]
        ids, start = [], 0
        while start < len(word):
            for end in range(len(word), start, -1):
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    start = end
                    break
            else:
                return [self.unk]
        return ids

    def __call__(self, texts: Sequence[str], length: int) -> Dict[str, np.ndarray]:
        ids = np.full((len(texts), length), self.pad, np.int64)
        mask = np.zeros((len(texts), length), np.int64)
        for row, text in enumerate(texts):
            seq = [self.cls] + [i for w in self._words(text) for i in self._pieces(w)] + [self.sep]
            if len(seq) > length:
                seq = seq[: length - 1] + [self.sep]
            ids[row, : len(seq)] = seq
            mask[row, : len(seq)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _ln(x, scale, bias, eps):
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


class Bert:
    """BERT over the tree's float32 values, on ``device``."""

    def __init__(self, tree: Dict, device, eps: float = 1e-12):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.p = {k: (t(v) if not isinstance(v, dict) else {kk: t(vv) for kk, vv in v.items()})
                  for k, v in tree.items()}
        self.eps = eps
        self.layers, _h, _three, self.heads, self.dh = self.p["qkv_kernel"].shape

    @torch.no_grad()
    def pooled(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """[n, s] ids and mask -> [n, H] hidden state of each last valid token."""
        p = self.p
        dev = p["out_kernel"].device
        ids_t = torch.as_tensor(ids, device=dev).long()
        mask_t = torch.as_tensor(mask, device=dev).bool()
        n, s = ids_t.shape
        x = (p["word_embeddings"]["embedding"][ids_t]
             + p["position_embeddings"]["embedding"][:s][None]
             + p["token_type_embeddings"]["embedding"][0][None, None])
        x = _ln(x, p["embeddings_norm"]["scale"], p["embeddings_norm"]["bias"], self.eps)
        bias = torch.where(mask_t, 0.0, -math.inf)[:, None, None, :]
        for i in range(self.layers):
            qkv = torch.einsum("bsh,hknd->bsknd", x, p["qkv_kernel"][i]) + p["qkv_bias"][i]
            q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(self.dh) + bias, dim=-1)
            ctx = (att @ v).transpose(1, 2).reshape(n, s, -1)
            x = _ln(x + ctx @ p["out_kernel"][i] + p["out_bias"][i],
                    p["attn_norm_scale"][i], p["attn_norm_bias"][i], self.eps)
            h = F.gelu(x @ p["mlp_in_kernel"][i] + p["mlp_in_bias"][i])
            x = _ln(x + h @ p["mlp_out_kernel"][i] + p["mlp_out_bias"][i],
                    p["out_norm_scale"][i], p["out_norm_bias"][i], self.eps)
        last = mask_t.long().sum(-1) - 1
        return x[torch.arange(n, device=dev), last]
