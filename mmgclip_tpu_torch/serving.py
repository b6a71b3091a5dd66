"""Batch inference engine for serving (port of mmgclip_tpu/serving.py).

Loads everything once — trained CLIP head, frozen text tower, ConvNeXt encode
tower — keeps prompt-bank embeddings warm, and serves three operations:

* ``encode``   : image paths -> 768-d features (shape-bucketed batches);
* ``classify`` : zero-shot classification of features against an arbitrary
                 prompt list (prompt embeddings cached per prompt tuple);
* ``report``   : structured BI-RADS report per image/exam (one-computation
                 cascade + seeded template assembly).

It runs on the CUDA card unless the caller passes ``device="cpu"``; with no
card and no explicit device it raises.  ``serve.py`` wraps it in the JSONL
protocol.
"""

from __future__ import annotations

import os
import random
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import Config, recompose
from .data.tokenizer import Tokenizer
from .evaluation.report_cascade import (
    build_prompt_table,
    run_cascade,
    run_cascade_batch,
    unpack_decisions,
)
from .ingest.encode import (build_encode_program, host_prepool, load_convnext_tower,
                            parse_ingest_knobs, resolve_device)
from .ingest.png_reader import decode_png
from .models.clip import MMGCLIP, l2_normalize
from .ops.fusion import fuse_views
from .training.checkpoint import load_checkpoint
from .utils.logging import logger
from .weights import load_clip_params


class InferenceEngine:
    def __init__(self, config: Config, checkpoint_path: Optional[str] = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.config = config
        self.tokenizer = Tokenizer.from_pretrained(
            config.tokenizer.config.tokenizer_name,
            sequence_length=int(config.tokenizer.config.sequence_length),
        )
        self.model = MMGCLIP(config, seed=int(config.get_path("base.seed", seed)),
                             vocab_size=self.tokenizer.vocab_size)
        if checkpoint_path is None:
            checkpoint_path = os.path.join(
                config.checkpoints.checkpoints_export_dir, config.checkpoints.checkpoints_file_name)
        if os.path.isfile(checkpoint_path):
            load_clip_params(self.model, load_checkpoint(checkpoint_path)["params"])
        else:
            logger.warning(f"No checkpoint at {checkpoint_path}; serving with init params.")
        self.model.to(self.device).eval()

        self.encode_module, self.cn_config = load_convnext_tower(config, device=self.device)
        # the SAME ingest chain the feature store was built with: online
        # features must come from the input distribution the heads saw
        (resize_hw, resize_method, resize_precision, window,
         self._prepool) = parse_ingest_knobs(config)
        if resize_hw or window:
            logger.info(
                f"Serving encode applies the configured ingest chain: "
                f"resize={resize_hw} ({resize_method}), window={window}, "
                f"prepool={self._prepool}.")
        self._encode = build_encode_program(
            self.encode_module, self.cn_config.in_channels, window=window,
            resize_hw=resize_hw, resize_method=resize_method,
            resize_precision=resize_precision, prepool=self._prepool)
        self._prompt_cache: Dict[tuple, torch.Tensor] = {}
        self._cascade_table = None
        self._decode_pool: Optional[ThreadPoolExecutor] = None  # lazy; see encode_paths

    def close(self) -> None:
        """Stop the decode threads (the engine stays usable; they restart)."""
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=True)
            self._decode_pool = None

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def encode_paths(self, paths: Sequence[str]) -> np.ndarray:
        """PNG paths -> [n, 768] float32 features, bucketed by (shape, dtype).

        Host decode rides a thread pool; each bucket's device work is queued
        before the previous bucket's features are read back.  Decode errors
        raise to the caller."""
        if self._decode_pool is None:
            self._decode_pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="serve-decode")
        decoded = list(self._decode_pool.map(decode_png, paths))
        buckets = defaultdict(list)
        for i, pixels in enumerate(decoded):
            # dtype in the key: stacking mixed uint8/uint16 would promote to
            # uint16 and mis-scale the intensity transform
            buckets[(*pixels.shape, pixels.dtype.str)].append((i, pixels))
        out = np.zeros((len(paths), self.cn_config.dims[-1]), np.float32)
        pending = []  # [(items, device result)]

        def drain_one():
            items, result = pending.pop(0)
            feats = result.float().cpu().numpy()
            for (i, _px), vec in zip(items, feats):
                out[i] = vec

        for items in buckets.values():
            stack = np.stack([px for _i, px in items])
            if self._prepool:
                # the prepooled chain the feature store was built with
                sums, scale = host_prepool(stack, self._prepool)
                result = self._encode(torch.from_numpy(sums).to(self.device),
                                      native_hw=stack.shape[1:3], scale=scale)
            else:
                # raw uint8/uint16 crosses the host link: 1-2 bytes per pixel
                result = self._encode(torch.from_numpy(stack).to(self.device))
            pending.append((items, result))
            if len(pending) > 1:
                drain_one()
        while pending:
            drain_one()
        return out

    def encode_exam(self, exam_dir: str, method: Optional[str] = None, n_views: int = 4) -> np.ndarray:
        # PNG views only: exam dirs carry sidecars (.json annotations, ...)
        views = sorted(v for v in os.listdir(exam_dir) if v.lower().endswith(".png"))[:n_views]
        if not views:
            raise FileNotFoundError(
                f"no .png views in exam dir {exam_dir!r} — refusing to fuse "
                "an empty view set (it would produce an all-NaN vector)")
        feats = self.encode_paths([os.path.join(exam_dir, v) for v in views])
        method = method or self.config.get_path("dataset.config.concatenate_features_method", "avgpool")
        fused = fuse_views(torch.from_numpy(feats), method).numpy()
        return fused if fused.ndim == 2 else fused[None, :]

    # ------------------------------------------------------------------
    # bound the prompt cache: clients send arbitrary class_lists, and every
    # distinct tuple would otherwise pin a device-resident embedding forever
    _PROMPT_CACHE_MAX = 128

    @torch.inference_mode()
    def _prompt_embeddings(self, prompts: Sequence[str]) -> torch.Tensor:
        key = tuple(prompts)
        cached = self._prompt_cache.pop(key, None)
        if cached is None:
            tokens = self.tokenizer(list(prompts), max_length=self.tokenizer.sequence_length)
            pooled = self.model.apply_text_tower(tokens)
            cached = l2_normalize(self.model.project_text(pooled))
        self._prompt_cache[key] = cached  # re-insert: LRU order (dicts are ordered)
        while len(self._prompt_cache) > self._PROMPT_CACHE_MAX:
            self._prompt_cache.pop(next(iter(self._prompt_cache)))
        return self._prompt_cache[key]

    def _embed(self, feats: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.model.project_image(self.model.apply_image_tower(feats)))

    def _probs(self, image_emb: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
        logits = torch.exp(self.model.logit_scale) * image_emb @ text_emb.T
        return torch.softmax(logits, dim=-1)

    @staticmethod
    def _bucket_rows(feats: torch.Tensor):
        """Pad the row count to the next power of two (repeating the last
        row), as the JAX engine does; returns (padded, n)."""
        n = feats.shape[0]
        bucket = 1 << max(n - 1, 0).bit_length()
        if bucket > n:
            feats = torch.cat([feats, feats[-1:].expand(bucket - n, *feats.shape[1:])])
        return feats, n

    def _features(self, features) -> torch.Tensor:
        feats = torch.as_tensor(np.array(features, np.float32), device=self.device)
        return feats[None, :] if feats.dim() == 1 else feats

    @torch.inference_mode()
    def image_embeddings(self, features: np.ndarray) -> torch.Tensor:
        padded, n = self._bucket_rows(self._features(features))
        return self._embed(padded)[:n]

    @torch.inference_mode()
    def classify(self, features: np.ndarray, class_list: Sequence[str]) -> Dict:
        """Zero-shot classify features against prompts -> probs + argmax."""
        padded, n = self._bucket_rows(self._features(features))
        text_emb = self._prompt_embeddings(class_list)
        probs = self._probs(self._embed(padded), text_emb).cpu().numpy()[:n]
        return {
            "classes_similarities": probs.tolist(),
            "similarities_argmax": np.argmax(probs, axis=-1).tolist(),
            "class_list": list(class_list),
        }

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def cascade_decisions(self, features: np.ndarray) -> List[Dict[str, int]]:
        if self._cascade_table is None:
            self._cascade_table = build_prompt_table(self.model, self.tokenizer)
        table, mask = self._cascade_table
        padded, n = self._bucket_rows(self._features(features))
        if n == 1:
            return [unpack_decisions(run_cascade(self._embed(padded[:1])[0], table, mask).item())]
        packed = run_cascade_batch(self._embed(padded), table, mask).cpu().numpy()[:n]
        return [unpack_decisions(p) for p in packed]

    def generate_reports(self, features: np.ndarray, seed: int = 42,
                         bug_compat: bool = True) -> List[str]:
        from .evaluation.report_text import generate_report

        return [generate_report(decisions, rng=random.Random(seed), bug_compat=bug_compat)[0]
                for decisions in self.cascade_decisions(features)]

    @classmethod
    def from_experiment(cls, experiment_path: str, device=None) -> "InferenceEngine":
        """Load from a run directory (reads the .hydra snapshot)."""
        cfg = recompose(experiment_path)
        cfg.checkpoints.checkpoints_export_dir = os.path.join(experiment_path, "checkpoints")
        return cls(cfg, device=device)
