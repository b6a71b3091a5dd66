"""Offline feature extraction and the encode program shared by every encode
surface (port of mmgclip_tpu/ingest/encode.py).

* ``load_convnext_tower`` builds ConvNeXt-Tiny from the config knobs, with the
  JAX package's gates and warnings, and loads converted weights (flax bytes
  at ``networks.image_encoder.convnext_tiny_clf_path``, ``.npz`` suffix);
  without the file the tower keeps its seeded init.
* ``parse_ingest_knobs`` / ``build_encode_program``: ``[n, H, W]
  uint8/uint16 -> [n, d]``, either intensity transform + tower at the exact
  shape, or the ingest chain (aspect-preserving resample onto the
  ``encode_resize`` canvas, from pixels or from host block sums with
  ``encode_host_prepool``, then windowing, normalisation and the masked
  tower).  The feature store and serving build their programs here, so
  served features ride the chain the stored ones were built with.
* ``_Encoder`` decodes PNGs on a thread pool with a bounded in-flight
  window, buckets them by shape and dtype (or by rounded shape with
  ``encode_bucket_rounding``, through the masked tower), and keeps two
  batches in flight on the device: each batch is copied from pinned memory
  without blocking and read back only after the next one is queued.  Files
  that fail to decode are skipped and logged to ``failed.txt``.
* ``ImageFeatureExtractor`` writes one ``[1, 768, 1, 1]`` ``.npy`` per image
  mirroring the source tree; ``StudyFeatureExtractor`` one fused vector per
  study.

Everything runs on the CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import threading
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.clip import resolve_dtype
from ..models.convnext import ConvNeXt, ConvNeXtConfig, valid_mask
from ..ops.fusion import fuse_views
from ..ops.preprocess import intensity_transform, normalize_16bit, to_16bit
from ..ops.resize import (fit_shape, host_block_sum, resize_to_canvas,
                          resize_to_canvas_from_block_sums)
from ..utils.flax_msgpack import read_file
from ..utils.logging import logger
from ..utils.seeding import create_directory_if_not_exists
from .png_reader import decode_png


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none: the port
    runs on the CPU only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def shard_items_for_host(items, process_index: Optional[int] = None,
                         process_count: Optional[int] = None):
    """Every ``process_count``-th item from ``process_index``: each process
    walks the same sorted list and encodes its own slice.  Defaults to this
    process's rank in ``torch.distributed`` (0 of 1 when not initialised)."""
    if process_index is None or process_count is None:
        dist = torch.distributed
        initialised = dist.is_available() and dist.is_initialized()
        process_index = dist.get_rank() if initialised else 0
        process_count = dist.get_world_size() if initialised else 1
    return [item for i, item in enumerate(items) if i % process_count == process_index]


def load_convnext_tower(config, seed: int = 0, device="cpu"):
    """-> (module on ``device`` in eval mode, ConvNeXtConfig)."""
    path = str(config.networks.image_encoder.convnext_tiny_clf_path or "")
    overrides = config.get_path("networks.image_encoder.config", {}) or {}
    cn_config = ConvNeXtConfig.micro() if overrides.get("micro") else ConvNeXtConfig.tiny()
    if overrides.get("in_channels"):
        cn_config = replace(cn_config, in_channels=int(overrides["in_channels"]))
    if overrides.get("dtype"):
        cn_config = replace(cn_config, dtype=resolve_dtype(overrides["dtype"]))
    fused = bool(overrides.get("use_fused_blocks"))
    if overrides.get("quant"):
        cn_config = replace(cn_config, quant=str(overrides["quant"]))
        if not fused:
            logger.warning(
                "quant=int8 WITHOUT use_fused_blocks runs the unfused int8 path, a "
                "measured slowdown in the JAX package: the dynamic quantize pass adds "
                "device-memory round trips without shrinking activation traffic. Set networks.image_encoder.config.use_fused_blocks=true (or "
                "use the clip_convnext_fused_bert presets) to get the in-kernel int8 "
                "path.")
    if fused:
        cn_config = replace(cn_config, use_fused_blocks=True)
    if overrides.get("fuse_downsample"):
        cn_config = replace(cn_config, fuse_downsample=True)
    if overrides.get("fuse_stem"):
        cn_config = replace(cn_config, fuse_stem=True)
    if (overrides.get("fuse_stem") or overrides.get("fuse_downsample")) and not fused:
        logger.warning(
            "fuse_stem/fuse_downsample have no effect without use_fused_blocks=true: "
            "the glue kernels are gated on the fused-block path (models/convnext.py). "
            "Set networks.image_encoder.config.use_fused_blocks=true (or use the "
            "clip_convnext_fused_* presets) to activate them.")
    if overrides.get("fuse_downsample") and fused and (
            config.get_path("dataset.config.encode_resize", None)
            or config.get_path("dataset.config.encode_bucket_rounding", 0)):
        logger.warning(
            "fuse_downsample has no effect on masked-tower encodes: encode_resize / "
            "encode_bucket_rounding run the valid_hw path, which keeps the plain "
            "downsample (models/convnext.py). The knob only applies to exact-shape "
            "unmasked encodes.")
    if overrides.get("gelu"):
        gelu = str(overrides["gelu"])
        if gelu not in ("exact", "tanh"):
            raise ValueError(
                "networks.image_encoder.config.gelu must be 'exact' or "
                f"'tanh', got {gelu!r}")
        cn_config = replace(cn_config, gelu=gelu)
    tree = None
    if path and os.path.isfile(path) and path.endswith(".npz"):
        tree = read_file(path)
        # the stored stem kernel is the source of truth for the input channels
        stem_in = int(tree["params"]["stem_conv"]["kernel"].shape[2])
        if stem_in != cn_config.in_channels:
            logger.info(f"Converted stem expects {stem_in} input channel(s); adapting "
                        f"tower config (was {cn_config.in_channels}).")
            cn_config = replace(cn_config, in_channels=stem_in)
    module = ConvNeXt(cn_config, torch.Generator().manual_seed(seed))
    if tree is not None:
        from ..weights import load_flax_tree

        load_flax_tree(module, tree["params"])
        logger.info(f"Loaded ConvNeXt weights from {path}.")
    else:
        logger.warning(f"ConvNeXt weight file {path!r} not found; using seeded random init.")
    return module.to(device).eval(), cn_config


def parse_ingest_knobs(config):
    """``dataset.config.encode_*`` -> ``(resize_hw, resize_method,
    resize_precision, window, prepool)``, validated as in the JAX package
    (``resize_precision`` is the string ``"highest"`` or None)."""
    resize = config.get_path("dataset.config.encode_resize", None)
    if resize is None:
        resize_hw = None
    elif isinstance(resize, (list, tuple)):
        resize_hw = (int(resize[0]), int(resize[1]))
    else:
        resize_hw = (int(resize), int(resize))
    resize_method = str(config.get_path("dataset.config.encode_resize_method", "area") or "area")
    precision = str(config.get_path("dataset.config.encode_resize_precision", "default") or "default")
    if precision not in ("default", "highest"):
        raise ValueError(
            "dataset.config.encode_resize_precision must be 'default' or "
            f"'highest', got {precision!r}")
    resize_precision = "highest" if precision == "highest" else None
    window = config.get_path("dataset.config.encode_window", None)
    window = (float(window[0]), float(window[1])) if window else None
    prepool = int(config.get_path("dataset.config.encode_host_prepool", 0) or 0)
    if prepool:
        if not 2 <= prepool <= 16:
            raise ValueError(
                "dataset.config.encode_host_prepool must be in [2, 16] "
                f"(block sums must fit uint16/uint32), got {prepool}")
        if resize_hw is None:
            raise ValueError(
                "dataset.config.encode_host_prepool requires "
                "dataset.config.encode_resize")
    return resize_hw, resize_method, resize_precision, window, prepool


def host_prepool(pixels: np.ndarray, k: int) -> Tuple[np.ndarray, float]:
    """Host half of the prepooled chain: exact k x k block sums of a
    [n, H, W] uint8/uint16 batch and the scale to the 16-bit intensity domain.

    8-bit sources sum into uint16 (scale 257, as ``to_16bit``); 16-bit sources
    into uint32, passed on as int32 (the sums are at most 256 * 65535 < 2^31,
    so the view is exact; PyTorch's uint32 has few CUDA ops), scale 1."""
    sums = host_block_sum(pixels, k)
    if sums.dtype == np.uint32:
        return sums.view(np.int32), 1.0
    return sums, 257.0


def _channels(x: torch.Tensor, in_ch: int) -> torch.Tensor:
    x = x[..., None]
    return x.repeat_interleave(in_ch, dim=-1) if in_ch > 1 else x


def build_encode_program(module, in_ch: int, window=None, resize_hw=None,
                         resize_method: str = "area", resize_precision: Optional[str] = None,
                         prepool: int = 0):
    """The encode program on the module's device.

    Without ``resize_hw``: ``encode(pixels [n, H, W] uint8/uint16) -> [n, d]``,
    intensity transform (optionally windowed) then the tower.  With it: raw
    pixels -> aspect-preserving resample onto the canvas -> windowing ->
    normalisation -> the canvas pad zeroed -> the masked tower.  With
    ``prepool`` k (requires ``resize_hw``): ``encode(sums, native_hw=(H, W),
    scale=...)`` takes the batch's ``host_prepool`` block sums instead of
    pixels and resamples the block-mean image."""
    if resize_hw is None:

        @torch.inference_mode()
        def encode(pixels: torch.Tensor) -> torch.Tensor:
            return module(_channels(intensity_transform(pixels, window=window), in_ch))

        return encode

    def tower(y: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
        x = normalize_16bit(y, window=window)
        # zero the canvas pad AFTER normalisation (raw zeros map to -1)
        x = x * valid_mask(x[..., None], valid_hw)[..., 0]
        return module(_channels(x, in_ch), valid_hw=valid_hw)

    if prepool:

        @torch.inference_mode()
        def encode_prepooled(sums: torch.Tensor, *, native_hw, scale: float) -> torch.Tensor:
            y, valid_hw = resize_to_canvas_from_block_sums(
                sums, native_hw, resize_hw, prepool, method=resize_method,
                precision=resize_precision)
            return tower(y * scale, valid_hw)

        return encode_prepooled

    @torch.inference_mode()
    def encode_resized(pixels: torch.Tensor) -> torch.Tensor:
        y, valid_hw = resize_to_canvas(to_16bit(pixels), resize_hw, method=resize_method,
                                       precision=resize_precision)
        return tower(y, valid_hw)

    return encode_resized


def build_masked_encode_program(module, in_ch: int, window=None):
    """``encode(pixels [n, H, W], valid_hw [n, 2]) -> [n, d]``: zero-padded
    canvases encoded exactly as if each image ran at its own shape (the
    masked tower; bucket rounding)."""

    @torch.inference_mode()
    def encode(pixels: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
        x = intensity_transform(pixels, window=window)
        # zero the pad AFTER the transform: raw zeros map to -1.0
        x = x * valid_mask(x[..., None], valid_hw)[..., 0]
        return module(_channels(x, in_ch), valid_hw=valid_hw)

    return encode


class _Encoder:
    """Shared batched-encode machinery for image- and study-level extractors
    (one device; multi-GPU data sharding waits for the parallel layer)."""

    def __init__(self, config, batch_size: int = 32, decode_threads: int = 8,
                 bucket_rounding: int = 0, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.batch_size = int(batch_size)
        self.decode_threads = int(decode_threads)
        # > 0: round image shapes up to multiples of this and encode through
        # the masked tower: bounds the number of distinct bucket shapes
        self.bucket_rounding = int(
            config.get_path("dataset.config.encode_bucket_rounding", bucket_rounding)
            or bucket_rounding)
        (self.resize_hw, self.resize_method, self.resize_precision,
         self.window, self.prepool) = parse_ingest_knobs(config)
        if self.resize_hw and self.bucket_rounding:
            # resize already maps every image onto ONE canvas; input buckets
            # stay exact-shape so each native shape gets exact resample weights
            logger.info("encode_resize set: ignoring encode_bucket_rounding "
                        "(resize buckets by exact native shape).")
            self.bucket_rounding = 0
        self.module, self.cn_config = load_convnext_tower(config, device=self.device)
        self._prepool_warned: set = set()  # one k-vs-scale warning per shape
        self._failed_lock = threading.Lock()

    def _encode_fn(self):
        return build_encode_program(self.module, self.cn_config.in_channels, window=self.window)

    def _resized_encode_fn(self):
        return build_encode_program(
            self.module, self.cn_config.in_channels, window=self.window,
            resize_hw=self.resize_hw, resize_method=self.resize_method,
            resize_precision=self.resize_precision, prepool=self.prepool)

    def _masked_encode_fn(self):
        return build_masked_encode_program(self.module, self.cn_config.in_channels,
                                           window=self.window)

    def _to_device(self, array: np.ndarray):
        """Host batch -> (device tensor, host buffer to keep alive until the
        batch is drained).  On the card the copy leaves pinned memory without
        blocking, so it overlaps the previous batch's compute."""
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            host = host.pin_memory()
            return host.to(self.device, non_blocking=True), host
        return host.to(self.device), host

    def _warn_coarse_prepool(self, native_hw, shape) -> None:
        vh, vw = fit_shape(native_hw, self.resize_hw)
        scale = min(native_hw[0] / vh, native_hw[1] / vw)
        if self.prepool > scale and shape not in self._prepool_warned:
            # blocks coarser than the output grid: the resample upscales block
            # means, a real fidelity loss beyond the antialias approximation
            self._prepool_warned.add(shape)
            logger.warning(
                f"encode_host_prepool={self.prepool} exceeds the downscale factor "
                f"{scale:.2f} for native shape {tuple(native_hw)} -> {self.resize_hw}: "
                "output cells are finer than the prepool blocks, features degrade "
                "beyond the documented bound. Use a smaller block (k <= downscale factor).")

    def encode_batches(self, items: List[Tuple[str, str]], on_result, failed_path: str):
        """items: (source_path, export_key).  Decoded on a thread pool,
        bucketed, encoded in batches; ``on_result(key, vector)`` per image."""
        rounding = self.bucket_rounding
        if self.resize_hw:
            encode = self._resized_encode_fn()
        elif rounding:
            encode = self._masked_encode_fn()
        else:
            encode = self._encode_fn()
        buckets: Dict[Tuple, List[Tuple[str, np.ndarray]]] = defaultdict(list)
        pending: deque = deque()  # (chunk, device result, host buffer)

        def drain_one():
            chunk, result, _host = pending.popleft()
            feats = result.float().cpu().numpy()
            for (key, _px), vec in zip(chunk, feats):
                on_result(key, vec)

        def submit(chunk, shape):
            if rounding:
                canvas = np.zeros((len(chunk), *shape[:2]), chunk[0][1].dtype)
                for i, (_k, arr) in enumerate(chunk):
                    canvas[i, : arr.shape[0], : arr.shape[1]] = arr
                valid_hw = np.asarray([arr.shape[:2] for _k, arr in chunk], np.int32)
                pixels, host = self._to_device(canvas)
                result = encode(pixels, torch.from_numpy(valid_hw).to(self.device))
            else:
                stack = np.stack([arr for _k, arr in chunk])
                if self.resize_hw and self.prepool:
                    # host half of the prepooled chain: the copy carries the
                    # block sums, 2-4 bytes per k^2 pixels
                    native_hw = tuple(int(d) for d in stack.shape[1:3])
                    self._warn_coarse_prepool(native_hw, shape)
                    sums, scale = host_prepool(stack, self.prepool)
                    device_sums, host = self._to_device(sums)
                    result = encode(device_sums, native_hw=native_hw, scale=scale)
                else:
                    pixels, host = self._to_device(stack)
                    result = encode(pixels)
            pending.append((chunk, result, host))
            while len(pending) > 2:
                drain_one()  # read back older batches while this one runs

        def flush(shape):
            bucket = buckets.pop(shape)
            for start in range(0, len(bucket), self.batch_size):
                submit(bucket[start: start + self.batch_size], shape)

        def bucket_shape(pixels):
            # dtype is part of the key: stacking mixed uint8/uint16 would
            # promote to uint16 and mis-scale the intensity transform
            if not rounding:
                return (*pixels.shape[:2], pixels.dtype.str)
            return (*(-(-d // rounding) * rounding for d in pixels.shape[:2]), pixels.dtype.str)

        with ThreadPoolExecutor(max_workers=self.decode_threads) as pool:
            # bounded in-flight window: submitting every item at once would
            # hold the whole dataset's decoded pixels when the device is slower
            window = max(2 * self.batch_size, 2 * self.decode_threads)
            inflight: deque = deque()
            item_iter = iter(items)

            def refill():
                while len(inflight) < window:
                    item = next(item_iter, None)
                    if item is None:
                        return
                    inflight.append((item, pool.submit(self._safe_decode, item[0], failed_path)))

            refill()
            while inflight:
                (_src, key), future = inflight.popleft()
                pixels = future.result()
                refill()  # keep the decode window full while we consume
                if pixels is None:
                    continue
                shape = bucket_shape(pixels)
                buckets[shape].append((key, pixels))
                if len(buckets[shape]) >= self.batch_size:
                    flush(shape)
        for shape in list(buckets):
            flush(shape)
        while pending:
            drain_one()

    def _safe_decode(self, path: str, failed_path: str) -> Optional[np.ndarray]:
        """Decode, or log the failure to ``failed_path`` and return None (the
        reference's skip-and-log contract)."""
        try:
            return decode_png(path)
        except Exception as exc:  # any unreadable file is skipped, not fatal
            with self._failed_lock, open(failed_path, "a") as fh:
                fh.write(path + "\n" + str(exc) + "\n\n")
            return None


def _rows_with(dataset, column: str) -> List[Mapping]:
    rows = list(dataset) if dataset is not None else None
    if rows is None or not all(isinstance(row, Mapping) and column in row for row in rows):
        raise ValueError(f"Pass the dataset rows (mappings with an {column!r} key), "
                         "as data.ingest.create_dataset_df returns them.")
    return rows


class ImageFeatureExtractor(_Encoder):
    """Per-image 768-d feature export (reference: image_features.py:11-122)."""

    def __init__(self, config=None, dataset: Optional[Sequence[Mapping]] = None,
                 batch_size: int = 32, device=None):
        if config is None:
            raise ValueError("Missing config object.")
        super().__init__(config, batch_size=batch_size, device=device)
        self.dataset = _rows_with(dataset, "image_path")
        self.export_dir = create_directory_if_not_exists(config.base.features_export_dir)

    def _export_path(self, image_path: str) -> str:
        tail = image_path.split("2D_100micron/")[-1]
        if os.path.isabs(tail):  # no marker in path: mirror the last 4 components
            tail = os.path.join(*image_path.strip(os.sep).split(os.sep)[-4:])
        # whole-path replace (not just the extension): the reference's export
        # convention, so stored layouts stay interchangeable
        return os.path.join(self.export_dir, tail).replace(".png", ".npy")

    def extract(self) -> int:
        logger.info(f"Extracting features into {self.export_dir}.")
        failed = os.path.join(self.export_dir, "failed.txt")
        items = [(row["image_path"], self._export_path(row["image_path"])) for row in self.dataset]
        items = shard_items_for_host(items)
        count = 0

        def save(key: str, vec: np.ndarray):
            nonlocal count
            os.makedirs(os.path.dirname(key), exist_ok=True)
            # [1, 768, 1, 1], the reference's layout
            np.save(key, vec.reshape(1, -1, 1, 1).astype(np.float32))
            count += 1

        self.encode_batches(items, save, failed)
        logger.info(f"Encoded {count}/{len(items)} images.")
        return count


class StudyFeatureExtractor(_Encoder):
    """Per-study fused features (reference: image_features.py:126-265)."""

    def __init__(self, config=None, dataset: Optional[Sequence[Mapping]] = None,
                 batch_size: int = 32, device=None):
        if config is None:
            raise ValueError("Missing config object.")
        super().__init__(config, batch_size=batch_size, device=device)
        self.dataset = _rows_with(dataset, "study_path")
        self.export_dir = config.base.features_export_dir

    def extract(self) -> int:
        method = self.config.dataset.config.concatenate_features_method
        n_views = int(self.config.dataset.config.n_images_per_study)
        logger.info(f"Concatenating {n_views} images per study using {method}.")
        failed = os.path.join(create_directory_if_not_exists(self.export_dir), "failed.txt")

        # every (view, study) pair goes through the shared bucketed pipeline,
        # then views fuse per study; sharding is per study (a study's views
        # must meet in one process)
        items: List[Tuple[str, str]] = []
        study_paths: List[str] = []
        for row in shard_items_for_host(self.dataset):
            study_path = row["study_path"]
            try:
                views = sorted(os.listdir(study_path))[:n_views]
            except OSError as exc:
                with open(failed, "a") as fh:
                    fh.write(str(study_path) + "\n" + str(exc) + "\n\n")
                continue
            study_paths.append(study_path)
            for view in views:
                view_path = os.path.join(study_path, view)
                items.append((view_path, f"{study_path}\x00{view_path}"))

        view_vectors: Dict[str, Dict[str, np.ndarray]] = defaultdict(dict)

        def collect(key: str, vec: np.ndarray):
            study_path, view_path = key.split("\x00")
            view_vectors[study_path][view_path] = vec

        self.encode_batches(items, collect, failed)

        count = 0
        for study_path in study_paths:
            per_view = view_vectors.get(study_path)
            if not per_view:
                continue
            try:
                stack = np.stack([per_view[k] for k in sorted(per_view)])
                fused = fuse_views(torch.from_numpy(stack), method).numpy()
                tail = study_path.split("2D_100micron/")[-1]
                if os.path.isabs(tail):
                    tail = os.path.join(*study_path.strip(os.sep).split(os.sep)[-3:])
                patient_id = next((part for part in study_path.split(os.sep)
                                   if part.isdigit() and len(part) == 8), "study")
                out = os.path.join(self.export_dir, tail, f"{patient_id}.npy")
                os.makedirs(os.path.dirname(out), exist_ok=True)
                np.save(out, fused.astype(np.float32))
                count += 1
            except (OSError, ValueError) as exc:
                with open(failed, "a") as fh:
                    fh.write(str(study_path) + "\n" + str(exc) + "\n\n")
        return count


# lower-case aliases kept for facade parity (reference: image_features.py:267-268)
image_feature_extractor = ImageFeatureExtractor
study_feature_extractor = StudyFeatureExtractor
