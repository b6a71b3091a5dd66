"""Benchmarks of the port (counterpart of the repository's ``bench.py``).

    python -m mmgclip_tpu_torch.bench                                  # encode, on the card
    BENCH_MODE=text python -m mmgclip_tpu_torch.bench
    BENCH_PLATFORM=cpu BENCH_MODE=report python -m mmgclip_tpu_torch.bench

Prints ONE JSON line per run:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

Modes (env BENCH_MODE):
  encode (default) — uint8 pixels -> ``ops.preprocess.intensity_transform``
    -> ConvNeXt-Tiny (``ingest.encode.build_encode_program``, the feature
    store's program), the fused tower (kernels ``fused_convnext_block``,
    ``fused_stem``, ``fused_ln_downsample``) end to end from pinned host
    buffers, beside the plain tower, the int8 / tanh variants, the H2D
    rate, a bf16 matmul roofline measured on the card and the analytic
    per-layer costs priced at the card's data-sheet peaks.
  train — samples/s of the trainer's fused epoch over cached banks
    (``training/experiment.ClassifierExperiment.train``, the stock binary
    preset; one CUDA graph replay a step), against the trainer's step with
    the frozen BERT-base forward re-run every batch.
  report — the report cascade as one device call
    (``evaluation/report_cascade.run_cascade``) against 9 stepwise round
    trips.
  text — BERT-base at the prompt banks' lengths: pad-trimmed
    (``models/bert.trim_padded_tail``) against pad-to-BENCH_SEQ, the flash
    kernel against the plain attention, SDPA beside them.
  serve — ``serve.serve_socket`` over TCP JSONL on a warm
    ``InferenceEngine``: BENCH_SERVE_CLIENTS concurrent ``classify``
    sessions against one sequential session, plus ``report``, ``encode``
    (PNG path) and fresh-prompt ``classify`` (the text tower runs) latencies.
  ingest — native-size uint8 -> ``ops.resize.resize_to_canvas`` (or host
    block sums with BENCH_HOST_PREPOOL) -> ``normalize_16bit`` -> the fused
    tanh tower, one program, end to end from pinned host buffers.

Runs on the CUDA card; ``BENCH_PLATFORM=cpu`` asks for the CPU (the tests
do).  With no card and no such request it raises: a CPU rate is never
printed as the card's.  Every record's ``detail`` names the device
(``device``: the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit`` prints them, or ``"cpu"``) and the kernel
launches of the timed program behind ``value`` (``launches``:
``ops.launch_counts()`` set to 0 just before its timed section and read
just after); the other programs' launches stand under their own keys.
Device times are CUDA events; end-to-end times are the host clock after a
synchronize.  A reading above the ceiling it is held to is reported as
read and named in ``above_ceiling``.

vs_baseline: every mode divides by a reference-shaped execution measured in
the same process (``detail.vs_baseline_basis``): encode / ingest — one image
at a time through the plain tower, each copied in and its features read back
(reference: mmgclip/networks/image_features.py:87-117); train — the step
that re-runs the frozen BERT-base forward (reference:
ClassifierExperiment.py:93-132); report — 9 stepwise round trips
(reference: generate_report.py:204-367); text — plain attention padded to
BENCH_SEQ; serve — the sequential per-request rate.

Env knobs: BENCH_IMAGE_SIZE (256, or 'HxW'), BENCH_BATCH, BENCH_ITERS,
BENCH_WINDOWS, BENCH_DTYPE (bfloat16|float32), BENCH_FUSED (1),
BENCH_VARIANTS (comma list of fused_int8, fused_tanh, fused_int8_tanh),
BENCH_ROOFLINE_N / _ITERS / _WINDOWS; train: BENCH_TRAIN_STEPS,
BENCH_TRAIN_BANK, BENCH_SEQ, BENCH_REF_LAYERS; serve: BENCH_SERVE_CLIENTS,
BENCH_SERVE_REQS, BENCH_SERVE_TINY; ingest:
BENCH_NATIVE_SIZE (2294x1914), BENCH_CANVAS (256), BENCH_WINDOW,
BENCH_TINY, BENCH_RESIZE_PRECISION (default|highest), BENCH_HOST_PREPOOL.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .ops import launch_counts, reset_launch_counts

# the data-sheet peaks (dense) of the card the port targets, under the name
# it gives itself; PERF.md §3 layer 9
CARD = "NVIDIA H100 80GB HBM3"
PEAKS = {CARD: {"variant": "H100 SXM5", "bytes": 3.35e12, "fp32": 67e12,
                "bf16": 989e12, "int8": 1979e12}}
REF_MIN_IMAGES = 32  # the reference-shaped loop's least number of images
KNOWN_VARIANTS = ("fused_int8", "fused_tanh", "fused_int8_tanh")
# fused variants: every block, the stem and the downsamples in their kernels
_FUSED = {"use_fused_blocks": True, "fuse_stem": True, "fuse_downsample": True}
_VARIANT_KNOBS = {
    "fused": {},
    "fused_int8": {"quant": "int8"},
    "fused_tanh": {"gelu": "tanh"},
    "fused_int8_tanh": {"quant": "int8", "gelu": "tanh"},
}


# ----------------------------------------------------------------------
# device, clocks, knobs

def bench_device() -> torch.device:
    """The card, or the CPU when BENCH_PLATFORM=cpu asks for it; raises
    with no card and no such request."""
    platform = os.environ.get("BENCH_PLATFORM", "").strip().lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform:
        raise ValueError(f"BENCH_PLATFORM must be 'cpu' or unset, got {platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("the bench measures a CUDA card and none is available; "
                           "set BENCH_PLATFORM=cpu to run it on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def device_detail(device: torch.device):
    """``{"name", "power_limit"}`` as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    name, limit = (part.strip() for part in lines[device.index or 0].rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def peaks_for(device: torch.device) -> dict:
    """The card's data-sheet peaks (on the CPU, the target card's: the
    projections price the card); raises on a card with no entry."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else CARD
    if name not in PEAKS:
        raise ValueError(f"no data-sheet peaks for {name!r}; known: {sorted(PEAKS)}")
    return PEAKS[name]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_seconds(fn: Callable, device: torch.device, iters: int) -> float:
    """Seconds of ``iters`` back-to-back calls: CUDA events on the card, the
    host clock on the CPU (where calls finish before they return)."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return time.perf_counter() - t0


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _env_on(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes")


def _dtype() -> torch.dtype:
    return torch.bfloat16 if os.environ.get("BENCH_DTYPE", "bfloat16") == "bfloat16" else torch.float32


def _percentiles(samples_s: List[float], qs=(50, 90, 95)) -> List[float]:
    return [float(v) for v in np.percentile(np.asarray(samples_s) * 1e3, qs)]


def _record(metric: str, value: float, unit: str, vs_baseline: float, basis: str,
            device: torch.device, launches: dict, detail: dict) -> dict:
    """One record; ``launches``: the kernel launches of the timed program
    behind ``value`` (``_launches_during`` around its timed section)."""
    return {"metric": metric, "value": value, "unit": unit,
            "vs_baseline": round(vs_baseline, 4),
            "detail": {"device": device_detail(device), "launches": launches,
                       "vs_baseline_basis": basis, **detail}}


# ----------------------------------------------------------------------
# the analytic cost model (the JAX bench's FLOPs; the port's own bytes)

def _parse_hw(value, default: int = 256):
    """BENCH_IMAGE_SIZE accepts '256' (square) or '2294x1914' (true-FFDM
    bucket shapes — the reference encodes at native resolution)."""
    if isinstance(value, (tuple, list)):
        return int(value[0]), int(value[1])
    raw = str(value if value is not None else default).strip().lower()
    if "x" in raw:
        h, w = raw.split("x", 1)
        return int(h), int(w)
    return int(raw), int(raw)


def _convnext_layer_costs(size, in_ch: int = 1, dtype_bytes: int = 2, batch: int = 128, *,
                          fused: bool = False, int8: bool = False, gelu_flops: int = 15,
                          fuse_down: bool = False):
    """Analytic per-image cost rows ``(name, mm_flops, elementwise_flops,
    bytes, int8_mm)`` per layer class of ConvNeXt-Tiny.  Matmul work (stem,
    downsample and pointwise convs) and elementwise work (depthwise conv,
    LayerNorm, GELU, residual) are priced apart; weight bytes amortize over
    the batch.

    The FLOPs are the JAX bench's.  The bytes are this port's kernels':
    the stem reads the fp32 intensities; a fused block (``fused``; the CUDA
    grid covers every shape, so no unfused fallback) reads x, writes and
    reads back its fp32 depthwise workspace, reads x again for the residual
    and writes y; int8 weights are quantised per call (read in the tower
    dtype, written and read as int8).  ``fuse_down`` prices the fused
    LN + 2x2 conv launch, unfused rows price one device-memory round trip
    per op."""
    dims, depths = (96, 192, 384, 768), (3, 3, 9, 3)
    dt = dtype_bytes
    size_h, size_w = _parse_hw(size)
    layers = []
    h, w = -(-size_h // 4), -(-size_w // 4)
    c = dims[0]
    layers.append(("stem_conv", h * w * c * (4 * 4 * in_ch) * 2, 0,
                   size_h * size_w * in_ch * 4 + h * w * c * dt
                   + 4 * 4 * in_ch * c * dt // batch, False))
    layers.append(("stem_ln", 0, h * w * c * 8, 2 * h * w * c * dt, False))
    for s, (c, depth) in enumerate(zip(dims, depths)):
        if s > 0:
            prev = dims[s - 1]
            ln_vpu = h * w * prev * 8
            ln_bytes = 2 * h * w * prev * dt
            h, w = -(-h // 2), -(-w // 2)  # ceil: br_pad at odd sizes
            conv_mm = h * w * c * (2 * 2 * prev) * 2
            conv_bytes = (4 * h * w * prev + h * w * c) * dt + 4 * prev * c * dt // batch
            if fused and fuse_down:
                layers.append((f"down{s}_fused", conv_mm, ln_vpu, conv_bytes, False))
            else:
                layers.append((f"down{s}_ln", 0, ln_vpu, ln_bytes, False))
                layers.append((f"down{s}_conv", conv_mm, 0, conv_bytes, False))
        hw = h * w
        mm = hw * c * 4 * c * 2 * 2  # pw1 + pw2
        vpu = hw * c * 98 + hw * c * 8 + hw * 4 * c * gelu_flops + hw * c * 2
        w_b = 1 if int8 else dt
        if fused:
            quant_w = 8 * c * c * (dt + 1) if int8 else 0  # per-call weight quantisation
            wbytes = (49 * c + 7 * c) * dt + 8 * c * c * w_b + quant_w
            rows = [(f"stage{s}_fused_mm", mm, 0, hw * c * (3 * dt + 8) + wbytes // batch, int8),
                    (f"stage{s}_fused_vpu", 0, vpu, 0, False)]
        else:
            act_b = 1 if int8 else dt
            quant1 = hw * c * (dt + 1) if int8 else 0
            quant2 = hw * 4 * c * (dt + 1) if int8 else 0
            rows = [
                (f"stage{s}_dwconv", 0, hw * c * 98, (2 * hw * c + 49 * c // batch) * dt, False),
                (f"stage{s}_ln", 0, hw * c * 8, 2 * hw * c * dt, False),
                (f"stage{s}_pw1", hw * c * 4 * c * 2, 0,
                 quant1 + hw * c * act_b + hw * 4 * c * dt + 4 * c * c * w_b // batch, int8),
                (f"stage{s}_gelu", 0, hw * 4 * c * gelu_flops, 2 * hw * 4 * c * dt, False),
                (f"stage{s}_pw2", hw * 4 * c * c * 2, 0,
                 quant2 + hw * 4 * c * act_b + hw * c * dt + 4 * c * c * w_b // batch, int8),
                (f"stage{s}_residual", 0, hw * c * 2, 3 * hw * c * dt, False),
            ]
        layers.extend((name, mf * depth, vf * depth, b * depth, q8) for name, mf, vf, b, q8 in rows)
    return layers


def _card_per_layer_projection(size, peaks: dict, *, mm_tflops: Optional[float] = None,
                               int8: bool = False, fused: bool = False, batch: int = 128,
                               gelu_flops: int = 15, fuse_down: bool = False,
                               dtype_bytes: int = 2):
    """Per-layer roofline on the card: each layer takes max(matmul time +
    elementwise time, bytes time).  Matmuls at the data-sheet tensor-core
    peak (bf16, int8 rows at int8), or at ``mm_tflops`` (a measured bf16
    roofline; int8 rows at twice it); elementwise work at the fp32 peak
    outside the tensor cores; bytes at the HBM peak.  Returns (img/s,
    per-group summary with each group's binding resource and share of the
    image time)."""
    mm_bf16 = mm_tflops * 1e12 if mm_tflops else peaks["bf16"]
    mm_int8 = 2 * mm_tflops * 1e12 if mm_tflops else peaks["int8"]
    t_total = 0.0
    summary: Dict[str, dict] = {}
    for name, mm_f, el_f, bytes_, int8_mm in _convnext_layer_costs(
            size, dtype_bytes=dtype_bytes, batch=batch, fused=fused, int8=int8,
            gelu_flops=gelu_flops, fuse_down=fuse_down):
        t_mm = mm_f / (mm_int8 if int8_mm else mm_bf16)
        t_el, t_bw = el_f / peaks["fp32"], bytes_ / peaks["bytes"]
        t = max(t_mm + t_el, t_bw)
        t_total += t
        g = summary.setdefault(name.split("_")[0], {"gflops": 0.0, "mm_gflops": 0.0, "mbytes": 0.0,
                                                    "_t": {"tensor_cores": 0.0, "fp32_cores": 0.0,
                                                           "hbm": 0.0}})
        g["gflops"] += (mm_f + el_f) / 1e9
        g["mm_gflops"] += mm_f / 1e9
        g["mbytes"] += bytes_ / 1e6
        g["_t"][max((t_bw, "hbm"), (t_mm, "tensor_cores"), (t_el, "fp32_cores"))[1]] += t
    for g in summary.values():
        times = g.pop("_t")
        g["bound"] = max(times, key=times.get)
        g["time_frac"] = round(sum(times.values()) / max(t_total, 1e-30), 4)
        for key in ("gflops", "mm_gflops", "mbytes"):
            g[key] = round(g[key], 3)
    return 1.0 / t_total, summary


# ----------------------------------------------------------------------
# shared measurements

def _matmul_roofline_tflops(device: torch.device, dtype: torch.dtype, batch: int = 8) -> float:
    """Measured matmul peak: independent batched ``torch.matmul``s of
    seeded normal operands in the tower dtype (no serial chain), best of
    windows, device time."""
    n = _env_int("BENCH_ROOFLINE_N", 4096)
    iters = _env_int("BENCH_ROOFLINE_ITERS", 8)
    windows = _env_int("BENCH_ROOFLINE_WINDOWS", 3)
    gen = torch.Generator(device).manual_seed(0)
    x = torch.randn((batch, n, n), generator=gen, dtype=dtype, device=device)
    w = torch.randn((n, n), generator=gen, dtype=dtype, device=device)
    out = torch.empty_like(x)
    torch.matmul(x, w, out=out)
    _sync(device)
    best = min(device_seconds(lambda: torch.matmul(x, w, out=out), device, iters)
               for _ in range(windows))
    return batch * iters * 2 * n ** 3 / best / 1e12


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``; on the CPU a copy, so a "transfer" moves
    bytes there too."""
    return host.to(device, non_blocking=True) if device.type == "cuda" else host.clone()


def _pinned(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.pin_memory() if device.type == "cuda" else t


def _true_h2d_rate(device: torch.device, host: torch.Tensor, iters: int, windows: int):
    """Host-to-device bytes/s from pinned buffers: ``iters`` copies of the
    whole buffer and of its first half, device time, best of windows each,
    then the difference (fixed per-copy cost cancels).  Falls back to the
    whole-window rate when the difference is noise."""
    half = _pinned(host[: max(1, host.shape[0] // 2)].clone(), device)
    times = {}
    for name, buf in (("full", host), ("half", half)):
        _to_device(buf, device)
        times[name] = min(device_seconds(lambda b=buf: _to_device(b, device), device, iters)
                          for _ in range(windows))
    nbytes = host.numel() * host.element_size()
    delta_bytes = iters * (nbytes - half.numel() * half.element_size())
    whole = iters * nbytes / times["full"]
    delta_t = times["full"] - times["half"]
    if delta_bytes > 0 and delta_t > 1e-6 and delta_bytes / delta_t <= 4 * whole:
        return delta_bytes / delta_t, "size-differenced device time (fixed per-copy cost cancelled)"
    return whole, "whole-window device time (size difference below noise)"


def _feature_deviation(ref: torch.Tensor, feats: torch.Tensor) -> Tuple[float, float]:
    """(max |ref - feats| / max |ref|, min per-row cosine)."""
    a, b = ref.float(), feats.float()
    rel = (a - b).abs().max() / a.abs().max().clamp(min=1e-9)
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp(min=1e-9)
    return float(rel), float(cos.min())


def _launches_during(fn: Callable):
    """(fn(), {kernel: launches during the call} for the kernels it ran):
    the counts set to 0 just before the call and read just after."""
    reset_launch_counts()
    out = fn()
    return out, {k: v for k, v in launch_counts().items() if v}


def _host_buffers(device: torch.device, shape, n_buf: int, seed: int = 0):
    """``n_buf`` seeded uint8 batches: numpy and torch (pinned on the card)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(0, 256, size=shape, dtype=np.uint8) for _ in range(n_buf)]
    return arrays, [_pinned(torch.from_numpy(a), device) for a in arrays]


class _Feed:
    """Feeds host batches to an encode program, timed on the host clock
    after a synchronize.  ``double_buffered``: the copy of batch i+1 from a
    pinned buffer runs on a copy stream while batch i computes; serial:
    each batch is copied from pageable memory, then encoded."""

    def __init__(self, device: torch.device, arrays, pinned, rows: int, iters: int,
                 payload: Callable = lambda t: t):
        self.device, self.arrays, self.pinned = device, arrays, pinned
        self.rows, self.iters, self.payload = rows, iters, payload
        self.copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def _fetch(self, i: int, pinned: bool) -> torch.Tensor:
        host = self.pinned[i % len(self.pinned)] if pinned else torch.from_numpy(
            self.arrays[i % len(self.arrays)])
        return _to_device(self.payload(host), self.device)

    def window(self, fn: Callable, double_buffered: bool) -> float:
        """Images per second of one window of ``iters`` batches."""
        _sync(self.device)
        start = time.perf_counter()
        if double_buffered and self.copy_stream is not None:
            main = torch.cuda.current_stream(self.device)
            dev = self._fetch(0, True)
            for i in range(self.iters):
                if i + 1 < self.iters:
                    with torch.cuda.stream(self.copy_stream):
                        nxt = self._fetch(i + 1, True)
                        ready = torch.cuda.Event()
                        ready.record(self.copy_stream)
                out = fn(dev)
                if i + 1 < self.iters:
                    main.wait_event(ready)
                    nxt.record_stream(main)
                    dev = nxt
        else:
            for i in range(self.iters):
                out = fn(self._fetch(i, double_buffered))
        out.reshape(-1)[:4].float().sum().item()  # the window's one read back
        _sync(self.device)
        return self.rows * self.iters / (time.perf_counter() - start)


def _reference_shaped_rate(device: torch.device, plain: Callable, arrays, n_images: int,
                           payload: Callable = lambda a: a) -> float:
    """Images per second of the reference's execution: one image at a time
    through the plain tower, copied in from pageable memory and its
    features read back before the next."""
    images = [arrays[i // arrays[0].shape[0] % len(arrays)][i % arrays[0].shape[0]]
              for i in range(n_images)]
    plain(_to_device(torch.from_numpy(payload(images[0][None])), device)).cpu()  # warm
    _sync(device)
    t0 = time.perf_counter()
    for image in images:
        plain(_to_device(torch.from_numpy(payload(image[None])), device)).float().cpu()
    return n_images / (time.perf_counter() - t0)


# ----------------------------------------------------------------------
# encode

def _selected_variants() -> Tuple[str, ...]:
    env = os.environ.get("BENCH_VARIANTS")
    if env is None:
        return KNOWN_VARIANTS
    selected = tuple(v.strip() for v in env.split(",") if v.strip())
    unknown = sorted(set(selected) - set(KNOWN_VARIANTS))
    if unknown:
        raise SystemExit(f"BENCH_VARIANTS contains unknown names {unknown}; "
                         f"known: {list(KNOWN_VARIANTS)}")
    return selected


def _convnext(config, device: torch.device):
    """ConvNeXt on ``device`` from seed 0: every config of one base shares
    its parameters (the init depends on the widths only)."""
    from .models.convnext import ConvNeXt

    return ConvNeXt(config, torch.Generator().manual_seed(0)).to(device).eval()


def bench_encode() -> dict:
    from .ingest.encode import build_encode_program
    from .models.convnext import ConvNeXtConfig

    device = bench_device()
    size_h, size_w = _parse_hw(os.environ.get("BENCH_IMAGE_SIZE"))
    batch = _env_int("BENCH_BATCH", 128)
    iters = _env_int("BENCH_ITERS", 16)
    windows = _env_int("BENCH_WINDOWS", 4)
    dtype = _dtype()
    dt_bytes = 2 if dtype == torch.bfloat16 else 4
    variants = _selected_variants()
    bench_fused = os.environ.get("BENCH_FUSED", "1").strip().lower() not in ("0", "false", "no")
    peaks = peaks_for(device)  # an unknown card raises before any work

    # layer_scale_init at a TRAINED magnitude (~0.1), not the training-init
    # 1e-6, so the variants' feature deviations measure the kernels' math
    base = ConvNeXtConfig(in_channels=1, dtype=dtype, layer_scale_init=0.1)

    def program(**knobs):
        return build_encode_program(_convnext(replace(base, **knobs), device), 1)

    encode = program()
    arrays, pinned = _host_buffers(device, (batch, size_h, size_w), n_buf=4)
    device_pixels = torch.from_numpy(arrays[0]).to(device)
    ref_feats = encode(device_pixels)
    encode_fused = program(**_FUSED) if bench_fused else None
    headline = encode_fused or encode
    if encode_fused is not None:
        encode_fused(device_pixels)

    # ---- end to end: probe both feeds, spend the windows on the faster one
    feed = _Feed(device, arrays, pinned, batch, iters)
    feed.window(headline, True)
    feed.window(headline, False)
    db_probe = [feed.window(headline, True) for _ in range(2)]
    serial_probe = [feed.window(headline, False) for _ in range(2)]
    double_buffered = max(db_probe) >= max(serial_probe)

    def timed_passes():
        passes = [[feed.window(headline, double_buffered) for _ in range(windows)]
                  for _ in range(2)]
        if max(map(np.median, passes)) > 1.5 * min(map(np.median, passes)):
            passes.append([feed.window(headline, double_buffered) for _ in range(windows)])
        return passes

    passes, e2e_launches = _launches_during(timed_passes)
    pass_medians = [float(np.median(p)) for p in passes]
    window_rates = [r for p in passes for r in p]
    median_rate = float(np.median(pass_medians))

    # ---- compute only (device-resident input), device time
    def compute_rate(fn):
        return batch * iters / device_seconds(lambda: fn(device_pixels), device, iters)

    unfused_rate = compute_rate(encode)
    fused_detail: Dict[str, object] = {}

    def measure_variant(prefix, fn):
        feats, launched = _launches_during(lambda: fn(device_pixels))
        rel, cos = _feature_deviation(ref_feats, feats)
        rate = compute_rate(fn)
        fused_detail.update({
            f"{prefix}_compute_only_img_per_sec": round(rate, 3),
            f"{prefix}_vs_unfused_compute": round(rate / unfused_rate, 4),
            f"{prefix}_max_feature_rel_err": round(rel, 6),
            f"{prefix}_min_feature_cosine": round(cos, 7),
            f"{prefix}_launches": launched,
        })
        return rate

    # the int8 pointwise variant of the plain tower (ops/quant.py), as the
    # JAX bench's int8_* keys
    encode_int8 = program(quant="int8")
    int8_rel, int8_cos = _feature_deviation(ref_feats, encode_int8(device_pixels))
    int8_rate = compute_rate(encode_int8)
    fused_rate = measure_variant("fused", encode_fused) if encode_fused is not None else None
    if bench_fused:
        for prefix in variants:
            measure_variant(prefix, program(**_FUSED, **_VARIANT_KNOBS[prefix]))
    headline_compute = fused_rate or unfused_rate

    # ---- host-to-device rate, and the feed with a no-op compute
    h2d_bytes_per_sec, h2d_method = _true_h2d_rate(device, pinned[0], iters, max(windows, 3))
    image_bytes = size_h * size_w
    h2d_rate = h2d_bytes_per_sec / image_bytes
    touch = lambda px: px[0, 0, :4].to(torch.int32)  # noqa: E731
    feed.window(touch, True)
    pipeline_rate = float(np.median([feed.window(touch, True) for _ in range(3)]))
    binding_rate = min(headline_compute, pipeline_rate)

    # ---- FLOPs, the measured matmul roofline, the card's per-layer rooflines
    rows = _convnext_layer_costs((size_h, size_w), dtype_bytes=dt_bytes, batch=batch)
    flops = sum(mf + vf for _n, mf, vf, _b, _q in rows)
    roofline = _matmul_roofline_tflops(device, dtype)
    achieved = flops * unfused_rate / 1e12
    projection, per_stage = {}, {}
    for tag, kw in (("", {}), ("fused_", {"fused": True, "fuse_down": True}),
                    ("fused_int8_", {"fused": True, "fuse_down": True, "int8": True}),
                    ("fused_tanh_", {"fused": True, "fuse_down": True, "gelu_flops": 8})):
        sol, stages = _card_per_layer_projection((size_h, size_w), peaks, batch=batch,
                                                 dtype_bytes=dt_bytes, **kw)
        measured, _ = _card_per_layer_projection((size_h, size_w), peaks, mm_tflops=roofline,
                                                 batch=batch, dtype_bytes=dt_bytes, **kw)
        projection[f"card_{tag}sol_img_per_sec"] = round(sol, 1)
        projection[f"card_{tag}roofline_img_per_sec"] = round(measured, 1)
        if tag in ("", "fused_"):
            per_stage[f"card_{tag}per_stage"] = stages
    analytic_bytes = {
        tag: round(sum(b for *_r, b, _q in _convnext_layer_costs(
            (size_h, size_w), dtype_bytes=dt_bytes, batch=batch, **kw)) / 1e6, 3)
        for tag, kw in (("unfused", {}), ("fused", {"fused": True, "fuse_down": True}),
                        ("fused_int8", {"fused": True, "fuse_down": True, "int8": True}))}

    n_ref = max(batch, REF_MIN_IMAGES)
    ref_rate = _reference_shaped_rate(device, encode, arrays, n_ref)
    # readings above their ceilings are reported as read and flagged: each
    # points at a count (FLOPs, bytes) or a timing that is wrong
    flags = [name for name, reading, ceiling in (
        ("mfu_vs_matmul_roofline", achieved, roofline),
        ("median_over_h2d_true", median_rate, h2d_rate),
        ("median_over_binding", median_rate, binding_rate)) if reading > ceiling]
    return _record(
        f"images/sec (CLIP encode, {size_h}x{size_w} uint8 gray, {str(dtype)[6:]}, batch {batch})",
        median_rate, "images/sec", median_rate / ref_rate,
        f"the e2e median over the reference-shaped loop: {n_ref} images one at a time "
        "through the plain tower, each copied in and its features read back "
        "(mmgclip/networks/image_features.py:87-117), same process", device, e2e_launches, {
            "windows_img_per_sec": [round(r, 3) for r in window_rates],
            "pass_medians_img_per_sec": [round(m, 3) for m in pass_medians],
            "median_img_per_sec": round(median_rate, 3),
            "best_window_img_per_sec": round(max(window_rates), 3),
            "feed_mode": "double_buffered" if double_buffered else "serial",
            "feed_probe_img_per_sec": {"double_buffered": [round(r, 3) for r in db_probe],
                                       "serial": [round(r, 3) for r in serial_probe]},
            "e2e_tower": "fused" if encode_fused is not None else "unfused",
            "reference_shaped_img_per_sec": round(ref_rate, 3),
            "reference_shaped_images": n_ref,
            "compute_only_img_per_sec": round(unfused_rate, 3),
            "headline_compute_only_img_per_sec": round(headline_compute, 3),
            "h2d_true_img_per_sec": round(h2d_rate, 3),
            "h2d_pipeline_img_per_sec": round(pipeline_rate, 3),
            "h2d_gbytes_per_sec": round(h2d_rate * image_bytes / 1e9, 4),
            "h2d_method": h2d_method,
            "bound": "h2d" if pipeline_rate < headline_compute else "compute",
            "binding_img_per_sec": round(binding_rate, 3),
            "overlap_efficiency": round(median_rate / binding_rate, 4),
            "analytic_flops_per_image_g": round(flops / 1e9, 4),
            "analytic_bytes_per_image_mb": analytic_bytes,
            "achieved_tflops_compute_only": round(achieved, 3),
            "matmul_roofline_tflops": round(roofline, 3),
            "mfu_vs_matmul_roofline": round(achieved / roofline, 4),
            "above_ceiling": flags,
            "int8_compute_only_img_per_sec": round(int8_rate, 3),
            "int8_max_feature_rel_err": round(int8_rel, 6),
            "int8_min_feature_cosine": round(int8_cos, 7),
            **fused_detail,
            **projection,
            **per_stage,
            "card_projection_basis": (
                f"per-layer roofline at the {peaks['variant']} data-sheet peaks "
                f"({peaks['bf16'] / 1e12:g} bf16 / {peaks['int8'] / 1e12:g} int8 tensor-core "
                f"TFLOP/s, {peaks['fp32'] / 1e12:g} fp32 TFLOP/s for elementwise work, "
                f"{peaks['bytes'] / 1e12:g} TB/s HBM): each layer max(matmul + elementwise "
                "time, bytes time); *_roofline_* price the matmuls at the measured bf16 "
                "roofline (int8 at twice it). Bytes are the analytic model of this port's "
                "kernels (_convnext_layer_costs); fused = blocks, stem and downsamples "
                "in their kernels"),
            "note": (
                "value = median of the pass medians of end-to-end windows (host clock after "
                "a synchronize, the feed chosen by the probe); compute-only rates are CUDA "
                "event time on device-resident input; flops are analytic (the JAX "
                "bench's model), achieved TFLOP/s = flops x the plain tower's rate; "
                "launches: the timed e2e windows of the e2e tower, *_launches: one call "
                "of a variant; above_ceiling: readings over the ceiling they are held "
                "to, reported unclamped"),
        })


# ----------------------------------------------------------------------
# train

class _BankRows:
    """What a label dataset hands the trainer's fused epoch
    (``data/datasets.py``): ``_features`` ``[n, 768]`` and ``_tokens``."""

    def __init__(self, features: np.ndarray, tokens: Dict[str, np.ndarray]):
        self._features, self._tokens = features, tokens

    def __len__(self) -> int:
        return len(self._features)


def bench_train() -> dict:
    """Samples/s of the trainer's fused epoch (``ClassifierExperiment.train``
    on the stock ``train_binary_class_clf`` preset: 768 -> 512 linear heads,
    which draw no dropout, the CLIP loss, AdamW, the step's key split by
    the threefry kernel) over BENCH_TRAIN_BANK seeded rows.
    The trainer caches the frozen BERT tower's features in a device bank
    once; each step of an epoch is one CUDA graph replay (eager on the
    CPU) and the epoch reads one loss back.  Against the reference-shaped
    step: the trainer's own step with the frozen BERT forward re-run on
    every batch and its loss read back.  BENCH_TRAIN_STEPS is the least
    number of steps timed, in whole epochs of ceil(bank / batch) steps."""
    import tempfile

    from .cli import DEFAULT_CONFIG_DIR
    from .config import compose
    from .data.loader import DataLoader
    from .models.bert import eos_pool
    from .training.experiment import ClassifierExperiment

    device = bench_device()
    batch = _env_int("BENCH_BATCH", 256)
    min_steps = _env_int("BENCH_TRAIN_STEPS", 50)
    n_bank = _env_int("BENCH_TRAIN_BANK", 4096)
    seq = _env_int("BENCH_SEQ", 256)
    ref_layers = _env_int("BENCH_REF_LAYERS", 12)
    vocab = 8192
    rng = np.random.default_rng(0)
    features = rng.normal(size=(n_bank, 768)).astype(np.float32)
    tokens = {"input_ids": rng.integers(0, vocab, size=(n_bank, seq)),
              "attention_mask": np.ones((n_bank, seq), np.int64)}
    text_tower = ("networks.text_encoder.config={vocab_size: %d, hidden_size: 768, "
                  "num_hidden_layers: %d, num_attention_heads: 12, intermediate_size: 3072, "
                  "max_position_embeddings: %d}" % (vocab, ref_layers, max(seq, 512)))

    with tempfile.TemporaryDirectory(prefix="mmgclip_bench_train_") as run_dir:
        cfg = compose(DEFAULT_CONFIG_DIR, "train_binary_class_clf",
                      [f"dataloader.train.batch_size={batch}", text_tower], run_dir=run_dir)
        cfg.base.tensorboard_export_dir = os.path.join(run_dir, "runs")
        loader = DataLoader(_BankRows(features, tokens), batch_size=batch)
        exp = ClassifierExperiment(config=cfg, train_dataloader=loader, device=device)
        try:
            # the first epoch: the trainer's eager warm-up steps and the capture
            _loss, capture_launches = _launches_during(exp.train)
            steps = -(-n_bank // batch)
            epochs = max(1, -(-min_steps // steps))

            def timed_epochs():
                losses = []
                for _ in range(epochs):
                    exp.current_epoch += 1
                    losses.append(exp.train())
                return losses

            _sync(device)
            t0 = time.perf_counter()
            losses, launches = _launches_during(timed_epochs)
            fused_rate = epochs * steps * batch / (time.perf_counter() - t0)
            epoch_ms = exp.timings["epoch_device_ms"][-epochs:]  # the trainer's CUDA events
            step_ms = sum(epoch_ms) / (epochs * steps) if epoch_ms else None
            graphed = exp._graph is not None

            # reference-shaped: the same step, the frozen tower's forward in it
            tower = exp._text_tower()
            ids, mask = (torch.as_tensor(tokens[k][:batch], device=device)
                         for k in ("input_ids", "attention_mask"))
            feats = torch.as_tensor(features[:batch], device=device)

            def reference_step() -> float:
                with torch.no_grad():
                    pooled = eos_pool(tower(ids, mask, None), mask)
                # loss.item() per step, as the reference hot loop does
                return float(exp._train_step(feats, pooled, None).item())

            reference_step()
            ref_steps = max(3, min_steps // 10)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(ref_steps):
                reference_step()
            ref_rate = ref_steps * batch / (time.perf_counter() - t0)
        finally:
            exp.writer.close()

    return _record(
        f"samples/sec (the trainer's fused epoch, CLIP heads, batch {batch})", fused_rate,
        "samples/sec", fused_rate / ref_rate,
        f"the fused epoch over the trainer's step with the frozen {ref_layers}-layer BERT-base "
        f"forward (seq {seq}) re-run every batch and its loss read back, the reference hot loop "
        "(ClassifierExperiment.py:93-132), same process", device, launches, {
            "fused_cached_bank_samples_per_sec": round(fused_rate, 3),
            "with_bert_forward_samples_per_sec": round(ref_rate, 3),
            "speedup_from_frozen_tower_caching": round(fused_rate / ref_rate, 3),
            "fused_step_device_ms": None if step_ms is None else round(step_ms, 5),
            "steps_per_epoch": steps,
            "epochs_timed": epochs,
            "epoch_losses": [round(v, 6) for v in losses],
            "bank_seconds": round(exp.timings["bank_s"], 4),
            "cuda_graph": graphed,
            "capture_launches": capture_launches,
            "note": "value = samples/s over the timed epochs (host clock, ClassifierExperiment."
                    "train, one loss read back per epoch); fused_step_device_ms = the trainer's "
                    "CUDA event time of an epoch / steps (None on the CPU); launches: the timed "
                    "epochs' (graph replays launch through no wrapper), capture_launches: the "
                    "first epoch's eager steps and the captured step",
        })


# ----------------------------------------------------------------------
# report

def report_inputs(seed: int = 0, d: int = 512):
    """Seeded cascade inputs (numpy float32): the padded prompt table
    ``[banks, max_prompts, d]``, its mask, one embedding and one prompt
    matrix per bank for the stepwise loop."""
    from .evaluation.report_cascade import BANK_ORDER, BANKS

    rng = np.random.default_rng(seed)
    max_prompts = max(len(v) for v in BANKS.values())
    table = rng.normal(size=(len(BANKS), max_prompts, d)).astype(np.float32)
    mask = np.asarray([[1] * len(BANKS[n]) + [0] * (max_prompts - len(BANKS[n]))
                       for n in BANK_ORDER], np.int32)
    emb = rng.normal(size=(d,)).astype(np.float32)
    banks = [rng.normal(size=(len(BANKS[n]), d)).astype(np.float32) for n in BANK_ORDER]
    return table, mask, emb, banks


def bench_report() -> dict:
    """Cascade latency: one device call for all 9 decisions and one read
    back, against 9 stepwise device round trips (the reference's control
    flow); host clock."""
    from .evaluation.report_cascade import BANK_ORDER, run_cascade, unpack_decisions

    device = bench_device()
    iters = _env_int("BENCH_ITERS", 50)
    table_np, mask_np, emb_np, banks_np = report_inputs()
    table, mask, emb = (torch.as_tensor(a, device=device) for a in (table_np, mask_np, emb_np))
    banks = [torch.as_tensor(b, device=device) for b in banks_np]

    def one_call():
        return unpack_decisions(run_cascade(emb, table, mask).item())

    def stepwise():
        return [int(torch.argmax(torch.softmax(b @ emb, dim=-1)).item()) for b in banks]

    def timed(fn) -> float:
        """ms per call over ``iters`` calls, host clock."""
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / max(iters, 1) * 1e3

    decisions = one_call()
    stepwise()
    one_call_ms, launches = _launches_during(lambda: timed(one_call))
    stepwise_ms = timed(stepwise)
    return _record(
        "ms/report (cascade decisions, one device call)", one_call_ms, "ms",
        stepwise_ms / one_call_ms,
        "the 9 stepwise PromptClassifier round trips (generate_report.py:204-367) over the "
        "one-call cascade, same process", device, launches, {
            "one_call_ms": round(one_call_ms, 5),
            "stepwise_9_roundtrips_ms": round(stepwise_ms, 5),
            "speedup": round(stepwise_ms / one_call_ms, 3),
            "decisions_sample": [decisions[name] for name in BANK_ORDER],
            "iters": iters,
        })


# ----------------------------------------------------------------------
# text

def prompt_bank_tokens(seq: int):
    """Every sentence of the prompt banks, tokenized as the product does
    (Bio_ClinicalBERT's name -> the in-repo WordPiece vocabulary), padded to
    ``seq``: (sentences, {"input_ids", "attention_mask"})."""
    from .data.tokenizer import Tokenizer
    from .prompts.generator import available_prompts_templates

    sentences = [s for bank in available_prompts_templates().values()
                 for sents in bank.values() for s in sents]
    tok = Tokenizer.from_pretrained("emilyalsentzer/Bio_ClinicalBERT", sequence_length=seq)
    return sentences, tok(sentences, max_length=seq)


def _sdpa_forward(module, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The tower with ``scaled_dot_product_attention`` in every layer (the
    library figure beside the kernel)."""
    import torch.nn.functional as F

    from .models.bert import bert_layer

    keep = mask.bool()[:, None, None, :]
    hidden = module.embed(ids)
    for i in range(module.config.num_hidden_layers):
        hidden = bert_layer(hidden, module.layer_params(i),
                            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
                            module.config)
    return hidden


def bench_text() -> dict:
    """Text-tower throughput: the flash kernel against the plain attention
    (where the JAX bench has XLA's) on the same BERT-base forward, SDPA
    beside them, at three lengths: ``prompts`` (the banks' sentences padded
    to BENCH_SEQ, the reference-shaped program), ``full`` (every row
    valid), ``trimmed`` (the product path: ``trim_padded_tail`` to a
    32-multiple).  value = the faster trimmed rate; vs_baseline = that over
    the plain attention at the padded length."""
    from .models.bert import BertConfig, BertEncoder, eos_pool, trim_padded_tail

    device = bench_device()
    batch = _env_int("BENCH_BATCH", 256)
    seq = _env_int("BENCH_SEQ", 256)
    layers = _env_int("BENCH_REF_LAYERS", 12)
    iters = _env_int("BENCH_ITERS", 10)
    windows = _env_int("BENCH_WINDOWS", 4)
    dtype = _dtype()
    vocab = 8192
    rng = np.random.default_rng(0)

    sentences, enc = prompt_bank_tokens(seq)
    lens = enc["attention_mask"].sum(axis=1)
    reps = int(np.ceil(batch / len(sentences)))
    ids_prompts = np.tile(enc["input_ids"] % vocab, (reps, 1))[:batch]
    mask_prompts = np.tile(enc["attention_mask"], (reps, 1))[:batch]
    trimmed = trim_padded_tail({"input_ids": ids_prompts, "attention_mask": mask_prompts}, 32)
    cases = {
        "prompts": (ids_prompts, mask_prompts),
        "full": (rng.integers(0, vocab, size=(batch, seq)), np.ones((batch, seq), np.int64)),
        "trimmed": (trimmed["input_ids"], trimmed["attention_mask"]),
    }
    config = BertConfig(vocab_size=vocab, hidden_size=768, num_hidden_layers=layers,
                        num_attention_heads=12, intermediate_size=3072,
                        max_position_embeddings=max(seq, 512), dtype=dtype)
    module = BertEncoder(config, torch.Generator().manual_seed(0)).to(device).eval()
    with torch.inference_mode():  # the weights promote against the fp32 embeddings, as in JAX
        act_dtype = module.embed(torch.zeros((1, 1), dtype=torch.long, device=device)).dtype

    def forward(variant, ids, mask):
        if variant == "sdpa":
            return eos_pool(_sdpa_forward(module, ids, mask), mask)
        module.config = replace(config, use_flash_attention=variant == "flash")
        return eos_pool(module(ids, mask), mask)

    rates, launches = {}, {}
    with torch.inference_mode():
        for variant in ("flash", "plain", "sdpa"):
            for case, (ids, mask) in cases.items():
                ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=device)
                mask_t = torch.as_tensor(np.asarray(mask, np.int64), device=device)
                forward(variant, ids_t, mask_t)  # warm
                seconds, launched = _launches_during(lambda: [
                    device_seconds(lambda: forward(variant, ids_t, mask_t), device, iters)
                    for _ in range(windows)])
                launches[f"{variant}_{case}"] = launched
                rates[f"{variant}_{case}"] = float(np.median([batch * iters / t for t in seconds]))
    module.config = config
    headline = max(("flash_trimmed", "plain_trimmed"), key=rates.get)
    product = rates[headline]
    return _record(
        f"texts/sec (BERT-base text tower, prompt-bank lengths, batch {batch})", product,
        "texts/sec", product / rates["plain_prompts"],
        f"the trimmed product path over the plain attention padded to seq {seq} (the "
        "reference's HF eager attention at sequence_length), same process", device,
        launches[headline], {
            "headline_program": headline,
            **{k: round(v, 3) for k, v in rates.items()},
            "flash_speedup_prompts": round(rates["flash_prompts"] / rates["plain_prompts"], 4),
            "flash_speedup_full": round(rates["flash_full"] / rates["plain_full"], 4),
            "sdpa_speedup_prompts": round(rates["sdpa_prompts"] / rates["plain_prompts"], 4),
            "trim_speedup_vs_padded": round(product / rates["plain_prompts"], 4),
            "trimmed_seq": int(trimmed["input_ids"].shape[-1]),
            "prompt_len_min": int(lens.min()),
            "prompt_len_median": float(np.median(lens)),
            "prompt_len_max": int(lens.max()),
            "n_bank_sentences": len(sentences),
            "seq": seq, "layers": layers, "dtype": str(dtype)[6:],
            "activation_dtype": str(act_dtype)[6:],
            "launches_by_program": launches,
            "note": "texts/s = batch x iters over device time (CUDA events), median of "
                    "windows; flash_* run ops.flash_attention (the CUDA kernel on the card, "
                    "the plain version on the CPU), plain_* attention_reference, sdpa_* "
                    "torch's scaled_dot_product_attention; value = the faster trimmed "
                    "program (headline_program); launches: those in its timed windows, "
                    "launches_by_program: those in each program's timed windows",
        })


# ----------------------------------------------------------------------
# serve

def _serve_config(tiny: bool):
    from .cli import DEFAULT_CONFIG_DIR
    from .config import Config, compose

    cfg = compose(DEFAULT_CONFIG_DIR, "train_binary_class_clf", ["networks=clip_convnext_fused_bert"])
    if tiny:
        cfg.tokenizer.config.sequence_length = 32
        cfg.networks.text_encoder = Config({
            "name": "BertEncoder",
            "config": {"vocab_size": 4096, "hidden_size": 64, "num_hidden_layers": 2,
                       "num_attention_heads": 4, "intermediate_size": 128,
                       "max_position_embeddings": 64},
        })
        cfg.networks.image_encoder.config = Config({"micro": True, "in_channels": 1,
                                                    "use_fused_blocks": True})
    return cfg


def bench_serve() -> dict:
    """Serving latency and throughput through ``serve.serve_socket`` (TCP
    JSONL, the micro-batching dispatcher) on a warm ``InferenceEngine``:
    the fused bf16 tower (``networks=clip_convnext_fused_bert``) and the
    flash text tower, set on the module as the JAX bench does (no config
    key reaches ``use_flash_attention``).

    sequential — one closed-loop client, every ``classify`` its own device
    call (the reference-shaped execution model), then ``report`` and
    ``encode`` (one PNG path a request) latencies; concurrent —
    BENCH_SERVE_CLIENTS closed-loop clients whose queued requests merge
    into one forward.  value = concurrent requests/s; vs_baseline = that
    over the sequential rate."""
    import asyncio
    import base64
    import socket as socketlib
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from .serve import serve_socket
    from .serving import InferenceEngine
    from .tools.fixtures import png_l8_bytes

    device = bench_device()
    tiny = _env_on("BENCH_SERVE_TINY")
    engine = InferenceEngine(_serve_config(tiny), device=device)
    text = engine.model.text_module
    text.config = replace(text.config, use_flash_attention=True)
    clients = _env_int("BENCH_SERVE_CLIENTS", 16)
    per_client = _env_int("BENCH_SERVE_REQS", 16)
    seq_iters = _env_int("BENCH_ITERS", 64)
    image_hw = (64, 64) if tiny else (1024, 832)  # phase 6's serving bucket
    dim = int(engine.cn_config.dims[-1])
    rng = np.random.default_rng(0)
    class_list = ["Mammogram revealed a mass.", "No findings are present."]

    # warm every row bucket the dispatcher can produce, the cascade table and
    # the prompt embeddings (the text tower runs here), so the timed sections
    # measure serving, not first calls
    for n in (1, 2, 4, 8, 16, 32):
        engine.classify(rng.normal(size=(n, dim)).astype(np.float32), class_list)
    engine.generate_reports(rng.normal(size=(1, dim)).astype(np.float32))

    ready = threading.Event()
    state: dict = {}

    def run_server():
        # a failure before the port announcement is re-raised on the main thread
        try:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            aready = asyncio.Event()
            bound: list = []
            task = loop.create_task(serve_socket(engine, host="127.0.0.1", port=0,
                                                 ready_event=aready, bound_addr=bound))

            async def announce():
                await aready.wait()
                state["port"] = bound[0][1]
                state["loop"], state["task"] = loop, task
                ready.set()

            announcer = loop.create_task(announce())
            try:
                loop.run_until_complete(task)
            except asyncio.CancelledError:
                pass
            finally:
                announcer.cancel()
                loop.close()
        except BaseException as exc:  # noqa: BLE001 - stashed for the main thread, re-raised
            state["error"] = exc
            ready.set()
            raise

    def payloads(n_requests, op="classify", fresh_prompts=False):
        """Request lines in the compact features_b64 form, built outside the
        timed loops; ``fresh_prompts``: every classify names prompts the
        engine has not embedded yet, so its text tower runs."""
        out = []
        for i in range(n_requests):
            b64 = base64.b64encode(rng.normal(size=(dim,)).astype("<f4").tobytes()).decode()
            req = {"op": op, "features_b64": b64, "id": i}
            if op == "classify":
                req["class_list"] = ([f"{c[:-1]} (request {i})." for c in class_list]
                                     if fresh_prompts else class_list)
            out.append((json.dumps(req) + "\n").encode())
        return out

    def session(lines, collect_latency=False):
        """One closed-loop client: send, await the reply, repeat."""
        lat = []
        with socketlib.create_connection(("127.0.0.1", state["port"])) as sock:
            f = sock.makefile("rwb")
            for line in lines:
                t0 = time.perf_counter()
                f.write(line)
                f.flush()
                resp = json.loads(f.readline())
                if collect_latency:
                    lat.append(time.perf_counter() - t0)
                if "result" not in resp:
                    raise RuntimeError(f"serve error: {resp.get('error')}")
        return lat

    launches: Dict[str, dict] = {}
    thread = threading.Thread(target=run_server, daemon=True)
    thread.start()
    with tempfile.TemporaryDirectory(prefix="mmgclip_bench_") as tmp:
        try:
            if not ready.wait(timeout=120):
                raise RuntimeError("serve_socket did not come up (no port announcement)")
            if "error" in state:
                raise RuntimeError("serve_socket failed to come up") from state["error"]
            png = os.path.join(tmp, "view.png")
            with open(png, "wb") as fh:
                fh.write(png_l8_bytes(rng.integers(0, 256, size=image_hw, dtype=np.uint8)))
            encode_line = (json.dumps({"op": "encode", "paths": [png]}) + "\n").encode()

            # every timed session reads the launches it made (the server's
            # thread launches while the session waits for its replies)
            session(payloads(4) + [encode_line])  # protocol, decode and encode warm
            seq_lines = payloads(seq_iters)
            t0 = time.perf_counter()
            seq_lat, launches["sequential"] = _launches_during(
                lambda: session(seq_lines, collect_latency=True))
            seq_rate = seq_iters / (time.perf_counter() - t0)
            report_lines = payloads(max(seq_iters // 4, 8), op="report")
            report_lat, launches["report"] = _launches_during(lambda: session(report_lines, True))
            encode_lines = [encode_line] * max(seq_iters // 8, 4)
            encode_lat, launches["encode"] = _launches_during(lambda: session(encode_lines, True))
            fresh_lines = payloads(max(seq_iters // 8, 4), fresh_prompts=True)
            fresh_lat, launches["fresh_prompts"] = _launches_during(
                lambda: session(fresh_lines, True))

            client_lines = [payloads(per_client) for _ in range(clients)]
            with ThreadPoolExecutor(max_workers=clients) as pool:
                list(pool.map(session, [payloads(2) for _ in range(clients)]))  # warm under load

                def concurrent():
                    futs = [pool.submit(session, lines, True) for lines in client_lines]
                    return [t for fut in futs for t in fut.result()]

                t0 = time.perf_counter()
                conc_lat, launches["concurrent"] = _launches_during(concurrent)
                conc_rate = clients * per_client / (time.perf_counter() - t0)
        finally:
            if "loop" in state:
                state["loop"].call_soon_threadsafe(state["task"].cancel)
            thread.join(timeout=30)
            engine.close()
    seq_ms, conc_ms = _percentiles(seq_lat), _percentiles(conc_lat)
    return _record(
        f"requests/sec (classify over TCP JSONL, {clients} concurrent clients, micro-batched)",
        conc_rate, "requests/sec", conc_rate / seq_rate,
        "concurrent (micro-batched) requests/s over one sequential client's, every request "
        "its own device call (the reference has no serving path), same process", device,
        launches["concurrent"], {
            "concurrent_req_per_sec": round(conc_rate, 3),
            "sequential_req_per_sec": round(seq_rate, 3),
            "microbatch_speedup": round(conc_rate / seq_rate, 3),
            "sequential_p50_ms": round(seq_ms[0], 4),
            "sequential_p90_ms": round(seq_ms[1], 4),
            "sequential_p95_ms": round(seq_ms[2], 4),
            "concurrent_p50_ms": round(conc_ms[0], 4),
            "concurrent_p90_ms": round(conc_ms[1], 4),
            "concurrent_p95_ms": round(conc_ms[2], 4),
            "report_p50_ms": round(_percentiles(report_lat)[0], 4),
            "encode_p50_ms": round(_percentiles(encode_lat)[0], 4),
            "fresh_prompts_p50_ms": round(_percentiles(fresh_lat)[0], 4),
            "session_launches": launches,
            "encode_image": list(image_hw),
            "clients": clients, "requests_per_client": per_client,
            "sequential_requests": seq_iters,
            "tiny": tiny,
            "note": "latencies are host clock per request (JSON + TCP + dispatcher queue + "
                    "device); classify / report requests carry 768-d features_b64, encode "
                    "requests one 8-bit PNG path, fresh_prompts classify requests a class "
                    "list not yet embedded (the text tower runs); launches: the concurrent "
                    "sessions', session_launches: each timed session's",
        })


# ----------------------------------------------------------------------
# ingest

def bench_ingest() -> dict:
    """The ingest chain end to end at native input: native uint8 crosses
    the host link (or its host k x k block sums with BENCH_HOST_PREPOOL),
    then resize -> intensity windowing -> normalization -> the fused tanh
    tower as one program (``ingest.encode.build_encode_program``, the
    feature store's resize path)."""
    from .ingest.encode import build_encode_program, host_prepool
    from .models.convnext import ConvNeXtConfig
    from .ops.preprocess import normalize_16bit, to_16bit
    from .ops.resize import fit_shape, resize_to_canvas, resize_to_canvas_from_block_sums

    device = bench_device()
    native = _parse_hw(os.environ.get("BENCH_NATIVE_SIZE", "2294x1914"))
    canvas = _parse_hw(os.environ.get("BENCH_CANVAS", 256))
    batch = _env_int("BENCH_BATCH", 16)
    iters = _env_int("BENCH_ITERS", 4)
    windows = _env_int("BENCH_WINDOWS", 3)
    dtype = _dtype()
    window = tuple(float(v) for v in os.environ.get("BENCH_WINDOW", "32767.5,65535").split(","))
    tiny = _env_on("BENCH_TINY")
    precision_name = os.environ.get("BENCH_RESIZE_PRECISION", "default").strip().lower()
    if precision_name not in ("default", "highest"):
        raise ValueError(
            f"BENCH_RESIZE_PRECISION must be 'default' or 'highest', got {precision_name!r}")
    precision = "highest" if precision_name == "highest" else None
    prepool = _env_int("BENCH_HOST_PREPOOL", 0)
    peaks = peaks_for(device)  # an unknown card raises before any work

    base = ConvNeXtConfig.micro() if tiny else ConvNeXtConfig.tiny()
    base = replace(base, in_channels=1, dtype=dtype, layer_scale_init=0.1)
    # the product fast path: fused blocks + tanh GELU, the fused stem; the
    # fused downsample does not apply to the masked (canvas) tower
    module = _convnext(replace(base, gelu="tanh", **_FUSED), device)
    plain_module = _convnext(base, device)

    def programs(tower):
        return build_encode_program(tower, 1, window=window, resize_hw=canvas,
                                    resize_method="area", resize_precision=precision,
                                    prepool=prepool)

    chain_fn, plain_fn = programs(module), programs(plain_module)
    if prepool:
        scale = 257.0  # uint8 sources: the block sums of to_16bit's 257 x p

        def payload(host):  # host k x k block sums: the host half, in the loop
            return torch.from_numpy(host_prepool(host.numpy(), prepool)[0])

        def chain(x):
            return chain_fn(x, native_hw=native, scale=scale)

        def plain(x):
            return plain_fn(x, native_hw=native, scale=scale)

        def resize_only(x):
            y, _valid = resize_to_canvas_from_block_sums(x, native, canvas, prepool,
                                                         method="area", precision=precision)
            return normalize_16bit(y * scale, window=window).to(dtype)

        def host_payload(a):
            return host_prepool(a, prepool)[0]
    else:
        chain, plain = chain_fn, plain_fn

        def payload(host):
            return host

        def resize_only(x):
            y, _valid = resize_to_canvas(to_16bit(x), canvas, method="area", precision=precision)
            return normalize_16bit(y, window=window).to(dtype)

        def host_payload(a):
            return a

    arrays, pinned = _host_buffers(device, (batch, *native), n_buf=3)
    device_payload = _to_device(payload(pinned[0]), device)
    chain(device_payload)
    resize_only(device_payload)
    _sync(device)

    def device_rate(fn):
        return max(batch * iters / device_seconds(lambda: fn(device_payload), device, iters)
                   for _ in range(windows))

    _out, chain_launches = _launches_during(lambda: chain(device_payload))
    chain_rate = device_rate(chain)
    resize_rate = device_rate(resize_only)
    feed = _Feed(device, arrays, pinned, batch, iters, payload=payload)
    feed.window(chain, True)
    e2e_rates, e2e_launches = _launches_during(
        lambda: [feed.window(chain, True) for _ in range(windows)])
    median_rate = float(np.median(e2e_rates))
    n_ref = max(batch, REF_MIN_IMAGES)
    ref_rate = _reference_shaped_rate(device, plain, arrays, n_ref, host_payload)

    # analytic FLOPs: the dense separable resample, then the tower at the canvas
    vh, vw = fit_shape(native, canvas)
    hb = -(-native[0] // prepool) if prepool else native[0]
    wb = -(-native[1] // prepool) if prepool else native[1]
    resize_flops = 2 * vh * hb * wb + 2 * vh * vw * wb
    dt_bytes = 2 if dtype == torch.bfloat16 else 4
    tower_flops = sum(mf + vf for _n, mf, vf, _b, _q in _convnext_layer_costs(
        canvas, dtype_bytes=dt_bytes, batch=batch, fused=True, gelu_flops=8))
    bytes_per_image = hb * wb * (2 if prepool else 1)
    link_bytes_per_sec, link_method = _true_h2d_rate(device, _pinned(payload(pinned[0]), device),
                                                     iters, windows)
    # resize: fp32 products (default precision rounds the operands to bf16
    # and multiplies in fp32) at the fp32 peak; its bytes: the payload read
    # and the fp32 canvas written
    t_resize = max(resize_flops / peaks["fp32"],
                   (bytes_per_image + 4 * canvas[0] * canvas[1]) / peaks["bytes"])
    tower_sol, _stages = _card_per_layer_projection(canvas, peaks, fused=True, batch=batch,
                                                    gelu_flops=8, dtype_bytes=dt_bytes)
    compute_sol = 1.0 / (t_resize + 1.0 / tower_sol)
    link_ceiling = link_bytes_per_sec / bytes_per_image
    return _record(
        (f"images/sec (native {native[0]}x{native[1]} uint8 -> resize + window + normalize "
         f"+ fused encode @ {canvas[0]}x{canvas[1]})"),
        median_rate, "images/sec", median_rate / ref_rate,
        f"the e2e median over the reference-shaped loop: {n_ref} native images one at a "
        "time through the same chain with the plain tower, each copied in and its features "
        "read back (mmgclip/networks/image_features.py:87-117), same process", device,
        e2e_launches, {
            "e2e_windows_img_per_sec": [round(r, 3) for r in e2e_rates],
            "median_img_per_sec": round(median_rate, 3),
            "reference_shaped_img_per_sec": round(ref_rate, 3),
            "reference_shaped_images": n_ref,
            "chain_compute_img_per_sec": round(chain_rate, 3),
            "resize_only_img_per_sec": round(resize_rate, 3),
            "chain_launches": chain_launches,
            "analytic_flops_per_image_g": round((resize_flops + tower_flops) / 1e9, 4),
            "native_bytes_per_image_mb": round(bytes_per_image / 1e6, 4),
            "link_gbytes_per_sec": round(link_bytes_per_sec / 1e9, 4),
            "link_method": link_method,
            "resample": {"method": "area", "canvas": list(canvas), "valid_hw": [vh, vw],
                         "window": list(window), "precision": precision_name,
                         "host_prepool": prepool,
                         "resize_gflops_per_image": round(resize_flops / 1e9, 4)},
            "card_projection": {
                "compute_img_per_sec": round(compute_sol, 1),
                "tower_term_img_per_sec": round(tower_sol, 1),
                "link_ceiling_img_per_sec": round(link_ceiling, 1),
                "e2e_img_per_sec": round(min(compute_sol, link_ceiling), 1),
                "bound": "link" if link_ceiling < compute_sol else "compute",
                "basis": (
                    f"compute = the resample's fp32 products at the {peaks['variant']} "
                    "data-sheet fp32 peak (or its bytes at the HBM peak) + the fused tanh "
                    "tower's per-layer roofline at the canvas; link = the measured "
                    "host-to-device rate of this run over the bytes an image sends"),
            },
            "tiny": tiny,
            "note": "e2e windows: host clock after a synchronize, double-buffered copies from "
                    "pinned buffers (the host prepool inside the loop); chain and resize "
                    "rates: CUDA event time on device-resident input, best of windows; "
                    "launches: the timed e2e windows, chain_launches: one chain call",
        })


# ----------------------------------------------------------------------

MODES = {"encode": bench_encode, "train": bench_train, "report": bench_report,
         "text": bench_text, "serve": bench_serve, "ingest": bench_ingest}


def main() -> None:
    mode = os.environ.get("BENCH_MODE", "encode")
    if mode not in MODES:
        raise ValueError(f"BENCH_MODE must be one of {sorted(MODES)}, got {mode!r}")
    print(json.dumps(MODES[mode]()), flush=True)


if __name__ == "__main__":
    main()
