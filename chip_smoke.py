"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mmgclip_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, then drives two main paths at
the full width of ConvNeXt-Tiny (+ BERT-base) with seeded random weights:

* serving (``mmgclip_tpu_torch.serve.handle`` over ``InferenceEngine``):
  the fused bf16 block and flash attention kernels;
* the feature store (``ImageFeatureExtractor.extract()`` over a synthetic
  tree of full-field 16-bit PNGs, one of them corrupt) under the int8 preset
  with the fused stem and downsample, then its masked variants (resize +
  host prepool, bucket rounding) and the unfused tower with the standalone
  depthwise kernel.

Then it holds the ring all-gather (P logical ranks on the card) bit-equal to
its plain version, drives the global contrastive losses through it against
the single-device losses, and trains ``train_binary_class_clf`` with
``mmgclip_tpu_torch.train.run`` at full BERT-base width, runs ``test()``,
re-evaluates the stored run through ``evaluate_clip.main``, serves the
trained run, and matches a reduced-width run on the card with the
same run on the CPU.  Phase 15 holds every speed knob of the tower to the
product gates of the JAX package (``tests/test_fastpath_parity.py``): one
checkpoint trained on plain-path features, evaluated on a feature store
encoded through the kernels per knob, zero-shot AUC within 0.005 of the
baseline's and the generated reports byte-identical.  Phase 16 closes the
main path over the trained run, the tower in the feature-store preset:
``generate_report.main`` for one full-field image and one four-view exam
(Paeth-filtered PNGs through the compiled unfilter), equal to the serving
engine's decisions and reports; ``evaluate_cnn`` against its CPU run; and
the unix-socket server answering 36 concurrent clients as ``handle`` does.

Phase 17 drives the exam-report family: ``encode_studies`` over studies of
four full-field views in the feature-store preset (study vectors against the
serving engine's views and the plain tower), ``train_exam_reports_clf`` at
BERT-base width under ``CLIPLoss`` and ``MMGCLIPLoss`` with JAX's dropout
masks (the threefry and dropout kernels, phase 5b), ``PromptClassifier``
against the engine and the BatchNorm and MoE heads on the card against the
CPU.  Phases 14 and 17 hold the fused epoch captured as a CUDA graph against
the eager epoch from the same state.  Phase 18 drives the BioGPT text-tower
family at full width (24 x 1024, 16 heads, vocab 42384, seeded):
``train --config-name train_binary_class_clf networks=clip_convnext_biogpt
tokenizer=biogpt`` (Moses+BPE ids, the text bank, 3 epochs, ``test()``),
``evaluate_clip``, ``generate_report`` through the feature-store preset and
``serve --once`` ``classify``, and the tower on the card against the CPU at
tiny width.  Phase 19 drives the ResNet-50 family at full width (stages
``(3, 4, 6, 3)``, width 64, 2048-d, ``remat`` on, seeded): ``train
--config-name train_binary_class_clf networks=clip_resnet50_bert`` (the
tower's forward and the ``layer4`` backward inside the captured step, 3
epochs, ``test()``), the stem and ``layer1`` - ``layer3`` bit-unchanged
while ``layer4`` and the heads moved, ``evaluate_clip``, ``generate_report``
(the store preset's ConvNeXt, then the ResNet), ``serve --once``
``classify``, the graphed epoch against the eager one (cuDNN's
deterministic algorithms pinned for that comparison) and the tower's
features on the card against the CPU.  Phase 20 starts the port from the
reference's torch artifacts, synthesized from a seed: a ConvNeXt-Tiny
classifier traced to TorchScript from plain ``nn`` layers under
torchvision's names and an HF BERT-base snapshot (``.bin`` and
``.safetensors``).  It runs ``tools.convert_convnext --verify`` on the card
(and the converted tower against the TorchScript module on a 2304 x 1920
bucket), ``tools.convert_bert`` from both files (byte-equal),
``tools.reproduce`` over 16 + 16 full-field PNGs (convert, encode, train,
``test()``, report), the store preset's int8 and fused-glue encodes over the
converted weights (zero-shot AUC within phase 15's 0.005 of the plain
store's) and ``generate_report`` through the int8 preset (the plain tower's
decisions), ``tools.tsne_eval`` and the t-SNE alone at 4,096 and 16,384
points (card vs CPU at 300), then ``data_efficiency``, ``eda``,
``parity_harness`` and ``demo_run``.

Each path runs with the launch counts set to 0 just before it and read just
after.  It checks what comes out, and times every kernel beside its plain
version, its bound and (where one exists) the one PyTorch call that computes
the same function, plus the encode programs, ``extract()`` (split into
decode, device and write seconds), PNG decode (compiled and plain unfilter),
the global loss, the text bank, the train step, ``test()``, ``generate_report``,
the socket server's ms per request, studies/s of ``encode_studies``, the
graphed and eager train steps, the BioGPT and ResNet runs' bank, step,
``test()``, ``evaluate_clip``, report and ``serve --once`` seconds, and
phase 20's seconds per step.  The times phase keeps its number, 11, and
runs after phases 12-20; each kernel's row of the ``kernels`` line also
carries its launches in phase 20 (``phase20_launches``).

Imports nothing of JAX or of ``mmgclip_tpu``.  Exits non-zero, without the
result line, when CUDA is unavailable or any phase fails.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels as JSON.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks (NVIDIA data sheets, dense): HBM bytes/s, fp32 (non-tensor)
# and tf32 / bf16 / int8 (tensor core) operations/s, keyed by the name
# nvidia-smi reports.  "int32" (the integer ALU, which the data sheets do not
# list) is SMs x 64 int32 lanes x the boost clock: 132 x 64 x 1.98 GHz (SXM5),
# 114 x 64 x 1.755 GHz (PCIe), 132 x 64 x 1.785 GHz (NVL).
PEAKS = {
    "H100 80GB HBM3": {"variant": "H100 SXM5", "bytes": 3.35e12, "fp32": 67e12, "tf32": 495e12,
                       "bf16": 989e12, "int8": 1979e12, "int32": 132 * 64 * 1.98e9},
    "H100 PCIe": {"variant": "H100 PCIe", "bytes": 2.0e12, "fp32": 51e12, "tf32": 378e12,
                  "bf16": 756e12, "int8": 1513e12, "int32": 114 * 64 * 1.755e9},
    "H100 NVL": {"variant": "H100 NVL", "bytes": 3.9e12, "fp32": 60e12, "tf32": 417.5e12,
                 "bf16": 835e12, "int8": 1671e12, "int32": 132 * 64 * 1.785e9},
}
FP32_REL_TOL = 1e-4           # kernel 1 vs plain, fp32 with TF32 off
BF16_REL_TOL = 2.0 ** -6      # both kernels in bf16: two bf16 steps of the largest value
FLASH_FP32_ABS_TOL = 1e-5     # kernel 2 vs attention_reference, fp32
TOWER_FP32_ABS_TOL = 1e-4     # BERT-base hidden states, flash vs plain attention, 12 layers
FEATURE_COSINE_MIN = 0.9999   # fused vs unfused ConvNeXt-Tiny features, bf16
INT8_REL_TOL = 2.0 ** -5      # int8 block vs its same-partition plain version: a rounding
                              # flip moves a value by one quantisation step
STORE_VS_SERVED_COSINE = 0.99999  # the feature store against encode_paths, same config
INT8_VS_BF16_COSINE = 0.99    # int8 features against the bf16 fused tower's
BUCKET_FP32_REL_L2 = 1e-5     # bucketed vs exact-shape features, fp32 fused tower
BUCKET_INT8_COSINE = 0.9999   # the same, bf16 int8 tower
FFDM_SHAPES = ((2294, 1914), (2294, 1910))  # two full-field detector sizes
PAIR_HW = (1024, 832)         # the resize canvas and the 2-image bucket of the other phases
ROUNDING = 64                 # encode_bucket_rounding of the masked phase


def rounded_canvas():
    """The bucket-rounding canvas both full-field shapes share (2304 x 1920)."""
    return tuple(-(-max(s[i] for s in FFDM_SHAPES) // ROUNDING) * ROUNDING for i in (0, 1))


def log(*parts) -> None:
    print(*parts, flush=True)


def peaks_for(name: str) -> dict:
    for key, value in PEAKS.items():
        if key in name:
            return value
    raise RuntimeError(f"no published peaks recorded for card {name!r}")


def time_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median device time of one ``fn()`` call, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls: int = 20, repeats: int = 5) -> float:
    """Median device time per call of ``calls`` back-to-back ``fn()`` calls.
    A sleep kernel holds the stream while the host queues them all, so the
    events see the device's work and its launch gaps, not the host's time
    per call; the sleep doubles until the host finishes queueing first."""
    fn()
    torch.cuda.synchronize()
    cycles, times = 20_000_000, []
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        caught_up = start.query()  # the device reached the queue before the host filled it
        end.record()
        end.synchronize()
        if caught_up:
            if cycles >= 2_000_000_000:
                raise RuntimeError("device_ms: the host cannot queue the calls ahead of the device")
            cycles *= 2
            continue
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def chained_ms(fn, calls: int = 20, repeats: int = 5) -> float:
    """Median time per call of ``calls`` back-to-back ``fn()`` calls between
    two events, with no sleep kernel ahead: for a function that waits for
    the device by itself, so that ``device_ms`` cannot queue it; its stalls
    count."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def _write_png(path: str, width: int, height: int, depth: int, rows: np.ndarray) -> None:
    """Grayscale PNG of ``depth`` bits from filtered rows (filter byte first),
    compressed with the standard library's zlib."""
    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(data)


def write_png16(path: str, pixels: np.ndarray, paeth: bool = False) -> None:
    """Grayscale 16-bit PNG: every row unfiltered, or every row
    Paeth-filtered (the slow case for decoders)."""
    h, w = pixels.shape
    rows = np.zeros((h, 1 + 2 * w), np.uint8)
    raw = pixels.astype(">u2").view(np.uint8).reshape(h, 2 * w)
    if paeth:
        cur = raw.astype(np.int16)
        up = np.vstack([np.zeros((1, 2 * w), np.int16), cur[:-1]])
        left = np.hstack([np.zeros((h, 2), np.int16), cur[:, :-2]])
        upleft = np.hstack([np.zeros((h, 2), np.int16), up[:, :-2]])
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        rows[:, 0] = 4
        rows[:, 1:] = ((cur - pred) & 0xFF).astype(np.uint8)
    else:
        rows[:, 1:] = raw
    _write_png(path, w, h, 16, rows)


def write_png8(path: str, pixels: np.ndarray) -> None:
    """Grayscale 8-bit PNG, every row unfiltered."""
    h, w = pixels.shape
    rows = np.zeros((h, 1 + w), np.uint8)
    rows[:, 1:] = pixels
    _write_png(path, w, h, 8, rows)


def synthetic_mammogram(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth breast-like blob plus noise, uint16."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    blob = np.exp(-(((yy - h / 2) / (0.45 * h)) ** 2 + (xx / (0.8 * w)) ** 2))
    img = 40000 * blob + rng.normal(0, 1500, size=(h, w))
    return np.clip(img, 0, 65535).astype(np.uint16)


# ----------------------------------------------------------------------
# bounds: the larger of bytes over HBM rate and operations over peak rate
def block_work(n, h, w, c, dtype_bytes):
    pixels = n * h * w
    ops = pixels * (16 * c * c + 98 * c)
    weights = (49 * c + 8 * c * c + 7 * c) * dtype_bytes
    return ops, 2 * pixels * c * dtype_bytes + weights


def flash_work(b, heads, s, d, lengths, dtype_bytes):
    keys = [s if int(v) == 0 else int(v) for v in lengths]  # valid_len 0 visits all keys
    ops = sum(4 * s * k * d for k in keys) * heads
    moved = sum((2 * s + 2 * k) * d for k in keys) * heads * dtype_bytes + 4 * b
    return ops, moved


def bound_ms(ops, moved, dtype, peaks, rate=None):
    rate = rate or (peaks["bf16"] if dtype == torch.bfloat16 else peaks["fp32"])
    t_ops, t_bytes = ops / rate, moved / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def flash_rate(dtype, peaks):
    """(operations/s, label) of the products of the flash and fp / bf16
    block kernels: bf16 on the tensor cores, fp32 as three TF32 products
    each (the three-pass split)."""
    if dtype == torch.bfloat16:
        return peaks["bf16"], "bf16 tensor cores"
    return peaks["tf32"] / 3, "TF32 rate / 3, the three-pass split"


# ----------------------------------------------------------------------
def block_params(c, dtype, gen, device):
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    p = [r(7, 7, 1, c, scale=0.2), r(c, scale=0.1), 1 + r(c, scale=0.1), r(c, scale=0.1),
         r(c, 4 * c, scale=c ** -0.5), r(4 * c, scale=0.1), r(4 * c, c, scale=(4 * c) ** -0.5),
         r(c, scale=0.1), r(c, scale=0.5)]
    # the LayerNorm affine (indices 2, 3) stays fp32, as the tower passes it
    return [t.to(device, torch.float32 if i in (2, 3) else dtype) for i, t in enumerate(p)]


def rel_err(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / ref.float().abs().max().item()


def phase_block_parity(device, gen, shapes):
    """The block against its plain version at every shape, and a second
    launch on the same inputs bit-equal to the first."""
    from mmgclip_tpu_torch.ops.fused_block import launch_fused_block, plain_convnext_block

    worst = {}
    for shape in shapes:
        n, h, w, c = shape
        for dtype in (torch.float32, torch.bfloat16):
            for tanh in (False, True):
                x = torch.randn(n, h, w, c, generator=gen).to(device, dtype)
                p = block_params(c, dtype, gen, device)
                out = launch_fused_block(x, *p, gelu_tanh=tanh)
                again = launch_fused_block(x, *p, gelu_tanh=tanh)
                ref = plain_convnext_block(x, *p, gelu_tanh=tanh)
                torch.cuda.synchronize()
                err, rel = rel_err(out, ref)
                tol = FP32_REL_TOL if dtype == torch.float32 else BF16_REL_TOL
                same = bit_equal([again], [out])
                log(f"  block {shape} {str(dtype)[6:]} gelu={'tanh' if tanh else 'exact'}: "
                    f"max_abs {err:.3e} rel {rel:.3e} (tol {tol:.1e}); second launch "
                    f"{'bit-equal' if same else 'DIFFERS'}")
                if not (rel <= tol and same):
                    raise AssertionError(f"fused block {shape} {dtype} tanh={tanh}: rel {rel} > {tol} "
                                         f"or a second launch differs ({not same})")
                key = (shape, dtype, tanh)
                worst[key] = err
    return worst


def phase_flash_parity(device, gen):
    from mmgclip_tpu_torch.ops.flash_attention import attention_reference, launch_flash_attention

    b, heads, d = 8, 12, 64
    worst = {}
    for s in (32, 256):
        lengths = torch.tensor([0, 1, s // 3 + 1, s, s - 1, 5, s, 2], dtype=torch.int32)
        mask = (torch.arange(s)[None, :] < lengths[:, None]).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, heads, s, d, generator=gen).to(device, dtype) for _ in range(3))
            out = launch_flash_attention(q, k, v, lengths.to(device))
            ref = attention_reference(q, k, v, mask)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            ok = err <= FLASH_FP32_ABS_TOL if dtype == torch.float32 else rel <= BF16_REL_TOL
            log(f"  flash s={s} {str(dtype)[6:]} lengths={lengths.tolist()}: max_abs {err:.3e} rel {rel:.3e}")
            if not ok:
                raise AssertionError(f"flash attention s={s} {dtype}: max_abs {err}, rel {rel}")
            worst[(s, dtype)] = err
    return worst


def set_layer_scale(module, value):
    """Raise every block's layer scale from its 1e-6 init, so the blocks and
    not the residual stream decide the features being compared."""
    from mmgclip_tpu_torch.models.convnext import ConvNeXtStage

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, ConvNeXtStage):
                m.gamma.fill_(value)


def bound2(ops_main, main_rate, ops_fp32, moved, peaks):
    """Least time: main-path operations at ``main_rate`` plus elementwise
    fp32 operations, against the bytes moved; -> (ms, bound_by)."""
    t_ops = ops_main / peaks[main_rate] + ops_fp32 / peaks["fp32"]
    t_bytes = moved / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rate_of(dtype):
    return "bf16" if dtype == torch.bfloat16 else "fp32"


def nbytes(dtype):
    return 2 if dtype == torch.bfloat16 else 4


def stem_bound(shape, cout, x_dtype, w_dtype, peaks):
    n, h, w, cin = shape
    pix = n * -(-h // 4) * -(-w // 4)
    moved = (n * h * w * cin + pix * cout) * nbytes(x_dtype) + (16 * cin + 1) * cout * nbytes(w_dtype)
    return bound2(pix * 32 * cin * cout, rate_of(w_dtype), pix * 8 * cout, moved + 8 * cout, peaks)


def downsample_bound(shape, cout, dtype, peaks):
    n, h, w, cin = shape
    pix = n * -(-h // 2) * -(-w // 2)
    moved = (n * h * w * cin + pix * cout + (4 * cin + 1) * cout) * nbytes(dtype) + 8 * cin
    return bound2(pix * 8 * cin * cout, rate_of(dtype), n * h * w * 8 * cin, moved, peaks)


def depthwise_bound(shape, dtype, peaks):
    n, h, w, c = shape
    pix = n * h * w
    moved = (2 * pix * c + 50 * c) * nbytes(dtype)
    return bound2(pix * 99 * c, rate_of(dtype), 0, moved, peaks)


def int8_block_bound(shape, dtype, peaks):
    n, h, w, c = shape
    pix = n * h * w
    moved = (2 * pix * c + 56 * c + 4 * c) * nbytes(dtype) + 8 * c * c + 5 * c * 4 + 8 * c
    return bound2(pix * 16 * c * c, "int8", pix * 98 * c, moved, peaks)


def stage_shapes_of(n, h, w):
    """The four stage shapes [n, H, W, C] of ConvNeXt-Tiny for an h x w input."""
    hh, ww = -(-h // 4), -(-w // 4)
    shapes = []
    for c in (96, 192, 384, 768):
        shapes.append((n, hh, ww, c))
        hh, ww = -(-hh // 2), -(-ww // 2)
    return shapes


def glue_inputs(kind, shape, dtype, gen, device, cout=None):
    """Seeded inputs of one new kernel at ``shape``."""
    def r(*s, scale=1.0, offset=0.0):
        return offset + torch.randn(*s, generator=gen) * scale

    c = shape[-1]
    if kind == "stem":  # the tower's fp32 input, the weights in the case's dtype
        return [r(*shape).to(device), r(4, 4, c, cout, scale=(16 * c) ** -0.5).to(device, dtype),
                r(cout, scale=0.1).to(device, dtype), r(cout, scale=0.1, offset=1.0).to(device),
                r(cout, scale=0.1).to(device)]
    if kind == "downsample":
        return [r(*shape).to(device, dtype), r(c, scale=0.1, offset=1.0).to(device),
                r(c, scale=0.1).to(device), r(2, 2, c, cout, scale=(4 * c) ** -0.5).to(device, dtype),
                r(cout, scale=0.1).to(device, dtype)]
    if kind == "depthwise":
        return [r(*shape).to(device, dtype), r(7, 7, 1, c, scale=0.2).to(device, dtype),
                r(c, scale=0.1).to(device, dtype)]
    return [r(*shape).to(device, dtype), *block_params(c, dtype, gen, device)]


def stem_by_library(x, k, b, ns, nb):
    """The stem as library calls, timed beside the kernel and never used by
    the port: F.conv2d 4x4/4 on the input cast to the weight dtype and
    zero-padded bottom/right (``br_pad``), then F.layer_norm in fp32."""
    import torch.nn.functional as F

    h, w = x.shape[1:3]
    xc = F.pad(x.to(k.dtype), (0, 0, 0, (-w) % 4, 0, (-h) % 4)).permute(0, 3, 1, 2)
    y = F.conv2d(xc, k.permute(3, 2, 0, 1), b, stride=4).permute(0, 2, 3, 1).float()
    return F.layer_norm(y, (k.shape[3],), ns, nb, 1e-6).to(x.dtype)


def glue_kernels():
    from mmgclip_tpu_torch.ops.depthwise_conv import launch_depthwise_conv7x7, plain_depthwise_conv7x7
    from mmgclip_tpu_torch.ops.fused_block import launch_fused_block_int8, plain_convnext_block_int8
    from mmgclip_tpu_torch.ops.fused_downsample import launch_fused_ln_downsample, plain_ln_downsample
    from mmgclip_tpu_torch.ops.fused_stem import launch_fused_stem, plain_stem

    return {"stem": (launch_fused_stem, plain_stem),
            "downsample": (launch_fused_ln_downsample, plain_ln_downsample),
            "depthwise": (launch_depthwise_conv7x7, plain_depthwise_conv7x7),
            "int8": (launch_fused_block_int8, plain_convnext_block_int8)}


def glue_cases():
    """(kind, shape, cout) of every new kernel at the tower's real shapes: the
    stages of a 2 x 1024x832 bucket and the odd full-field ones."""
    bucket = stage_shapes_of(2, *PAIR_HW)
    ffdm = stage_shapes_of(1, *FFDM_SHAPES[0])
    cases = [("stem", (2, *PAIR_HW, 3), 96), ("stem", (1, *FFDM_SHAPES[0], 3), 96)]
    for src, dst in list(zip(bucket, bucket[1:])) + list(zip(ffdm[:2], ffdm[1:3])):
        cases.append(("downsample", src, dst[-1]))
    for shape in bucket + [ffdm[0]]:
        cases.append(("depthwise", shape, None))
        cases.append(("int8", shape, None))
    return cases


def phase_glue_parity(device, gen):
    """Each new kernel against its plain version, fp32 (TF32 off) and bf16."""
    kernels = glue_kernels()
    worst = {}
    for kind, shape, cout in glue_cases():
        for dtype in (torch.float32, torch.bfloat16):
            for tanh in ((False, True) if kind == "int8" else (None,)):
                args = glue_inputs(kind, shape, dtype, gen, device, cout)
                launch, plain = kernels[kind]
                kw = {} if tanh is None else {"gelu_tanh": tanh}
                out = launch(*args, **kw)
                ref = plain(*args, **kw)
                torch.cuda.synchronize()
                if kind == "int8":  # hold the block's own term: x dominates x + mlp
                    err, rel = rel_err(out.float() - args[0].float(), ref.float() - args[0].float())
                    tol = INT8_REL_TOL
                else:
                    err, rel = rel_err(out, ref)
                    tol = FP32_REL_TOL if dtype == torch.float32 else BF16_REL_TOL
                label = f"{kind} {shape}" + (f"->{cout}" if cout else "") + f" {str(dtype)[6:]}"
                if tanh is not None:
                    label += f" gelu={'tanh' if tanh else 'exact'}"
                log(f"  {label}: max_abs {err:.3e} rel {rel:.3e} (tol {tol:.1e})")
                if not rel <= tol:
                    raise AssertionError(f"{label}: rel {rel} > {tol}")
                worst[(kind, shape, dtype)] = max(err, worst.get((kind, shape, dtype), 0.0))
    return worst


# ----------------------------------------------------------------------
# phase 5b: JAX's threefry and flax's dropout (port-only kernel)
DROPOUT_SHAPES = ((64, 768), (4096, 4096))  # the exam head's hidden batch; a large draw
DROPOUT_RATES = (0.2, 0.5)                   # train_exam_reports_clf's; the binary presets'
# the integer and float operations of one element of mmg_dropout: threefry's
# 2 + 5 x (4 x (add, rotate, xor) + 2 key adds) = 72, then xor, shift, or,
# subtract, compare, divide, select
DROPOUT_OPS_PER_ELEMENT = 79
THREEFRY_OPS_PER_COUNTER = 72


def dropout_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x, g


def phase_dropout_parity(device):
    """``mmg_dropout`` and ``mmg_threefry2x32`` against the plain version on
    the CPU (``utils/prng.py``): masks, outputs and gradients bit-equal at
    ``DROPOUT_SHAPES``, keys of ``split`` and ``fold_in`` bit-equal.
    -> the largest absolute difference (0.0)."""
    from mmgclip_tpu_torch.ops import dropout as dropout_op
    from mmgclip_tpu_torch.utils import prng

    key = prng.split(prng.key(3), 3)[0]
    for n in (2, 3):
        if not torch.equal(dropout_op.split(key.to(device), n).cpu(), prng.split(key, n)):
            raise AssertionError(f"threefry2x32 split({n}) differs from jax.random.split's")
    fold = prng.make_rng_constant(["Dropout_0"])
    if not torch.equal(dropout_op.fold_in(key.to(device), fold).cpu(), prng.fold_in(key, fold)):
        raise AssertionError("threefry2x32 fold_in differs from jax.random.fold_in's")
    worst = 0.0
    for shape in DROPOUT_SHAPES:
        x, g = dropout_inputs(shape)
        for rate in DROPOUT_RATES:
            out, mask = dropout_op.launch_dropout(x.to(device), key.to(device), fold, 1.0 - rate)
            ref, ref_mask = dropout_op.plain_dropout(x, key, fold, 1.0 - rate)
            xc, xg = x.clone().requires_grad_(True), x.to(device).requires_grad_(True)
            dropout_op.dropout(xc, key, fold, rate).backward(g)
            dropout_op.dropout(xg, key.to(device), fold, rate).backward(g.to(device))
            err = max((out.cpu() - ref).abs().max().item(), (xg.grad.cpu() - xc.grad).abs().max().item())
            equal = (torch.equal(mask.cpu().bool(), ref_mask) and torch.equal(out.cpu(), ref)
                     and torch.equal(xg.grad.cpu(), xc.grad))
            log(f"    dropout {shape} rate {rate}: mask, output and gradient bit-equal to the plain "
                f"version on the CPU: {equal} (kept {ref_mask.float().mean().item():.4f})")
            if not equal:
                raise AssertionError(f"dropout {shape} rate {rate} differs from its plain version: {err}")
            worst = max(worst, err)
    log("    threefry2x32 split(2), split(3), fold_in: bit-equal to jax.random's (plain version)")
    return worst


def train_launches(experiment):
    """The launches a fused training run makes through the kernel wrappers on
    the card: every eager step, and the one step the CUDA graph records, split
    the trainer's key and the step key (two threefry2x32) and draw each
    Dropout site once; replays count none."""
    if experiment.use_cuda_graph:
        traced = experiment._warm_steps + (experiment._graph is not None)
    else:
        traced = sum(experiment.timings["epoch_steps"])
    model = experiment.model
    heads = [model.image_projection, model.text_projection]
    if experiment._impression_bank is not None:
        heads.append(model.text_projection)  # the T2T branch
    sites = sum(len(h._folds) for h in heads if h is not None and getattr(h, "dropout", 0.0))
    expected = {"threefry2x32": 2 * traced}
    if sites:
        expected["dropout"] = traced * sites
    return expected


def timing_dropout(device, peaks, launches, err):
    """``mmg_dropout`` and ``mmg_threefry2x32`` beside the plain version on
    the card (the same torch ops on CUDA tensors) and their bounds: device
    time per call of back-to-back calls.  Integer operations bound at the
    ``int32`` rate of ``PEAKS``.  -> the two ``kernels`` entries."""
    from mmgclip_tpu_torch.ops import dropout as dropout_op
    from mmgclip_tpu_torch.utils import prng

    key = prng.key(3).to(device)
    fold = prng.make_rng_constant(["Dropout_0"])
    entries = {}
    for shape in DROPOUT_SHAPES:
        x = dropout_inputs(shape)[0].to(device)
        n = x.numel()
        ms = device_ms(lambda: dropout_op.launch_dropout(x, key, fold, 0.8))
        plain = chained_ms(lambda: dropout_op.plain_dropout(x, key, fold, 0.8))
        moved = n * (4 + 4 + 1) + 16
        bms, by = max((moved / peaks["bytes"] * 1e3, "bytes"),
                      (n * DROPOUT_OPS_PER_ELEMENT / peaks["int32"] * 1e3, "operations"))
        log(f"    dropout {shape} fp32 rate 0.2: kernel {ms:.5f} ms, plain {plain:.5f} ms (the "
            f"torch ops on the card, chained calls), bound {bms:.5f} ms ({by}); device time per call")
        if shape == DROPOUT_SHAPES[0]:
            entries["dropout"] = {
                "name": "dropout", "route": "cuda", "source": "mmgclip_tpu_torch/csrc/threefry_dropout.cu",
                "replaces": None, "launches": launches.get("dropout", 0), "max_abs_err": err,
                "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": None,
                "work": f"flax nn.Dropout(0.2) of the exam head's {list(shape)} fp32 batch "
                        "(threefry bits, uniform, mask, x / keep); port-only kernel; device time"}
    ms = device_ms(lambda: dropout_op.launch_threefry2x32(key, 0, 3))
    plain = chained_ms(lambda: prng.split(key, 3))
    bms = max(((16 + 48) / peaks["bytes"] * 1e3, "bytes"),
              (3 * THREEFRY_OPS_PER_COUNTER / peaks["int32"] * 1e3, "operations"))
    log(f"    threefry2x32 split(key, 3): kernel {ms:.5f} ms, plain {plain:.5f} ms (chained calls), "
        f"bound {bms[0]:.7f} ms ({bms[1]}); device time per call")
    entries["threefry2x32"] = {
        "name": "threefry2x32", "route": "cuda", "source": "mmgclip_tpu_torch/csrc/threefry_dropout.cu",
        "replaces": None, "launches": launches.get("threefry2x32", 0), "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain, "bound_ms": bms[0], "bound_by": bms[1], "library_ms": None,
        "work": "jax.random.split(key, 3), the step key into the three heads' keys; port-only "
                "kernel; device time"}
    return [entries["dropout"], entries["threefry2x32"]]


def write_store_tree(root):
    """Annotation JSONs, patient lists and 16-bit PNGs in the dataset's layout
    (<base>/<pid[:2]>/<pid>/st02/<image_id>.png): two images of each
    full-field shape and one corrupt file.  -> (base, annotated, lists, good
    paths, corrupt path)."""
    base = os.path.join(root, "png_archive", "2D_100micron", "0")
    annotated = os.path.join(root, "annotations")
    lists = os.path.join(root, "lists")
    for folder in ("02_benign", "02_stl"):
        os.makedirs(os.path.join(annotated, folder))
    os.makedirs(lists)
    specs = [(2000000, "cl", FFDM_SHAPES[0], True), (2000001, "cr", FFDM_SHAPES[1], True),
             (2100000, "ml", FFDM_SHAPES[0], False), (2100001, "mr", FFDM_SHAPES[1], False),
             (2000002, "cl", None, True)]
    patients = {True: [], False: []}
    good, corrupt = [], None
    for patient, view, shape, benign in specs:
        pid = f"{patient:08d}"
        image_id = f"p{pid}02{view}"
        png = os.path.join(base, pid[:2], pid, "st02", f"{image_id}.png")
        os.makedirs(os.path.dirname(png), exist_ok=True)
        if shape is None:
            with open(png, "wb") as fh:
                fh.write(b"\x89PNG\r\n\x1a\n" + b"\x00" * 64)  # a signature and no chunks
            corrupt = png
        else:
            write_png16(png, synthetic_mammogram(*shape, seed=patient % 97))
            good.append(png)
        regions = {} if benign else {"r0": {"is_malign": True, "is_mass": True,
                                            "properties": {"mass_margin": "Spiculated"}}}
        folder = "02_benign" if benign else "02_stl"
        with open(os.path.join(annotated, folder, f"{image_id}.json"), "w") as fh:
            json.dump({f"{image_id}_png": {"regions": regions}}, fh)
        patients[benign].append(pid)
    for benign, name in ((True, "normal_patients.txt"), (False, "malignant_patients.txt")):
        with open(os.path.join(lists, name), "w") as fh:
            fh.write("patient_id\n" + "\n".join(patients[benign]) + "\n")
    return base, annotated, lists, good, corrupt


def store_config(run_dir, tree, out, quant=True, extra=()):
    """The int8 + fused-glue feature-store preset over the synthetic tree."""
    from mmgclip_tpu_torch.config import compose

    base, annotated, lists = tree[:3]
    overrides = ["networks=clip_convnext_fused_tanh_bert",
                 "networks.image_encoder.config.fuse_stem=true",
                 "networks.image_encoder.config.fuse_downsample=true",
                 f"dataset.config.base_dataset_path={base}",
                 f"dataset.config.annotated_dataset_path={annotated}",
                 f"dataset.config.lists_dataset_path={lists}",
                 f"base.features_export_dir={out}"]
    if quant:
        overrides.append("networks.image_encoder.config.quant=int8")
    return compose(os.path.join(REPO, "configs"), "train_binary_class_clf",
                   overrides + list(extra), run_dir=run_dir)


def check_counts(label, counts, expected):
    """Every kernel's launches in a path's run equal ``expected`` (0 unless named)."""
    for kernel, launched in counts.items():
        if launched != expected.get(kernel, 0):
            raise AssertionError(f"{label}: launches {counts}, expected {expected}")
    log(f"    {label}: launches {counts}")


def cosine(a, b):
    a, b = np.asarray(a, np.float64).reshape(len(a), -1), np.asarray(b, np.float64).reshape(len(b), -1)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def extract_store(cfg, rows, good, device, label, expected):
    """``ImageFeatureExtractor.extract()`` with the counts reset just before
    and read just after -> (stored features by source path, seconds, counts)."""
    from mmgclip_tpu_torch.ingest.encode import ImageFeatureExtractor
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts

    ex = ImageFeatureExtractor(config=cfg, dataset=rows, device=device)
    set_layer_scale(ex.module, 0.1)
    reset_launch_counts()
    t0 = time.perf_counter()
    n = ex.extract()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    check_counts(label, counts, expected)
    if n != len(good):
        raise AssertionError(f"{label}: extract() stored {n} of {len(good)} images")
    feats = {}
    for png in good:
        vec = np.load(ex._export_path(png))
        if vec.shape != (1, 768, 1, 1) or vec.dtype != np.float32 or not np.isfinite(vec).all():
            raise AssertionError(f"{label}: {png} -> {vec.shape} {vec.dtype}")
        feats[png] = vec.reshape(-1)
    failed = open(os.path.join(ex.export_dir, "failed.txt")).read().split("\n")
    if [line for line in failed[::3] if line] != [r["image_path"] for r in rows
                                                  if r["image_path"] not in good]:
        raise AssertionError(f"{label}: failed.txt reads {failed}")
    log(f"    {label}: {n} images stored in {seconds:.2f}s ({n / seconds:.2f} img/s, host clock, "
        f"decode and writes included); failed.txt: {failed[0]!r}: {failed[1]!r}")
    return feats, seconds, counts, ex


def phase_feature_store(device, tmp):
    """The feature-store path: int8 blocks + fused stem + fused downsample."""
    from mmgclip_tpu_torch.data.ingest import create_dataset_df
    from mmgclip_tpu_torch.ingest.encode import _Encoder
    from mmgclip_tpu_torch.serving import InferenceEngine

    tree = write_store_tree(os.path.join(tmp, "tree"))
    good = tree[3]
    cfg = store_config(tmp, tree, os.path.join(tmp, "store"))
    rows = create_dataset_df(cfg)
    if len(rows) != 5:
        raise AssertionError(f"create_dataset_df gave {len(rows)} rows, expected 5")
    per_bucket = {"fused_stem": 1, "fused_ln_downsample": 3, "fused_convnext_block_int8": 18}
    buckets = len(FFDM_SHAPES)
    feats, seconds, counts, ex = extract_store(
        cfg, rows, good, device, "feature store (exact shape, int8 + fused stem/downsample)",
        {k: v * buckets for k, v in per_bucket.items()})

    engine = InferenceEngine(cfg)
    set_layer_scale(engine.encode_module, 0.1)
    served = engine.encode_paths(good)
    engine.close()
    cos = cosine([feats[p] for p in good], served)
    log(f"    stored vs InferenceEngine.encode_paths, same config: cosine {cos.tolist()}")
    if not (cos >= STORE_VS_SERVED_COSINE).all():
        raise AssertionError(f"stored vs served cosine {cos} < {STORE_VS_SERVED_COSINE}")

    bf16 = _Encoder(store_config(tmp, tree, os.path.join(tmp, "unused"), quant=False), device=device)
    set_layer_scale(bf16.module, 0.1)
    from mmgclip_tpu_torch.ingest.png_reader import decode_png

    ref = [bf16._encode_fn()(torch.from_numpy(decode_png(p)[None]).to(device)).float().cpu().numpy()[0]
           for p in good]
    cos = cosine([feats[p] for p in good], ref)
    log(f"    int8 vs bf16 fused tower features: cosine {cos.tolist()}")
    if not (cos >= INT8_VS_BF16_COSINE).all():
        raise AssertionError(f"int8 vs bf16 cosine {cos} < {INT8_VS_BF16_COSINE}")
    return tree, rows, feats, seconds, counts, ex, bf16


def phase_masked(device, tmp, tree, rows, exact_feats):
    """The masked paths: resize + host prepool, and bucket rounding."""
    from mmgclip_tpu_torch.ingest.encode import _Encoder
    from mmgclip_tpu_torch.ingest.png_reader import decode_png

    per_bucket = {"fused_stem": 1, "fused_convnext_block_int8": 18}
    resize_cfg = store_config(tmp, tree, os.path.join(tmp, "store_resize"), extra=[
        f"dataset.config.encode_resize=[{PAIR_HW[0]},{PAIR_HW[1]}]",
        "dataset.config.encode_host_prepool=2"])
    good = tree[3]
    resized, _s, _c, resize_ex = extract_store(
        resize_cfg, rows, good, device,
        f"resize {list(PAIR_HW)} + host prepool 2 (masked, 2 native-shape buckets)",
        {k: v * len(FFDM_SHAPES) for k, v in per_bucket.items()})
    round_cfg = store_config(tmp, tree, os.path.join(tmp, "store_round"),
                             extra=[f"dataset.config.encode_bucket_rounding={ROUNDING}"])
    rounded, _s, _c, round_ex = extract_store(
        round_cfg, rows, good, device,
        f"bucket rounding {ROUNDING} (masked, one {rounded_canvas()} bucket)", per_bucket)
    cos = cosine([rounded[p] for p in good], [exact_feats[p] for p in good])
    log(f"    bucketed vs exact-shape features, bf16 int8 tower: cosine {cos.tolist()}")
    if not (cos >= BUCKET_INT8_COSINE).all():
        raise AssertionError(f"bucketed int8 cosine {cos} < {BUCKET_INT8_COSINE}")

    fp32 = _Encoder(store_config(tmp, tree, os.path.join(tmp, "unused"), quant=False,
                                 extra=["networks.image_encoder.config.dtype=float32"]), device=device)
    set_layer_scale(fp32.module, 0.1)
    images = [decode_png(good[0]), decode_png(good[1])]  # one of each shape
    canvas = np.zeros((2, *rounded_canvas()), np.uint16)
    for i, img in enumerate(images):
        canvas[i, : img.shape[0], : img.shape[1]] = img
    valid = torch.tensor([img.shape for img in images], dtype=torch.int32, device=device)
    exact = np.concatenate([fp32._encode_fn()(torch.from_numpy(img[None]).to(device)).cpu().numpy()
                            for img in images])
    masked = fp32._masked_encode_fn()(torch.from_numpy(canvas).to(device), valid).cpu().numpy()
    rel = np.linalg.norm(exact - masked, axis=1) / np.linalg.norm(exact, axis=1)
    log(f"    bucketed vs exact-shape features, fp32 fused tower: relative L2 {rel.tolist()}")
    if not (rel <= BUCKET_FP32_REL_L2).all():
        raise AssertionError(f"bucketed fp32 relative L2 {rel} > {BUCKET_FP32_REL_L2}")
    return resize_ex, round_ex, fp32


def phase_depthwise_tower(device, engine):
    """The engine's weights in an unfused tower with the standalone depthwise
    kernel, against the plain unfused tower, on one 2 x 1024x832 bucket."""
    from mmgclip_tpu_torch.ingest.encode import build_encode_program
    from mmgclip_tpu_torch.models.convnext import ConvNeXt
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts

    towers = {}
    for pallas in (True, False):
        cfg = dataclasses.replace(engine.cn_config, use_fused_blocks=False, use_pallas_dwconv=pallas)
        module = ConvNeXt(cfg)
        module.load_state_dict(engine.encode_module.state_dict())
        towers[pallas] = build_encode_program(module.to(device).eval(), cfg.in_channels)
    pixels = torch.from_numpy(np.stack([synthetic_mammogram(*PAIR_HW, seed=20 + j)
                                        for j in range(2)])).to(device)
    reset_launch_counts()
    feats = towers[True](pixels)
    torch.cuda.synchronize()
    counts = launch_counts()
    check_counts(f"depthwise tower (unfused, use_pallas_dwconv), 2 x {PAIR_HW}", counts,
                 {"depthwise_conv7x7": 18})
    cos = cosine(feats.float().cpu().numpy(), towers[False](pixels).float().cpu().numpy())
    log(f"    depthwise tower vs plain unfused tower, bf16: cosine {cos.tolist()}")
    if not (cos >= FEATURE_COSINE_MIN).all():
        raise AssertionError(f"depthwise tower cosine {cos} < {FEATURE_COSINE_MIN}")
    return towers, pixels, counts


def int8_block_parts(x, p):
    """The int8 block's parts alone, on preallocated buffers, for timing
    each: the depthwise front half into the fp32 workspace
    (``mmg_fused_block_depthwise``), ``mmg_fused_block_ln_mlp_int8`` on
    weights packed once, and the wrapper's per-call quantise-and-pack of the
    weights (``int8_weights``).  They count no launch."""
    from mmgclip_tpu_torch.ops import _build
    from mmgclip_tpu_torch.ops import fused_block as fb

    lib = _build.load_typed(fb._SOURCE, fb._SIGNATURES)
    n, h, w, c = x.shape
    dwk, dwb, ns, nb, w1, b1, w2, b2, gamma = p
    ws = torch.empty((n * h * w, c), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    w1p, ws1, w2p, ws2 = fb.int8_weights(w1, w2)
    stream = torch.cuda.current_stream().cuda_stream
    code = fb._DTYPES[x.dtype]

    def front():
        _build.check(lib, lib.mmg_fused_block_depthwise(code, x.data_ptr(), dwk.data_ptr(), dwb.data_ptr(),
                                                        ws.data_ptr(), n, h, w, c, stream),
                     "int8 block depthwise half")

    def back():
        ptrs = [t.data_ptr() for t in (ws, x, ns, nb, w1p, ws1, b1, w2p, ws2, b2, gamma, out)]
        _build.check(lib, lib.mmg_fused_block_ln_mlp_int8(code, *ptrs, n, h, w, c, fb.EPS, 0, stream),
                     "int8 block ln_mlp half")

    return front, back, lambda: fb.int8_weights(w1, w2)


def timing_glue(device, gen, peaks, glue_err, store_counts, dw_counts):
    """Each new kernel per shape beside its plain version and bound; the JSON
    entries sum one bucket's work: the feature store's 2 x 2294x1914 bucket
    (stem, downsample, int8 block) and the depthwise tower's 2 x 1024x832."""
    import torch.nn.functional as F

    kernels = glue_kernels()
    ffdm2 = stage_shapes_of(2, *FFDM_SHAPES[0])
    bucket = stage_shapes_of(2, *PAIR_HW)
    depths = (3, 3, 9, 3)
    work = {  # kernel -> [(shape, cout, repeats)] of the JSON entry
        "stem": [((2, *FFDM_SHAPES[0], 3), 96, 1)],
        "downsample": [(src, dst[-1], 1) for src, dst in zip(ffdm2, ffdm2[1:])],
        "int8": [(s, None, d) for s, d in zip(ffdm2, depths)],
        "depthwise": [(s, None, d) for s, d in zip(bucket, depths)],
    }
    per_shape = {kind: [(shape, cout) for k, shape, cout in glue_cases() if k == kind]
                 for kind in work}
    for kind, items in work.items():
        for shape, cout, _r in items:
            if (shape, cout) not in per_shape[kind]:
                per_shape[kind].append((shape, cout))
    totals = {}
    for kind, shapes in per_shape.items():
        launch, plain = kernels[kind]
        for shape, cout in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                args = glue_inputs(kind, shape, dtype, gen, device, cout)
                # device time per call of back-to-back calls; the int8 plain
                # version waits for the device itself (device_ms cannot queue
                # it): chained calls, its stalls included
                library, parts, extra = None, {}, ""
                ms = device_ms(lambda: launch(*args))
                plain_ms = (chained_ms if kind == "int8" else device_ms)(lambda: plain(*args))
                if kind == "depthwise":
                    x, w, b = args
                    w_oihw = w.permute(3, 2, 0, 1).contiguous()
                    library = device_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, padding=3,
                                                         groups=shape[-1]))
                if kind == "int8":  # the two launches alone, and the wrapper's weight preparation
                    front, back, prepare = int8_block_parts(args[0], args[1:])
                    parts = {"depthwise_ms": device_ms(front), "ln_mlp_ms": device_ms(back),
                             "quant_pack_ms": device_ms(prepare)}
                    extra = (f" = depthwise half {parts['depthwise_ms']:.4f} + ln_mlp_int8 "
                             f"{parts['ln_mlp_ms']:.4f} + weights quantised and packed "
                             f"{parts['quant_pack_ms']:.4f}")
                if kind == "stem":  # two library calls, so logged only: library_ms stays none
                    two = device_ms(lambda: stem_by_library(*args))
                    diff, _ = rel_err(stem_by_library(*args), plain(*args))
                    extra = (f"; two library calls (F.conv2d 4x4/4 + F.layer_norm, after the cast "
                             f"and br_pad copy) {two:.4f} ms, max_abs {diff:.3e} from plain")
                host = time_ms(lambda: launch(*args))
                bms, by = {"stem": lambda: stem_bound(shape, cout, torch.float32, dtype, peaks),
                           "downsample": lambda: downsample_bound(shape, cout, dtype, peaks),
                           "depthwise": lambda: depthwise_bound(shape, dtype, peaks),
                           "int8": lambda: int8_block_bound(shape, dtype, peaks)}[kind]()
                lib = "" if library is None else f", library {library:.4f} ms"
                chained = " (chained calls)" if kind == "int8" else ""
                log(f"    {kind} {shape}" + (f"->{cout}" if cout else "") + f" {str(dtype)[6:]}: "
                    f"kernel {ms:.4f} ms{extra}, plain {plain_ms:.4f} ms{chained}{lib}, bound {bms:.4f} "
                    f"ms ({by}); device time per call; one checked call {host:.4f} ms with its host time")
                if dtype != torch.bfloat16:
                    continue
                for wshape, wcout, reps in work[kind]:
                    if (wshape, wcout) == (shape, cout):
                        t = totals.setdefault(kind, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                                     "library_ms": None, "by": []})
                        t["ms"] += reps * ms
                        t["plain_ms"] += reps * plain_ms
                        t["bound_ms"] += reps * bms
                        t["by"].append(by)
                        for key, value in parts.items():
                            t[key] = t.get(key, 0.0) + reps * value
                        if library is not None:
                            t["library_ms"] = (t["library_ms"] or 0.0) + reps * library
    meta = {
        "int8": ("fused_convnext_block_int8", "mmgclip_tpu_torch/csrc/fused_block.cu",
                 "mmgclip_tpu/ops/fused_block.py:281", store_counts,
                 "18 int8 blocks of one 2x2294x1914 feature-store bucket, bf16; device time "
                 "(the weights' quantise-and-pack in quant_pack_ms, inside ms); plain as chained "
                 "calls"),
        "stem": ("fused_stem", "mmgclip_tpu_torch/csrc/fused_stem.cu",
                 "mmgclip_tpu/ops/fused_stem.py:99", store_counts,
                 "the stem of one 2x2294x1914 feature-store bucket, fp32 input, bf16 weights; "
                 "device time"),
        "downsample": ("fused_ln_downsample", "mmgclip_tpu_torch/csrc/fused_downsample.cu",
                       "mmgclip_tpu/ops/fused_downsample.py:134", store_counts,
                       "3 downsamples of one 2x2294x1914 feature-store bucket, bf16; device time"),
        "depthwise": ("depthwise_conv7x7", "mmgclip_tpu_torch/csrc/depthwise_conv.cu",
                      "mmgclip_tpu/ops/depthwise_conv.py:46", dw_counts,
                      "18 depthwise convs of one 2x1024x832 bucket, bf16; device time"),
    }
    entries = []
    for kind in ("int8", "stem", "downsample", "depthwise"):
        name, source, replaces, counts, what = meta[kind]
        t = totals[kind]
        errs = [v for (k, shape, dt), v in glue_err.items() if k == kind and dt == torch.bfloat16]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": max(errs), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "operations" if t["by"].count("operations") * 2 >= len(t["by"]) else "bytes",
            "library_ms": t["library_ms"], "work": what,
            **{key: t[key] for key in ("depthwise_ms", "ln_mlp_ms", "quant_pack_ms") if key in t},
        })
    return entries


def timing_programs(device, engine, store_ex, resize_ex, round_ex, bf16_enc, dw_towers, dw_pixels,
                    tree, smi):
    """Encode-program img/s of each new config (CUDA events), extract() img/s
    (host clock) and the Paeth PNG decode (host clock)."""
    from mmgclip_tpu_torch.ingest.encode import host_prepool
    from mmgclip_tpu_torch.ingest.png_reader import decode_png

    out = {}
    pair = torch.from_numpy(np.stack([synthetic_mammogram(*PAIR_HW, seed=30 + j)
                                      for j in range(2)])).to(device)
    ffdm = np.stack([decode_png(tree[3][0]), decode_png(tree[3][2])])  # both FFDM_SHAPES[0]
    ffdm_t = torch.from_numpy(ffdm).to(device)
    h, w = FFDM_SHAPES[0]
    canvas = np.zeros((2, *rounded_canvas()), np.uint16)
    canvas[:, :h, :w] = ffdm
    canvas_t = torch.from_numpy(canvas).to(device)
    valid = torch.tensor([[h, w]] * 2, dtype=torch.int32, device=device)
    sums, scale = host_prepool(ffdm, 2)
    sums_t = torch.from_numpy(sums).to(device)
    resized = resize_ex._resized_encode_fn()
    pair_s, ffdm_s = f"2 x {PAIR_HW[0]}x{PAIR_HW[1]}", f"2 x {h}x{w}"
    cases = [
        ("int8 + fused glue, exact shape", pair_s, 2, lambda: store_ex._encode_fn()(pair)),
        ("int8 + fused glue, exact shape", ffdm_s, 2, lambda: store_ex._encode_fn()(ffdm_t)),
        ("bf16 fused tanh + fused glue (no int8), exact shape", pair_s, 2,
         lambda: bf16_enc._encode_fn()(pair)),
        ("bf16 fused tanh + fused glue (no int8), exact shape", ffdm_s, 2,
         lambda: bf16_enc._encode_fn()(ffdm_t)),
        (f"int8, resize {list(PAIR_HW)} + prepool 2 (device half)", ffdm_s, 2,
         lambda: resized(sums_t, native_hw=(h, w), scale=scale)),
        (f"int8, bucket rounding {ROUNDING} (masked)", f"2 x {rounded_canvas()} canvas", 2,
         lambda: round_ex._masked_encode_fn()(canvas_t, valid)),
        ("unfused bf16 + depthwise kernel", pair_s, 2, lambda: dw_towers[True](dw_pixels)),
        ("unfused bf16, plain depthwise", pair_s, 2, lambda: dw_towers[False](dw_pixels)),
    ]
    for label, size, n, fn in cases:
        ms = time_ms(fn, warmup=2, iters=5)
        out[f"{label}, {size}"] = ms
        log(f"    encode program {label}, {size}: {ms:.2f} ms = {1e3 * n / ms:.2f} img/s")

    # extract() end to end on the host clock, a second time into a fresh dir,
    # with its decode / device / write split (host clock, _Encoder.timings)
    from mmgclip_tpu_torch.ingest.encode import ImageFeatureExtractor

    ex = ImageFeatureExtractor(config=store_ex.config, dataset=store_ex.dataset, device=device)
    ex.export_dir = os.path.join(os.path.dirname(store_ex.export_dir), "store_timed")
    os.makedirs(ex.export_dir)
    set_layer_scale(ex.module, 0.1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = ex.extract()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out["extract"], out["extract_split"] = seconds, dict(ex.timings)
    split = ex.timings
    log(f"    extract() of {n} full-field PNGs (int8 preset), second run: {seconds:.3f} s = "
        f"{n / seconds:.2f} img/s (host clock, decode and writes included; {smi}); decode "
        f"{split['decode_s']:.3f} s summed over {ex.decode_threads} threads, of which the main "
        f"thread waited {split['decode_wait_s']:.3f} s; device (assembly, copies, launches, "
        f"read-backs) {split['device_s']:.3f} s; .npy writes {split['write_s']:.3f} s")

    # one full-field file with every row Paeth-filtered: the compiled unfilter
    # against the plain numpy / Python one (the unfilter swapped in the reader)
    from mmgclip_tpu_torch.ingest import png_reader

    png = os.path.join(os.path.dirname(store_ex.export_dir), "paeth.png")
    pixels = synthetic_mammogram(*FFDM_SHAPES[0], seed=41)
    write_png16(png, pixels, paeth=True)

    def decode_s(path, repeats):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            decoded = decode_png(path)
            best = min(best, time.perf_counter() - t0)
        return best, decoded

    paeth_s, decoded = decode_s(png, 5)
    if not np.array_equal(decoded, pixels):
        raise AssertionError("Paeth-filtered PNG decoded wrong")
    plain_s, _ = decode_s(tree[3][0], 5)
    compiled = png_reader.unfilter
    png_reader.unfilter = lambda data, h, stride, bpp: png_reader._unfilter(memoryview(data), h, stride, bpp)
    try:
        paeth_plain_s, decoded = decode_s(png, 1)
    finally:
        png_reader.unfilter = compiled
    if not np.array_equal(decoded, pixels):
        raise AssertionError("Paeth-filtered PNG decoded wrong by the plain unfilter")
    out.update(paeth_decode_s=paeth_s, paeth_plain_decode_s=paeth_plain_s, unfiltered_decode_s=plain_s)
    log(f"    decode_png {h}x{w} 16-bit (host clock, best of 5; {smi}): every row Paeth {paeth_s:.4f} s "
        f"compiled unfilter, {paeth_plain_s:.2f} s plain unfilter (one call); unfiltered {plain_s:.4f} s")
    return out


def timing_reports(device, report, smi):
    """``generate_report`` for one image and one four-view exam, run again
    after phase 16 (host clock, model load included) beside phase 16's first
    runs, and the socket server's ms per request."""
    for label, flag, value in (("image", "--image_id", REPORT_IMAGE), ("exam", "--exam_id", REPORT_EXAM)):
        *_, seconds = run_generate_report(device, report["report_dir"], flag, value)
        log(f"    generate_report {flag} {value}: {seconds:.3f} s, first run {report['times'][label]:.3f} s "
            f"(host clock, model load included; {smi})")
    for op, (median, p90) in report["times"]["serve_ms"].items():
        log(f"    serve_socket {op}: {median:.2f} ms median, {p90:.2f} ms p90 per request "
            f"(host clock, 36 concurrent clients; {smi})")


# ----------------------------------------------------------------------
# the ring all-gather, the global contrastive loss and training
RING_RANKS = (2, 4, 8)
RING_CASES = (((32, 512), torch.float32), ((32, 512), torch.bfloat16),
              ((256, 768), torch.float32), ((5, 100), torch.float32))
RING_REPEATS = 50             # back-to-back calls, generation rising
LOSS_REL_TOL = 1e-6           # global loss through the ring vs single-device loss, fp32
GRAD_ABS_TOL = 1e-5           # their gradients per rank
TRAIN_LOSS_REL_TOL = 1e-5     # reduced-width training, card vs CPU, per-epoch losses
VIEWS = ("cl", "cr", "ml", "mr")


def ring_shards(ranks, shape, dtype, device, rng):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
            for _ in range(ranks)]


def bit_equal(outs, refs):
    return all(o.shape == r.shape and torch.equal(o.view(torch.uint8), r.view(torch.uint8))
               for o, r in zip(outs, refs))


def phase_ring_parity(device):
    """Every rank's output bit-equal to ``ring_all_gather_plain``; 50 calls
    back to back; a withheld signal raises instead of hanging."""
    from mmgclip_tpu_torch.parallel import check_ring, launch_ring_all_gather, ring_all_gather_plain
    from mmgclip_tpu_torch.parallel.collectives import _launch_ring

    rng = np.random.default_rng(12)
    worst = 0.0
    for ranks in RING_RANKS:
        for shape, dtype in RING_CASES:
            shards = ring_shards(ranks, shape, dtype, device, rng)
            outs = launch_ring_all_gather(shards)
            refs = ring_all_gather_plain(shards)
            worst = max([worst] + [(o.float() - r.float()).abs().max().item() for o, r in zip(outs, refs)])
            if not bit_equal(outs, refs):
                raise AssertionError(f"ring P={ranks} {shape} {dtype}: not bit-equal to torch.cat")
        log(f"    ring P={ranks}: {[f'{s} {str(d)[6:]}' for s, d in RING_CASES]} bit-equal to the plain version")
    batches = [ring_shards(8, (32, 512), torch.float32, device, rng) for _ in range(RING_REPEATS)]
    outs = [_launch_ring(shards) for shards in batches]
    check_ring(device)
    if not all(bit_equal(o, ring_all_gather_plain(s)) for o, s in zip(outs, batches)):
        raise AssertionError("ring: a back-to-back call differs from the plain version")
    log(f"    ring P=8 (32, 512) float32: {RING_REPEATS} calls back to back, no sync between, all bit-equal")
    try:
        _launch_ring(batches[0][:4], timeout_ns=20_000_000, drop_step=0)
        check_ring(device)
    except RuntimeError as exc:
        log(f"    ring with step 0's signals withheld (20 ms timeout): raised {str(exc)[:70]}...")
    else:
        raise AssertionError("ring: a withheld signal did not raise")
    if not bit_equal(launch_ring_all_gather(batches[1][:4]), ring_all_gather_plain(batches[1][:4])):
        raise AssertionError("ring: the call after a timeout is wrong")
    return worst


def unit_rows(ranks, local, d, device, rng):
    from mmgclip_tpu_torch.models.clip import l2_normalize

    return [l2_normalize(t).requires_grad_() for t in ring_shards(ranks, (local, d), torch.float32,
                                                                  device, rng)]


def phase_global_loss(device):
    """global_clip_loss / global_mmgclip_loss through the ring over 8 ranks x
    32 rows x 512 against the single-device losses on the 256 rows."""
    from mmgclip_tpu_torch.losses import clip_loss, mmgclip_loss
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgclip_tpu_torch.parallel import global_clip_loss, global_mmgclip_loss

    rng = np.random.default_rng(13)
    scale = torch.tensor(1 / 0.07, device=device)
    launches = 0
    for name, fn, ref_fn, kinds, expected in (
            ("global_clip_loss", global_clip_loss,
             lambda i, t: clip_loss(scale * i @ t.T, scale * t @ i.T)[0], 2, 2),
            ("global_mmgclip_loss", global_mmgclip_loss,
             lambda i, t, t2: mmgclip_loss(i, t, t2, scale)[0], 3, 4)):
        shards = [unit_rows(8, 32, 512, device, rng) for _ in range(kinds)]
        reset_launch_counts()
        loss, _labels = fn(*shards, scale, use_ring_gather=True)
        torch.cuda.synchronize()
        counts = launch_counts()
        check_counts(f"{name}, 8 ranks x 32 x 512, ring gathers", counts, {"ring_all_gather": expected})
        launches += counts["ring_all_gather"]
        loss.backward()
        full = [torch.cat([t.detach() for t in s]).requires_grad_() for s in shards]
        ref = ref_fn(*full)
        ref.backward()
        rel = abs(loss.item() - ref.item()) / abs(ref.item())
        grad = max((torch.cat([t.grad for t in s]) - f.grad).abs().max().item()
                   for s, f in zip(shards, full))
        log(f"    {name}: ring {loss.item():.8f} vs single device {ref.item():.8f}: rel {rel:.3e} "
            f"(tol {LOSS_REL_TOL:.0e}); gradients max_abs {grad:.3e} (tol {GRAD_ABS_TOL:.0e})")
        if not (rel <= LOSS_REL_TOL and grad <= GRAD_ABS_TOL):
            raise AssertionError(f"{name}: loss rel {rel}, gradient {grad}")
    return launches


def write_train_tree(root, n_per_class):
    """An ImageLabelDataset tree: region JSONs, patient lists, placeholder
    PNGs and class-separable 768-d .npy features (the tests' separable
    fixture).  -> (base, annotated, lists, features)."""
    base = os.path.join(root, "png_archive", "2D_100micron", "0")
    annotated = os.path.join(root, "annotations")
    lists = os.path.join(root, "lists")
    features = os.path.join(root, "features")
    for folder in ("02_benign", "02_stl"):
        os.makedirs(os.path.join(annotated, folder))
    os.makedirs(lists)
    rng = np.random.default_rng(0)
    direction = np.sign(np.arange(768) % 2 - 0.5).astype(np.float32)
    tiny = np.zeros((8, 8), np.uint16)
    patients = {True: [], False: []}
    for benign in (True, False):
        for i in range(n_per_class):
            pid = f"{(2000000 if benign else 2100000) + i:08d}"
            image_id = f"p{pid}02{VIEWS[i % 4]}"
            png = os.path.join(base, pid[:2], pid, "st02", f"{image_id}.png")
            os.makedirs(os.path.dirname(png), exist_ok=True)
            write_png16(png, tiny)
            if benign:
                regions = ({"r0": {"is_mass": True, "properties": {"mass_margin": "Circumscribed",
                                                                   "mass_shape": "Oval"}}}
                           if i % 2 == 0 else {})
            else:
                regions = {"r0": {"is_malign": True, "is_mass": i % 3 != 0,
                                  "is_architectural_distortion": i % 4 == 0,
                                  "is_calcification_cluster": i % 3 == 0,
                                  "properties": ({"mass_margin": "Spiculated", "mass_shape": "Irregular"}
                                                 if i % 3 != 0 else {})}}
            with open(os.path.join(annotated, "02_benign" if benign else "02_stl",
                                   f"{image_id}.json"), "w") as fh:
                json.dump({f"{image_id}_png": {"regions": regions}}, fh)
            feats = rng.normal(size=(1, 768, 1, 1)).astype(np.float32)
            feats[0, :, 0, 0] += (3.0 if benign else -3.0) * direction
            path = os.path.join(features, "0", "02", pid[:2], pid, "st02", f"{image_id}.npy")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, feats)
            patients[benign].append(pid)
    for benign, name in ((True, "normal_patients.txt"), (False, "malignant_patients.txt")):
        with open(os.path.join(lists, name), "w") as fh:
            fh.write("patient_id\n" + "\n".join(patients[benign]) + "\n")
    return base, annotated, lists, features


def train_config(run_dir, tree, extra=()):
    from mmgclip_tpu_torch.config import compose, save_snapshot

    base, annotated, lists, features = tree
    cfg = compose(os.path.join(REPO, "configs"), "train_binary_class_clf", [
        f"dataset.config.base_dataset_path={base}",
        f"dataset.config.annotated_dataset_path={annotated}",
        f"dataset.config.lists_dataset_path={lists}",
        f"base.features_export_dir={features}",
        f"base.tensorboard_export_dir={run_dir}/runs",
        "scheduler.config.epochs=3", *extra], run_dir=run_dir)
    save_snapshot(cfg, run_dir)  # what compose_run writes: evaluate_clip and serving read it
    return cfg


GRAPH_REL_TOL = 1e-6          # graphed vs eager fused epochs: losses and params, fp32


def graph_vs_eager(device, cfg, label, epochs=2):
    """Two experiments built from one seeded config: the fused epoch as a
    CUDA graph in one, eager in the other, ``epochs`` epochs each (the first
    graphed epoch starts with its eager warm-up steps and the capture).
    Losses and the trainable params must agree within ``GRAPH_REL_TOL``; a
    last graphed epoch runs under ``torch.profiler`` for the device time of a
    step.  Both runs pin cuDNN's deterministic algorithms: its default
    weight-gradient algorithms (the ResNet's ``layer4`` backward) sum in an
    order that varies from run to run, graph or not.  -> {"graph_ms",
    "eager_ms", "bit_equal", "kernel_ms"} per step."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        return _graph_vs_eager(device, cfg, label, epochs)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _graph_vs_eager(device, cfg, label, epochs):
    from mmgclip_tpu_torch.train import build_experiment
    from mmgclip_tpu_torch.training.optim import set_learning_rate
    from mmgclip_tpu_torch.weights import clip_params_tree, flatten_tree

    out, runs = {}, {}
    for mode in ("graph", "eager"):
        experiment = build_experiment(cfg, device=device)
        experiment.use_cuda_graph = mode == "graph" and device.type == "cuda"
        losses = []
        for epoch in range(epochs):
            experiment.current_epoch = epoch
            set_learning_rate(experiment.optimizer, experiment.scheduler.lr_at(epoch))
            losses.append(experiment.train())
        if mode == "graph" and (experiment._graph is None) == (device.type == "cuda"):
            raise AssertionError(f"{label}: graph captured {experiment._graph is not None} on {device}")
        steps = experiment.timings["epoch_steps"]
        out[f"{mode}_ms"] = ([ms / n for ms, n in zip(experiment.timings["epoch_device_ms"], steps)]
                             if experiment.timings["epoch_device_ms"] else [])
        runs[mode] = (experiment, np.asarray(losses), flatten_tree(clip_params_tree(experiment.model)))
    (graphed, g_loss, g_params), (_eager, e_loss, e_params) = runs["graph"], runs["eager"]
    rel = float(np.max(np.abs(g_loss - e_loss) / np.abs(e_loss)))
    param_rel = max(float(np.max(np.abs(g_params[k] - v)) / max(float(np.max(np.abs(v))), 1e-30))
                    for k, v in e_params.items())
    out["bit_equal"] = bool(np.array_equal(g_loss, e_loss)
                            and all(np.array_equal(g_params[k], v) for k, v in e_params.items()))
    log(f"    {label}: graphed vs eager fused epochs (dropout "
        f"{cfg.get_path('networks.dropout.config.dropout', 0.0)}): losses {g_loss.tolist()} vs "
        f"{e_loss.tolist()}, max rel {rel:.3e}, params max rel {param_rel:.3e} (tol "
        f"{GRAPH_REL_TOL:.0e}); bit-equal: {out['bit_equal']}; ms per step (CUDA events over the "
        f"epoch) graphed {[round(v, 4) for v in out['graph_ms']]}, eager "
        f"{[round(v, 4) for v in out['eager_ms']]}")
    if not (rel <= GRAPH_REL_TOL and param_rel <= GRAPH_REL_TOL):
        raise AssertionError(f"{label}: graphed and eager epochs differ: {rel}, {param_rel}")
    out["kernel_ms"] = None
    if device.type == "cuda":
        graphed.current_epoch = epochs
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            graphed.train()
        kernel_us = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        steps, epoch_ms = graphed.timings["epoch_steps"][-1], graphed.timings["epoch_device_ms"][-1]
        if kernel_us > 0:
            out["kernel_ms"] = kernel_us / 1e3 / steps
            log(f"    {label}: torch.profiler over one graphed epoch: device time "
                f"{out['kernel_ms']:.4f} ms per step against {epoch_ms / steps:.4f} ms per step "
                f"on CUDA events (the card idle {1 - out['kernel_ms'] * steps / epoch_ms:.1%})")
        else:
            log(f"    {label}: torch.profiler saw no device time in the graphed epoch: "
                f"a step's device time is not measured")
    return out


def phase_training(device, tmp, smi):
    """``mmgclip_tpu_torch.train.run`` at full width (BERT-base, 1xLinear512,
    batch 32, AdamW + warmup-cosine, 3 epochs, then test()), the stored run
    re-evaluated by ``evaluate_clip`` (its results.json equal to test()'s),
    the trained run served, and the same training at reduced width on the card and the CPU."""
    from mmgclip_tpu_torch.evaluate_clip import main as evaluate_main
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgclip_tpu_torch.serve import handle
    from mmgclip_tpu_torch.serving import InferenceEngine
    from mmgclip_tpu_torch.train import run
    from mmgclip_tpu_torch.utils.tb import read_scalars

    tree = write_train_tree(os.path.join(tmp, "train_tree"), 256)
    run_dir = os.path.join(tmp, "train_run")
    cfg = train_config(run_dir, tree)
    reset_launch_counts()
    t0 = time.perf_counter()
    experiment = run(cfg, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check_counts("training + test() (the key splits of each traced step; 1xLinear512 has no "
                 "Dropout)", counts, train_launches(experiment))
    text = experiment.model.bert_config
    scalars = read_scalars(cfg.base.tensorboard_export_dir)
    train_loss, val_loss = scalars["loss/train"], scalars["loss/val"]
    log(f"    BERT {text.hidden_size}x{text.num_hidden_layers}x{text.num_attention_heads} "
        f"({text.intermediate_size}), {cfg.projection.config.projection_name} "
        f"{cfg.projection.config.output_projection_dimension}, batch {cfg.dataloader.train.batch_size}: "
        f"train loss {train_loss}, val loss {val_loss}, val AUC malig {scalars.get('auc/val/malig')}")
    for name in (experiment.ckp_path, os.path.join(cfg.base.results_export_dir, "results.json"),
                 os.path.join(cfg.base.results_export_dir, "results.txt")):
        if not os.path.isfile(name):
            raise AssertionError(f"training did not write {name}")
    if not (np.isfinite(train_loss).all() and np.isfinite(val_loss).all() and len(train_loss) == 3):
        raise AssertionError(f"epoch losses {train_loss} / {val_loss}")
    if not train_loss[-1] < train_loss[0]:
        raise AssertionError(f"train loss did not fall on separable data: {train_loss}")
    with open(os.path.join(cfg.base.results_export_dir, "results.json")) as fh:
        tested = json.load(fh)
    results = tested["BenignMalignantDatasetLabels"]["zeroshot_label_prompt"]
    log(f"    test(): accuracy {results['accuracy']}, AUC CI mean {results.get('auc_ci_mean')} "
        f"[{results.get('auc_ci_lower')}, {results.get('auc_ci_higher')}]")

    # main path step 3: re-evaluate the stored run through the entry point, on the card
    reset_launch_counts()
    t0 = time.perf_counter()
    evaluate_main(["--experiment_path", run_dir, "--run_name", "replay"])
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    check_counts("evaluate_clip (the Evaluator on the stored checkpoint)", launch_counts(), {})
    with open(os.path.join(run_dir, "replay", "results.json")) as fh:
        replayed = json.load(fh)
    if replayed != tested:
        raise AssertionError(f"evaluate_clip's results.json differs from test()'s: {replayed} vs {tested}")
    log(f"    evaluate_clip --experiment_path <run> --run_name replay (on the card): results.json "
        f"equal to test()'s, {replay_s:.3f} s (host clock)")

    engine = InferenceEngine.from_experiment(run_dir)
    base = experiment.train_dataloader.dataset
    while hasattr(base, "dataset"):
        base = base.dataset
    rows = [0, 1, len(base) - 2, len(base) - 1]
    feats = base._features[rows].reshape(len(rows), -1).astype("<f4")
    prompts = ["Finding suggesting benign.", "Finding suggesting malignant."]
    response = handle(engine, {"op": "classify", "features_b64": base64.b64encode(feats.tobytes()).decode(),
                               "features_rows": len(rows), "class_list": prompts})
    engine.close()
    probs = np.asarray(response["classes_similarities"])
    if probs.shape != (len(rows), 2) or not np.isfinite(probs).all() or \
            not np.allclose(probs.sum(1), 1.0, atol=1e-5):
        raise AssertionError(f"classify from the trained run: {response}")
    log(f"    the trained run served (InferenceEngine.from_experiment on the card): classify of "
        f"{[base.rows[i]['image_label'] for i in rows]} -> argmax {response['similarities_argmax']}")

    steps = experiment.timings["epoch_steps"]
    device_ms = experiment.timings["epoch_device_ms"]
    bs = cfg.dataloader.train.batch_size
    per_step = [ms / n for ms, n in zip(device_ms, steps)]
    times = {"bank_s": experiment.timings["bank_s"], "test_s": experiment.timings["test_s"],
             "step_ms": per_step[-1], "samples_per_s": 1e3 * bs / per_step[-1], "wall_s": wall}
    log(f"    times ({smi}): text bank {times['bank_s']:.3f} s for {len(base)} rows (host clock); "
        f"train step {', '.join(f'{v:.3f}' for v in per_step)} ms per epoch (CUDA events over the "
        f"fused epoch / {steps[0]} steps) = {times['samples_per_s']:.0f} samples/s in the last epoch; "
        f"test() {times['test_s']:.3f} s; run() {wall:.1f} s (host clock)")

    times["graph"] = graph_vs_eager(device, train_config(os.path.join(tmp, "graph_check"), tree),
                                    "train_binary_class_clf at full width")

    small = write_train_tree(os.path.join(tmp, "small_tree"), 32)
    extra = ["networks.text_encoder.config={hidden_size: 64, num_hidden_layers: 2, "
             "num_attention_heads: 4, intermediate_size: 128}",
             "networks.dropout.config.dropout=0.0", "dataloader.train.batch_size=8",
             "dataloader.valid.batch_size=4", "dataloader.test.batch_size=4"]
    losses = {}
    for dev in ("cuda", "cpu"):
        small_cfg = train_config(os.path.join(tmp, f"small_{dev}"), small, extra)
        run(small_cfg, device=dev)
        got = read_scalars(small_cfg.base.tensorboard_export_dir)
        losses[dev] = np.asarray(got["loss/train"] + got["loss/val"])
    rel = np.abs(losses["cuda"] - losses["cpu"]) / np.abs(losses["cpu"])
    log(f"    reduced width (BERT 64x2, 64 images, dropout 0, TF32 off): card {losses['cuda'].tolist()} "
        f"vs CPU {losses['cpu'].tolist()} (train then val per epoch): max rel {rel.max():.3e} "
        f"(tol {TRAIN_LOSS_REL_TOL:.0e})")
    if not (np.isfinite(rel).all() and rel.max() <= TRAIN_LOSS_REL_TOL):
        raise AssertionError(f"card vs CPU training losses differ by {rel}")
    return times, run_dir, tree


# ----------------------------------------------------------------------
# the product gates (tests/test_fastpath_parity.py's recipe)
GATE_AUC_DELTA = 0.005        # every prompt's zero-shot AUC, a variant's store vs the baseline's
GATE_MIN_AUC = 0.9            # the baseline learned the planted signal: the gate is not vacuous
GATE_TEXT = ("{vocab_size: 4096, hidden_size: 64, num_hidden_layers: 2, num_attention_heads: 4, "
             "intermediate_size: 128, max_position_embeddings: 64}")
GATE_VARIANTS = {  # speed knob -> (tower config, the kernels its store must launch)
    "fused": ({"use_fused_blocks": True}, ("fused_convnext_block",)),
    "fused_tanh": ({"use_fused_blocks": True, "gelu": "tanh"}, ("fused_convnext_block",)),
    "fused_int8_tanh": ({"use_fused_blocks": True, "gelu": "tanh", "quant": "int8"},
                        ("fused_convnext_block_int8",)),
    "fused_tanh_glue": ({"use_fused_blocks": True, "gelu": "tanh", "fuse_stem": True,
                         "fuse_downsample": True},
                        ("fused_convnext_block", "fused_stem", "fused_ln_downsample")),
    "use_pallas_dwconv": ({"use_pallas_dwconv": True}, ("depthwise_conv7x7",)),
}
GATE_REPORT_PATIENTS = (2000000, 2000001, 2100000, 2100001)


def write_gate_tree(root, n_per_class=16, size=32):
    """``tests/fixtures.py::build_image_label_tree(n_benign=16, n_malignant=16,
    image_size=32, feature_store=False, pixel_class_signal=True)`` written
    without PIL: 8-bit PNGs whose intensity band is the class.  -> (base,
    annotated, lists)."""
    base = os.path.join(root, "png_archive", "2D_100micron", "0")
    annotated = os.path.join(root, "02_data_T_regions")
    lists = os.path.join(root, "lists")
    for folder in ("02_benign", "02_stl"):
        os.makedirs(os.path.join(annotated, folder))
    os.makedirs(lists)

    def region(malign=False, mass=False, arch=False, calc=False, margin=None, shape=None):
        properties = {k: v for k, v in (("mass_margin", margin), ("mass_shape", shape)) if v}
        return {"is_mass": mass, "is_malign": malign, "is_architectural_distortion": arch,
                "is_calcification_cluster": calc, "is_individual_calcification": False,
                "properties": properties}

    patients = {True: [], False: []}
    for benign in (True, False):
        for i in range(n_per_class):
            pid = f"{(2000000 if benign else 2100000) + i:08d}"
            image_id = f"p{pid}02{VIEWS[i % 4]}"
            png = os.path.join(base, pid[:2], pid, "st02", f"{image_id}.png")
            os.makedirs(os.path.dirname(png), exist_ok=True)
            band = (0, 128) if benign else (128, 256)
            write_png8(png, np.random.default_rng(i).integers(*band, size=(size, size), dtype=np.uint8))
            if benign:
                regions = {"r0": region(mass=True, margin="Circumscribed", shape="Oval")} if i % 2 == 0 else {}
            else:
                regions = {"r0": region(malign=True, mass=i % 3 != 0, arch=i % 4 == 0, calc=i % 3 == 0,
                                        margin="Spiculated" if i % 3 != 0 else None,
                                        shape="Irregular" if i % 3 != 0 else None)}
            with open(os.path.join(annotated, "02_benign" if benign else "02_stl",
                                   f"{image_id}.json"), "w") as fh:
                json.dump({f"{image_id}_png": {"regions": regions}}, fh)
            patients[benign].append(pid)
    for benign, name in ((True, "normal_patients.txt"), (False, "malignant_patients.txt")):
        with open(os.path.join(lists, name), "w") as fh:
            fh.write("patient_id\n" + "\n".join(patients[benign]) + "\n")
    return base, annotated, lists


def gate_config(run_dir, tree, features, checkpoints, tower=None):
    """The JAX gate's config: the micro tower on one input channel with the
    given knobs, the tiny BERT, 10 epochs at lr 5e-3, batch 8."""
    from mmgclip_tpu_torch.config import compose

    base, annotated, lists = tree
    knobs = {"micro": True, "in_channels": 1, **(tower or {})}
    flow = ", ".join(f"{k}: {str(v).lower() if isinstance(v, bool) else v}" for k, v in knobs.items())
    return compose(os.path.join(REPO, "configs"), "train_binary_class_clf", [
        f"dataset.config.base_dataset_path={base}",
        f"dataset.config.annotated_dataset_path={annotated}",
        f"dataset.config.lists_dataset_path={lists}",
        f"base.features_export_dir={features}",
        f"base.tensorboard_export_dir={run_dir}/runs",
        f"checkpoints.checkpoints_export_dir={checkpoints}",
        "tokenizer.config.sequence_length=32",
        f"networks.text_encoder.config={GATE_TEXT}",
        f"networks.image_encoder.config={{{flow}}}",
        "scheduler.config.epochs=10", "base.patience=10", "optimizer.config.learning_rate=5e-3",
        "dataloader.train.batch_size=8", "dataloader.valid.batch_size=2",
        "dataloader.test.batch_size=2"], run_dir=run_dir)


def gate_store(device, tmp, tree, checkpoints, tag, knobs=None, expected=()):
    """Encode the tree's feature store with ``knobs`` through
    ``ImageFeatureExtractor.extract()``, the launch counts set to 0 just
    before and read just after; on the card every kernel in ``expected``
    launched once per block (stem, downsample) of every batch and no other
    kernel did; on the CPU none did.  -> the store's directory."""
    from mmgclip_tpu_torch.data.ingest import create_dataset_df
    from mmgclip_tpu_torch.ingest.encode import ImageFeatureExtractor
    from mmgclip_tpu_torch.models.convnext import ConvNeXt
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgclip_tpu_torch.utils.seeding import seeding

    knobs = dict(knobs or {})
    dwconv = knobs.pop("use_pallas_dwconv", False)
    features = os.path.join(tmp, f"features_{tag}")
    cfg = gate_config(os.path.join(tmp, f"enc_{tag}"), tree, features, checkpoints, knobs)
    seeding(int(cfg.base.seed))
    rows = create_dataset_df(config=cfg)
    ex = ImageFeatureExtractor(config=cfg, dataset=rows, device=device)
    if dwconv:  # no config key reaches use_pallas_dwconv (nor in the JAX package): same weights
        cn = dataclasses.replace(ex.cn_config, use_pallas_dwconv=True)
        module = ConvNeXt(cn)
        module.load_state_dict(ex.module.state_dict())
        ex.module, ex.cn_config = module.to(device).eval(), cn
    reset_launch_counts()
    stored = ex.extract()
    if device.type == "cuda":
        torch.cuda.synchronize()
    counts = launch_counts()
    if stored != len(rows):
        raise AssertionError(f"gate store {tag}: {stored} of {len(rows)} images stored")
    batches = -(-len(rows) // ex.batch_size)  # one 32x32 bucket
    per_batch = {"fused_stem": 1, "fused_ln_downsample": len(ex.cn_config.dims) - 1}
    blocks = sum(ex.cn_config.depths)
    want = {k: batches * per_batch.get(k, blocks) for k in expected} if device.type == "cuda" else {}
    check_counts(f"gate store {tag} ({stored} images)", counts, want)
    return features


def evaluator_aucs(cfg, device):
    """Zero-shot AUC per prompt of ``cfg``'s checkpoint over its feature
    store (the whole dataset, in order), through the ``Evaluator``."""
    from mmgclip_tpu_torch.data.datasets import get_dataset
    from mmgclip_tpu_torch.data.loader import DataLoaders
    from mmgclip_tpu_torch.evaluation.evaluator import Evaluator
    from mmgclip_tpu_torch.utils.seeding import seeding

    seeding(int(cfg.base.seed))
    dataset = get_dataset(cfg.dataset.eval.dataset.name)(config=cfg)
    loader = DataLoaders(config=cfg, dataset_split=dataset).get_dataloader(
        batch_size=4, shuffle=False, drop_last=False, collate_fn=dataset.collate_fn)
    results = Evaluator(config=cfg, test_dataloader=loader, tokenizer=dataset.tokenizer,
                        device=device).evaluate_experiment()
    for block in results:
        if isinstance(block, dict):
            aucs = {k: v["auc"] for k, v in block.items() if isinstance(v, dict) and "auc" in v}
            if aucs:
                return aucs
    raise AssertionError(f"no AUC block in {results!r}")


def gate_aucs(device, tmp, tree, checkpoints, tag, features):
    """The shared checkpoint's zero-shot AUC per prompt over one store."""
    return evaluator_aucs(gate_config(os.path.join(tmp, f"eval_{tag}"), tree, features, checkpoints),
                          device)


def phase_product_gates(device, tmp):
    """The JAX package's product gates for every speed knob of the tower:
    train one checkpoint on plain-path features (no kernel knob), encode the
    store once per knob through its kernels, evaluate the checkpoint on each
    store and generate the reports through ``InferenceEngine``.  Fails unless
    the baseline's best AUC is >= 0.9, every prompt's AUC is within 0.005 of
    the baseline's and the reports are byte-identical, for every knob.
    Runs on the CPU too (every knob then takes the plain versions).
    -> {store: {prompt: AUC}}."""
    import glob

    from mmgclip_tpu_torch.serving import InferenceEngine
    from mmgclip_tpu_torch.train import run as train_run

    tree = write_gate_tree(os.path.join(tmp, "gate_tree"))
    checkpoints = os.path.join(tmp, "gate_checkpoints")
    baseline = gate_store(device, tmp, tree, checkpoints, "baseline")
    train_run(gate_config(os.path.join(tmp, "gate_train"), tree, baseline, checkpoints),
              device=device)
    engine = InferenceEngine(gate_config(os.path.join(tmp, "gate_report"), tree, baseline,
                                         checkpoints), device=device)

    def reports(features):
        rows = []
        for patient in GATE_REPORT_PATIENTS:
            stored = sorted(glob.glob(os.path.join(features, "**", f"{patient:08d}", "**", "*.npy"),
                                      recursive=True))
            rows.append(np.load(stored[0]).reshape(-1))
        return engine.generate_reports(np.stack(rows).astype(np.float32), seed=42)

    aucs = {"baseline": gate_aucs(device, tmp, tree, checkpoints, "baseline", baseline)}
    base_reports = reports(baseline)
    log(f"    baseline (plain path): AUC {aucs['baseline']}; {len(base_reports)} reports")
    failures = []
    if not max(aucs["baseline"].values()) >= GATE_MIN_AUC:
        failures.append(f"baseline best AUC {max(aucs['baseline'].values())} < {GATE_MIN_AUC}")
    for tag, (knobs, kernels) in GATE_VARIANTS.items():
        features = gate_store(device, tmp, tree, checkpoints, tag, knobs, kernels)
        aucs[tag] = gate_aucs(device, tmp, tree, checkpoints, tag, features)
        same = reports(features) == base_reports
        if set(aucs[tag]) != set(aucs["baseline"]):
            failures.append(f"{tag}: prompts {sorted(aucs[tag])}")
            continue
        delta = max(abs(aucs[tag][k] - v) for k, v in aucs["baseline"].items())
        log(f"    {tag}: AUC {aucs[tag]}, max |delta| {delta:.6f} (tol {GATE_AUC_DELTA}); "
            f"reports {'byte-identical' if same else 'DIFFER'}")
        if not delta <= GATE_AUC_DELTA:
            failures.append(f"{tag}: AUC moved by {delta} > {GATE_AUC_DELTA}")
        if not same:
            failures.append(f"{tag}: generated reports moved against the baseline's")
    engine.close()
    if failures:
        raise AssertionError("product gates failed: " + "; ".join(failures))
    return aucs

# ----------------------------------------------------------------------
# phase 16: generate_report, evaluate_cnn and the socket server over the trained run
REPORT_TOWER = {"dtype": "bfloat16", "use_fused_blocks": True, "gelu": "tanh", "quant": "int8",
                "fuse_stem": True, "fuse_downsample": True}  # the feature-store preset of phase 8
REPORT_IMAGE = "p0200000002cl"
REPORT_EXAM = "0210000002"  # patient 02100000, study 02: four views
PER_VIEW_LAUNCHES = {"fused_stem": 1, "fused_ln_downsample": 3, "fused_convnext_block_int8": 18}
SERVE_PROB_TOL = 1e-5         # a merged classify against the same request alone


def report_run(tmp, run_dir, shapes, tower):
    """A run dir with ``run_dir``'s checkpoint whose snapshot encodes through
    the ``tower`` knobs, with a seeded tower (layer scale 0.1) written to flax
    bytes, over a tree of Paeth-filtered 16-bit PNGs: the image of
    ``REPORT_IMAGE`` (``shapes[0]``) and the four views of ``REPORT_EXAM``
    (two of each shape).  -> (run dir, image path, exam view paths)."""
    from mmgclip_tpu_torch.config import Config, recompose, save_snapshot
    from mmgclip_tpu_torch.data.paths import create_exam_path, create_path
    from mmgclip_tpu_torch.ingest.encode import load_convnext_tower
    from mmgclip_tpu_torch.utils.flax_msgpack import to_bytes
    from mmgclip_tpu_torch.weights import module_tree

    base = os.path.join(tmp, "report_tree")
    image = create_path(REPORT_IMAGE, base)
    exam = create_exam_path(REPORT_EXAM, base)
    views = [os.path.join(exam, f"p{REPORT_EXAM}{view}.png") for view in VIEWS]
    for i, (path, shape) in enumerate(zip([image, *views], [shapes[0], *shapes, *shapes])):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_png16(path, synthetic_mammogram(*shape, seed=60 + i), paeth=True)

    cfg = recompose(run_dir)
    cfg.networks.image_encoder.config = Config(tower)
    module, _cn = load_convnext_tower(cfg)
    set_layer_scale(module, 0.1)
    weights = os.path.join(tmp, "report_convnext.npz")
    with open(weights, "wb") as fh:
        fh.write(to_bytes({"params": module_tree(module)}))
    report_dir = os.path.join(tmp, "report_run")
    cfg.networks.image_encoder.convnext_tiny_clf_path = weights
    cfg.dataset.config.base_dataset_path = base
    cfg.dataset.config.concatenate_features_method = "avgpool"
    cfg.checkpoints.checkpoints_export_dir = os.path.join(report_dir, "checkpoints")
    save_snapshot(cfg, report_dir)
    shutil.copytree(os.path.join(run_dir, "checkpoints"), cfg.checkpoints.checkpoints_export_dir)
    return report_dir, image, views


def run_generate_report(device, report_dir, flag, value):
    """``generate_report.main`` as a user calls it -> (decisions, text, seconds)."""
    from mmgclip_tpu_torch import generate_report

    argv = ["--experiment_path", report_dir, flag, value]
    if device.type != "cuda":
        argv += ["--device", str(device)]
    t0 = time.perf_counter()
    decisions, text = generate_report.main(argv)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return decisions, text, time.perf_counter() - t0


def phase_report_paths(device, tmp, run_dir, train_tree, shapes=FFDM_SHAPES, tower=REPORT_TOWER):
    """Main-path step 4 and the rest of the entry points over a trained run:
    ``generate_report`` for one image and for one four-view exam, each equal
    (decisions and text) to ``InferenceEngine.cascade_decisions`` +
    ``generate_reports`` on ``encode_paths`` / the fused exam of the same
    config; ``evaluate_cnn`` over the run's stored features, its table equal
    to the CPU's within 1e-5; the unix-socket server answering 32 concurrent
    inline ``classify`` and 4 path ``report`` requests as ``handle`` does.
    Launches: the tower's per view (``PER_VIEW_LAUNCHES``) on the card.
    Runs on the CPU too (every knob then takes the plain versions).
    -> {"report_dir", "image", "views", "times"}."""
    import asyncio
    import threading

    from mmgclip_tpu_torch import evaluate_cnn
    from mmgclip_tpu_torch.config import compose
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgclip_tpu_torch.ops.fusion import fuse_views
    from mmgclip_tpu_torch.serve import handle, serve_socket
    from mmgclip_tpu_torch.serving import InferenceEngine

    on_card = device.type == "cuda"
    per_view = PER_VIEW_LAUNCHES if on_card else {}
    report_dir, image, views = report_run(tmp, run_dir, shapes, tower)
    times, got = {}, {}
    for label, flag, value, n_views in (("image", "--image_id", REPORT_IMAGE, 1),
                                        ("exam", "--exam_id", REPORT_EXAM, len(views))):
        reset_launch_counts()
        decisions, text, times[label] = run_generate_report(device, report_dir, flag, value)
        check_counts(f"generate_report {flag} {value} ({n_views} view(s))", launch_counts(),
                     {k: v * n_views for k, v in per_view.items()})
        got[label] = (decisions, text)
        log(f"    generate_report {flag} {value}: {times[label]:.2f} s (host clock, model load "
            f"included); {json.dumps(decisions)}; {text[:80]}...")

    engine = InferenceEngine.from_experiment(report_dir, device=device)
    seed = int(engine.config.base.seed)
    exam = np.concatenate([engine.encode_paths([v]) for v in views])  # one view a call, as the entry point
    fused = fuse_views(torch.from_numpy(exam).to(device).to(engine.cn_config.dtype), "avgpool")
    for label, feats in (("image", engine.encode_paths([image])),
                         ("exam", fused.float().cpu().numpy()[None])):
        library = (engine.cascade_decisions(feats)[0],
                   engine.generate_reports(feats, seed=seed, bug_compat=True)[0])
        if library != got[label]:
            raise AssertionError(f"generate_report ({label}) {got[label]} != the engine's {library}")
    log("    decisions and report text equal to InferenceEngine.cascade_decisions + "
        "generate_reports on encode_paths (image) and on the fused views (exam)")

    # evaluate_cnn over the trained run's stored features, card against CPU
    base, annotated, lists, features = train_tree
    cnn_dir = os.path.join(tmp, "cnn_run")
    cnn_cfg = compose(os.path.join(REPO, "configs"), "evaluate_cnn_clf", [
        f"dataset.config.base_dataset_path={base}", f"dataset.config.annotated_dataset_path={annotated}",
        f"dataset.config.lists_dataset_path={lists}", f"base.features_export_dir={features}",
        "dataloader.test.batch_size=8", f"hydra.run.dir={cnn_dir}"], run_dir=cnn_dir)
    reset_launch_counts()
    t0 = time.perf_counter()
    table = evaluate_cnn.run(cnn_cfg, device=device)
    times["evaluate_cnn"] = time.perf_counter() - t0
    check_counts("evaluate_cnn (the classifier head on stored features)", launch_counts(), {})
    cpu_rows = evaluate_cnn.run(cnn_cfg, device="cpu").rows
    for (name, auroc), (cpu_name, cpu_auroc) in zip(table.rows, cpu_rows):
        if name != cpu_name or not (abs(auroc - cpu_auroc) <= 1e-5
                                    or (np.isnan(auroc) and np.isnan(cpu_auroc))):
            raise AssertionError(f"evaluate_cnn rows {table.rows} vs CPU {cpu_rows}")
    if len(table.rows) != len(cpu_rows) or not table.rows:
        raise AssertionError(f"evaluate_cnn rows {table.rows} vs CPU {cpu_rows}")
    log(f"    evaluate_cnn: {table.rows} in {times['evaluate_cnn']:.2f} s (host clock), "
        f"equal to --device cpu within 1e-5")

    # the unix-socket server: 32 concurrent inline classify, 4 report by path
    stored = sorted(os.path.join(r, f) for r, _d, fs in os.walk(features) for f in fs if f.endswith(".npy"))
    rows = np.stack([np.load(path).reshape(-1) for path in stored[:32]]).astype("<f4")
    prompts = ["Finding suggesting benign.", "Finding suggesting malignant."]
    requests = [{"op": "classify", "id": i, "class_list": prompts,
                 "features_b64": base64.b64encode(row.tobytes()).decode()} for i, row in enumerate(rows)]
    requests += [{"op": "report", "id": 32 + i, "paths": [path], "seed": 7}
                 for i, path in enumerate([image, *views[:3]])]
    calls = []
    classify = engine.classify

    def counted_classify(features, class_list):
        calls.append(np.asarray(features).shape[0])
        return classify(features, class_list)

    sock = f"\0mmgclip-smoke-{os.getpid()}"  # abstract: no path-length limit, no file
    loop, ready, tasks = asyncio.new_event_loop(), threading.Event(), []

    def run_server():
        tasks.append(loop.create_task(serve_socket(engine, unix_path=sock, ready_event=ready)))
        try:
            loop.run_until_complete(tasks[0])
        except asyncio.CancelledError:
            pass
        finally:
            loop.close()

    responses, latency = {}, {}

    def client(request):
        import socket

        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(300)
        with conn:
            conn.connect(sock)
            t0 = time.perf_counter()
            conn.sendall((json.dumps(request) + "\n").encode())
            line = conn.makefile().readline()
            latency[request["id"]] = (time.perf_counter() - t0) * 1e3
        responses[request["id"]] = json.loads(line)

    engine.classify = counted_classify
    server = threading.Thread(target=run_server, name="serve-socket")
    server.start()
    try:
        if not ready.wait(60):
            raise AssertionError("the socket server did not start")
        reset_launch_counts()
        clients = [threading.Thread(target=client, args=(r,)) for r in requests]
        t0 = time.perf_counter()
        for t in clients:
            t.start()
        for t in clients:
            t.join(300)
        times["serve_s"] = time.perf_counter() - t0
        served_counts = launch_counts()
    finally:
        loop.call_soon_threadsafe(tasks[0].cancel)
        server.join(60)
        del engine.classify
    if server.is_alive() or any(t.is_alive() for t in clients):
        raise AssertionError("the socket server or a client did not finish")
    check_counts("serve_socket (4 report requests by path)", served_counts,
                 {k: v * 4 for k, v in per_view.items()})
    for request in requests:
        response = responses.get(request["id"], {})
        expected = handle(engine, request)
        if "result" not in response:
            raise AssertionError(f"socket request {request['id']}: {response}")
        result = response["result"]
        if request["op"] == "report":
            same = result == expected
        else:
            same = (result["similarities_argmax"] == expected["similarities_argmax"]
                    and result["class_list"] == expected["class_list"]
                    and np.abs(np.subtract(result["classes_similarities"],
                                           expected["classes_similarities"])).max() <= SERVE_PROB_TOL)
        if not same:
            raise AssertionError(f"socket request {request['id']}: {result} != handle's {expected}")
    engine.close()
    ms = {op: [latency[r["id"]] for r in requests if r["op"] == op] for op in ("classify", "report")}
    times["serve_ms"] = {op: (float(np.median(v)), float(np.percentile(v, 90))) for op, v in ms.items()}
    log(f"    serve_socket (unix): 32 concurrent classify answered in {len(calls)} engine.classify "
        f"call(s) (rows {calls}); every response equal to handle's (probabilities within "
        f"{SERVE_PROB_TOL:.0e}, reports exact); ms per request median / p90 (host clock, client "
        f"side): " + ", ".join(f"{op} {m:.2f} / {p:.2f}" for op, (m, p) in times["serve_ms"].items())
        + f"; all {len(requests)} in {times['serve_s']:.2f} s")
    return {"report_dir": report_dir, "image": image, "views": views, "times": times}


# ----------------------------------------------------------------------
# phase 17: the exam-report family (encode_studies, train_exam_reports_clf, the heads)
EXAM_PATIENT0 = 2300000
EXAM_STUDIES = 8              # encoded studies, four full-field views each
EXAM_TRAIN_ROWS = 512         # the encoded studies plus seeded separable 768-d features
EXAM_REDUCED_ROWS = 64        # the card-vs-CPU runs at reduced width
EXAM_TEXT_REDUCED = ("{hidden_size: 64, num_hidden_layers: 2, num_attention_heads: 4, "
                     "intermediate_size: 128}")
EXAM_PROMPTS = ["Finding suggesting benign.", "Finding suggesting malignant.", "BIRADS unknown."] + \
    [f"BIRADS score of {i}." for i in range(7)]
PLAIN_TOWER = {"dtype": "bfloat16", "use_fused_blocks": False}  # no kernel on its path


def flow(mapping):
    """A dict as a YAML flow mapping, for a ``key={...}`` override."""
    return "{" + ", ".join(f"{k}: {str(v).lower() if isinstance(v, bool) else v}"
                           for k, v in mapping.items()) + "}"


def exam_labels(i):
    """The ``labels`` cell of study ``i`` (``tests/fixtures.py``'s recipe)."""
    return {"birads": str(2 + i % 4) if i % 3 else "unknown", "malignancy": i % 2,
            "masses": {"shapes": ["oval", "round", "irregular", "unknown"][i % 4], "density": "unknown"},
            "calcifications": {"distribution": ["diffuse", "unknown"][i % 2], "morphology": "unknown"}}


EXAM_WORDS = ("mass", "calcification", "benign", "malignant", "oval", "irregular", "round",
              "margin", "density", "lesion", "breast", "left", "right", "upper", "outer",
              "quadrant", "stable", "new", "suspicious", "biopsy", "follow", "up", "no", "clear")


def exam_row(i, study_path, rng=None):
    """Row ``i`` of an exam table; with ``rng`` its report and impression are
    seeded words of seeded length (texts that differ in length and content,
    so a batch's pooled text features differ: BatchNorm's batch statistics
    stay well-conditioned)."""
    pid = f"{EXAM_PATIENT0 + i:08d}"
    report = f"The report of study {i} shows findings. BIRADS {2 + i % 4}."
    impression = f"Impression of study {i}."
    if rng is not None:
        report, impression = (" ".join(rng.choice(EXAM_WORDS, size=int(rng.integers(3, 24)))) + "."
                              for _ in range(2))
    return {"patient_id": pid, "study_id": "st02", "is_malig": str(i % 2),
            "labels": str(exam_labels(i)), "image_impression": impression,
            "image_description": report, "study_path": study_path}


def write_exam_tree(root, shapes, n_studies):
    """``n_studies`` studies of four 16-bit views (two of each shape, copies
    of eight distinct images, half of them Paeth-filtered) and one study
    whose only view is corrupt, in the store's layout.  -> (rows of the
    post-translation CSV, study dirs with views, the corrupt view)."""
    base = os.path.join(root, "png_archive", "2D_100micron", "0")
    unique = []
    os.makedirs(os.path.join(root, "unique"))
    for k in range(8):  # shape k % 2; Paeth for k in 0, 1, 4, 5
        unique.append(os.path.join(root, "unique", f"{k}.png"))
        write_png16(unique[k], synthetic_mammogram(*shapes[k % 2], seed=80 + k), paeth=(k // 2) % 2 == 0)
    rows, studies, corrupt = [], [], None
    for i in range(n_studies + 1):
        pid = f"{EXAM_PATIENT0 + i:08d}"
        study = os.path.join(base, pid[:2], pid, "st02")
        os.makedirs(study)
        if i == n_studies:
            corrupt = os.path.join(study, f"p{pid}02cl.png")
            with open(corrupt, "wb") as fh:
                fh.write(b"\x89PNG\r\n\x1a\n" + b"\x00" * 64)  # a signature and no chunks
        else:
            for j, view in enumerate(VIEWS):  # views 0, 1 of shape 0; 2, 3 of shape 1
                shutil.copy(unique[2 * ((i + j) % 4) + j // 2], os.path.join(study, f"p{pid}02{view}.png"))
            studies.append(study)
        rows.append(exam_row(i, study))
    return rows, studies, corrupt


def write_exam_training(root, encoded, n_rows, seed=0, varied=False):
    """``final_reports_dataset.csv`` of ``encoded`` rows plus seeded
    separable 768-d study features up to ``n_rows`` (``varied``: with seeded
    reports, see ``exam_row``), and the GTR label csv (half the studies
    have GTR labels).  -> (reports csv, gtr csv)."""
    from mmgclip_tpu_torch.data.csv_table import Table, write_csv

    rng = np.random.default_rng(seed)
    rows = [dict(r) for r in encoded]
    for i in range(len(rows), n_rows):
        pid = f"{EXAM_PATIENT0 + i:08d}"
        path = os.path.join(root, "store", "0", pid[:2], pid, "st02", f"{pid}.npy")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        feat = rng.normal(size=768).astype(np.float32)
        feat[:64] += 3.0 if i % 2 else -3.0
        np.save(path, feat)
        rows.append(exam_row(i, path, rng if varied else None))
    gtr = [{"gtr_path": f"/gtr/{r['patient_id']}02xx.dcm", "gtr_mass": str(i % 4 == 0),
            "gtr_calc": str(i % 4 == 2), "gtr_malign": str(i % 2 == 1),
            "gtr_mass_margin": str(1 + i % 4), "gtr_is_architectural_distortion": str(i % 8 == 4),
            "gtr_histology": str(i % 3)} for i, r in enumerate(rows) if i % 2 == 0]
    reports_csv, gtr_csv = os.path.join(root, "final_reports_dataset.csv"), os.path.join(root, "gtr.csv")
    write_csv(reports_csv, Table.from_rows(rows))
    write_csv(gtr_csv, Table.from_rows(gtr), index=False)
    return reports_csv, gtr_csv


def exam_config(run_dir, reports_csv, gtr_csv, extra=()):
    from mmgclip_tpu_torch.config import compose, save_snapshot

    cfg = compose(os.path.join(REPO, "configs"), "train_exam_reports_clf", [
        f"dataset.config.final_reports_dataset_path={reports_csv}",
        f"dataset.config.gt_path={gtr_csv}",
        f"base.tensorboard_export_dir={run_dir}/runs",
        "scheduler.config.epochs=3", *extra], run_dir=run_dir)
    save_snapshot(cfg, run_dir)  # what compose_run writes: serving reads it
    return cfg


def exam_encode(device, root, smi, shapes, tower, text_extra, n_studies):
    """Phase 17 (a): ``encode_studies`` with ``extract_features=true`` over
    ``n_studies`` studies and one corrupt study, held as ``phase_exam`` says.
    -> (final table, study vectors, times)."""
    from mmgclip_tpu_torch import encode_studies
    from mmgclip_tpu_torch.cli import compose_run
    from mmgclip_tpu_torch.config import Config
    from mmgclip_tpu_torch.data.csv_table import Table, read_csv, write_csv
    from mmgclip_tpu_torch.ingest.encode import _Encoder, load_convnext_tower
    from mmgclip_tpu_torch.ingest.png_reader import decode_png
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgclip_tpu_torch.serving import InferenceEngine
    from mmgclip_tpu_torch.utils.flax_msgpack import to_bytes
    from mmgclip_tpu_torch.weights import module_tree

    on_card = device.type == "cuda"
    times = {}
    t0 = time.perf_counter()
    post_rows, studies, corrupt = write_exam_tree(os.path.join(root, "tree"), shapes, n_studies)
    post_csv = os.path.join(root, "postprocessed_tr_dataset.csv")
    write_csv(post_csv, Table.from_rows(post_rows), encoding="latin1")
    weights_cfg = Config({"networks": {"image_encoder": {"convnext_tiny_clf_path": "",
                                                         "config": Config(tower)}}})
    module, _cn = load_convnext_tower(weights_cfg)
    set_layer_scale(module, 0.1)
    weights = os.path.join(root, "convnext.npz")  # flax bytes; the loader keys on .npz
    with open(weights, "wb") as fh:
        fh.write(to_bytes({"params": module_tree(module)}))
    store = os.path.join(root, "store")
    argv = [f"dataset.config.post_translation_dataset_path={post_csv}",
            "dataset.config.post_translation_fileid=exam", f"base.features_export_dir={store}",
            f"networks.image_encoder.convnext_tiny_clf_path={weights}",
            f"networks.image_encoder.config={flow(tower)}",
            "dataset.config.concatenate_features_method=avgpool", "dataset.config.n_images_per_study=4",
            f"hydra.run.dir={os.path.join(root, 'encode_run')}", "extract_features=true", *text_extra]
    log(f"    {n_studies} studies x 4 views {shapes} (Paeth for half the images) + 1 corrupt "
        f"study written in {time.perf_counter() - t0:.2f} s")
    cwd = os.getcwd()
    os.makedirs(os.path.join(root, "cwd"))
    os.chdir(os.path.join(root, "cwd"))
    try:
        cfg = compose_run("train_exam_reports_clf", argv, snapshot=False)
        reset_launch_counts()
        t0 = time.perf_counter()
        final, extractor = encode_studies.extract(cfg, device=device)
        if on_card:
            torch.cuda.synchronize()
        times["encode_s"] = time.perf_counter() - t0
        counts = launch_counts()
        final_csv = os.path.join(os.getcwd(), "data", "exam", "final_reports_dataset.csv")
    finally:
        os.chdir(cwd)
    calls = 2 * -(-2 * n_studies // extractor.batch_size)  # two shapes, 2 * n_studies views each
    check_counts(f"encode_studies ({4 * n_studies} views in {calls} program calls of one shape each)",
                 counts, {k: v * calls for k, v in (PER_VIEW_LAUNCHES if on_card else {}).items()})
    failed = open(os.path.join(store, "failed.txt")).read().split("\n")
    if failed[0] != corrupt:
        raise AssertionError(f"failed.txt reads {failed[:2]}, expected {corrupt}")
    table = read_csv(final_csv, encoding="latin1", index_col=0)
    if [r["patient_id"] for r in table.rows] != [r["patient_id"] for r in post_rows[:n_studies]]:
        raise AssertionError(f"final_reports_dataset.csv holds {table.column('patient_id')}")
    vectors = np.stack([np.load(r["study_path"]) for r in table.rows])
    if vectors.shape != (n_studies, 768) or not np.isfinite(vectors).all():
        raise AssertionError(f"study vectors {vectors.shape}, finite {np.isfinite(vectors).all()}")
    split = extractor.timings
    log(f"    encode_studies: {n_studies} studies in {times['encode_s']:.2f} s = "
        f"{n_studies / times['encode_s']:.2f} studies/s ({4 * n_studies / times['encode_s']:.2f} "
        f"views/s; host clock, decode and writes included): decode {split['decode_s']:.3f} s summed "
        f"over the threads, waiting on decodes {split['decode_wait_s']:.3f} s, device "
        f"{split['device_s']:.3f} s, writes {split['write_s']:.3f} s ({smi}); failed.txt: "
        f"{os.path.basename(failed[0])!r}: {failed[1]!r}")
    times["encode_split"] = split

    views = [[os.path.join(study, f) for f in sorted(os.listdir(study))] for study in studies]
    engine = InferenceEngine(cfg, device=device)
    served = engine.encode_paths([v for study in views for v in study]).reshape(n_studies, 4, -1)
    engine.close()
    cos = cosine(vectors, served.mean(axis=1))
    plain_tower = {**{k: v for k, v in tower.items() if k == "micro"}, **PLAIN_TOWER}
    plain_cfg = compose_run("train_exam_reports_clf", argv[:4] + [
        f"networks.image_encoder.config={flow(plain_tower)}"] + argv[5:], snapshot=False)
    plain = _Encoder(plain_cfg, device=device)
    plain_fn = plain._encode_fn()
    with torch.inference_mode():
        plain_views = np.stack([
            np.stack([plain_fn(torch.from_numpy(decode_png(v)[None]).to(device)).float().cpu().numpy()[0]
                      for v in study]) for study in views])
    plain_cos = cosine(vectors, plain_views.mean(axis=1))
    log(f"    study vectors vs the mean of InferenceEngine.encode_paths over the views (same "
        f"config): cosine >= {cos.min():.7f}; vs the plain unfused bf16 tower: cosine >= "
        f"{plain_cos.min():.5f}")
    if not (cos >= STORE_VS_SERVED_COSINE).all():
        raise AssertionError(f"study vs served cosine {cos} < {STORE_VS_SERVED_COSINE}")
    if not (plain_cos >= INT8_VS_BF16_COSINE).all():
        raise AssertionError(f"study vs plain tower cosine {plain_cos} < {INT8_VS_BF16_COSINE}")

    return table, vectors, times


def phase_exam(device, tmp, smi, shapes=FFDM_SHAPES, tower=REPORT_TOWER, text=None,
               n_studies=EXAM_STUDIES, n_train=EXAM_TRAIN_ROWS, n_reduced=EXAM_REDUCED_ROWS,
               batch=64):
    """The exam-report family through its entry points.

    (a) ``encode_studies`` (``extract_features=true``) over ``n_studies``
    studies of four full-field views and one study whose only view is
    corrupt, the tower in the feature-store preset: each bucket of views of
    one shape is one program call launching ``PER_VIEW_LAUNCHES`` (22 on the
    card); every study vector within cosine ``STORE_VS_SERVED_COSINE`` of the
    mean of ``InferenceEngine.encode_paths`` over its views (same config) and
    ``INT8_VS_BF16_COSINE`` of the plain unfused tower's; the corrupt study in
    ``failed.txt`` and out of ``final_reports_dataset.csv``.
    (b) ``train.run`` on ``train_exam_reports_clf`` (BERT-base, 256 tokens,
    ``2xLinear512``, dropout 0.2, batch 64, GTR prompts) over ``n_train``
    studies, under ``CLIPLoss`` and ``MMGCLIPLoss``: finite validation AUCs,
    the key splits and Dropout draws launched per traced step
    (``train_launches``); the fused epoch graphed against eager; card against
    CPU at reduced width with dropout 0.2 (the same masks on both).
    (c) ``PromptClassifier`` against the engine's ``classify``, and the
    ``ProjectionHead`` and ``moe512`` heads training on the card against the
    CPU.  ``text`` overrides the BERT config everywhere (the CPU rehearsal).
    -> times."""
    from mmgclip_tpu_torch.models.clip import PromptClassifier
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgclip_tpu_torch.serving import InferenceEngine
    from mmgclip_tpu_torch.train import run
    from mmgclip_tpu_torch.training.checkpoint import load_checkpoint
    from mmgclip_tpu_torch.utils.tb import read_scalars

    on_card = device.type == "cuda"
    root = os.path.join(tmp, "exam")
    text_extra = [f"networks.text_encoder.config={text}"] if text else []

    table, vectors, times = exam_encode(device, root, smi, shapes, tower, text_extra, n_studies)

    # (b) train_exam_reports_clf --------------------------------------------
    reports_csv, gtr_csv = write_exam_training(root, table.rows, n_train)
    train_extra = [*text_extra, f"dataloader.train.batch_size={batch}",
                   f"dataloader.valid.batch_size={batch}"]
    runs = {}
    for loss in ("clip", "mmgclip"):
        run_dir = os.path.join(root, f"run_{loss}")
        cfg = exam_config(run_dir, reports_csv, gtr_csv, [f"loss={loss}", *train_extra])
        reset_launch_counts()
        t0 = time.perf_counter()
        experiment = run(cfg, device=device)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        check_counts(f"train_exam_reports_clf ({loss}; the key splits and Dropout draws of each "
                     "traced step)", counts, train_launches(experiment))
        times.setdefault("train_launches", counts)
        scalars = read_scalars(cfg.base.tensorboard_export_dir)
        aucs = {tag: scalars[tag] for tag in ("auc/val/malig", "auc/val/shapes", "auc/val/birads")}
        losses = scalars["loss/train"] + scalars["loss/val"]
        if not (np.isfinite(losses).all() and len(scalars["loss/train"]) == 3
                and all(len(v) == 3 and np.isfinite(v).all() for v in aucs.values())):
            raise AssertionError(f"{loss}: losses {losses}, AUCs {aucs}")
        if experiment.test_dataloader is not None or \
                os.path.exists(os.path.join(cfg.base.results_export_dir, "results.json")):
            raise AssertionError("the exam family has no test split: test() must not run")
        steps, ms = experiment.timings["epoch_steps"], experiment.timings["epoch_device_ms"]
        per_step = [m / n for m, n in zip(ms, steps)]
        text_cfg = experiment.model.bert_config
        log(f"    train_exam_reports_clf, {cfg.loss.config.loss_name}: BERT {text_cfg.hidden_size}x"
            f"{text_cfg.num_hidden_layers} ({cfg.tokenizer.config.sequence_length} tokens), "
            f"{cfg.projection.config.projection_name} {cfg.projection.config.output_projection_dimension}, "
            f"dropout {cfg.networks.dropout.config.dropout}, batch {batch}, {len(experiment._train_indices)} "
            f"train studies: train loss {scalars['loss/train']}, val loss {scalars['loss/val']}, val AUC "
            + ", ".join(f"{k.split('/')[-1]} {v[-1]:.4f}" for k, v in aucs.items())
            + (f"; train step {[round(v, 4) for v in per_step]} ms (CUDA events / {steps[0]} steps)"
               if per_step else "") + f"; run() {wall:.2f} s")
        runs[loss] = (cfg, run_dir, experiment)
        times[f"train_{loss}_step_ms"] = per_step
    times["graph"] = graph_vs_eager(device, exam_config(
        os.path.join(root, "graph_check"), reports_csv, gtr_csv, ["loss=mmgclip", *train_extra]),
        "train_exam_reports_clf (MMGCLIPLoss) at full width")
    if times["graph"]["graph_ms"]:
        log(f"    graphed exam step with JAX's dropout masks (the threefry and dropout kernels in "
            f"the graph): {times['graph']['graph_ms'][-1]:.4f} ms (CUDA events, last epoch; {smi})")

    # reduced width, dropout as configured (0.2: card and CPU draw the same
    # masks) except for moe512, whose run at dropout 0.2 reaches a row whose
    # top-1 route ties within rounding (its second validation loss parts by
    # 3.7e-2 while every train loss agrees to 2.4e-7), so it keeps dropout 0:
    # the templated texts of the full-width runs, except for
    # the BatchNorm head, which trains on seeded reports and impressions with
    # no GTR prompts: over rows that repeat a few templates its batch variance
    # E[x^2] - E[x]^2 cancels catastrophically, and the losses of an H100
    # and the CPU part by up to 12%.  Top-1 routing (moe512) flips where a
    # row's router probabilities tie within rounding; the templated texts
    # have no such row
    templated, _ = write_exam_training(os.path.join(root, "reduced"), [], n_reduced, seed=1)
    varied, _ = write_exam_training(os.path.join(root, "reduced_varied"), [], n_reduced, seed=1,
                                    varied=True)
    reduced = [f"networks.text_encoder.config={text or EXAM_TEXT_REDUCED}",
               "dataloader.train.batch_size=8", "dataloader.valid.batch_size=4"]
    heads = {"2xLinear512": (templated, []),
             "ProjectionHead": (varied, ["projection.config.projection_name=ProjectionHead",
                                         "projection.config.output_projection_dimension=512",
                                         "dataset.config.gtr_prompt_generation=false",
                                         "scheduler.config.epochs=2"]),
             "moe512": (templated, ["projection=moe512", "scheduler.config.epochs=2",
                                    "networks.dropout.config.dropout=0.0"])}
    for label, loss, head in (("clip", "clip", "2xLinear512"), ("mmgclip", "mmgclip", "2xLinear512"),
                              ("ProjectionHead", "mmgclip", "ProjectionHead"),
                              ("moe512", "mmgclip", "moe512")):
        reports, extra = heads[head]
        got = {}
        for dev in (device.type, "cpu"):
            cfg = exam_config(os.path.join(root, f"reduced_{label}_{dev}"), reports, gtr_csv,
                              [f"loss={loss}", *reduced, *extra])
            run(cfg, device=dev)
            scalars = read_scalars(cfg.base.tensorboard_export_dir)
            got[dev] = np.asarray(scalars["loss/train"] + scalars["loss/val"])
        rel = np.abs(got[device.type] - got["cpu"]) / np.abs(got["cpu"])
        log(f"    reduced width ({label}, {loss}, dropout {cfg.networks.dropout.config.dropout}): "
            f"{device.type} {got[device.type].tolist()} vs "
            f"CPU {got['cpu'].tolist()}: max rel {rel.max():.3e} (tol {TRAIN_LOSS_REL_TOL:.0e})")
        if not (np.isfinite(rel).all() and rel.max() <= TRAIN_LOSS_REL_TOL):
            raise AssertionError(f"exam training {label}: {device.type} vs CPU losses differ by {rel}")

    # (c) PromptClassifier against the serving engine ----------------------
    cfg, run_dir, _experiment = runs["mmgclip"]
    engine = InferenceEngine.from_experiment(run_dir, device=device)
    ckpt = os.path.join(run_dir, "checkpoints", cfg.checkpoints.checkpoints_file_name)
    classifier = PromptClassifier(engine.model, engine.tokenizer,
                                  params=load_checkpoint(ckpt)["params"])
    out = classifier(vectors, EXAM_PROMPTS)
    ref = engine.classify(vectors, EXAM_PROMPTS)
    engine.close()
    diff = np.abs(out["classes_similarities"].cpu().numpy() - np.asarray(ref["classes_similarities"])).max()
    if out["similarities_argmax_per_image"] != ref["similarities_argmax"] or diff > SERVE_PROB_TOL \
            or out["similarities_argmax"] != ref["similarities_argmax"][0]:
        raise AssertionError(f"PromptClassifier {out['similarities_argmax_per_image']} vs the engine's "
                             f"classify {ref['similarities_argmax']} (max diff {diff})")
    log(f"    PromptClassifier over the trained run ({device.type}): decisions "
        f"{out['similarities_argmax_per_image']} equal to InferenceEngine.classify, probabilities "
        f"within {diff:.2e} (tol {SERVE_PROB_TOL:.0e})")
    return times


# ----------------------------------------------------------------------
# phase 18: the BioGPT text-tower family at full width
GPT_TINY_ABS_TOL = 1e-5       # the tower at GPTConfig.tiny() width, card vs CPU, fp32 (TF32 off)


def phase_biogpt(device, tmp, smi, tree, text=None, shapes=FFDM_SHAPES, tower=REPORT_TOWER,
                 extra=()):
    """``train --config-name train_binary_class_clf networks=clip_convnext_biogpt
    tokenizer=biogpt`` through ``train.run`` on ``tree`` (phase 14's seeded
    features): the ``CausalTextEncoder`` as configured (24 x 1024, 16 heads,
    4096, vocab 42384; ``text`` overrides it, ``extra`` the batch sizes, for
    the CPU rehearsal) from a
    seeded init, the Moses+BPE text bank, 3 epochs, ``test()``; then
    ``evaluate_clip`` of the stored run (results equal ``test()``'s),
    ``generate_report`` for one full-field image through the feature-store
    preset (the tower's kernels per view on the card), one ``serve --once``
    ``classify``, and on the card the tower at ``GPTConfig.tiny()`` width
    against the CPU within ``GPT_TINY_ABS_TOL``.  -> times."""
    import contextlib
    import io

    from mmgclip_tpu_torch import serve
    from mmgclip_tpu_torch.evaluate_clip import main as evaluate_main
    from mmgclip_tpu_torch.models.gpt import CausalTextEncoder, GPTConfig
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgclip_tpu_torch.train import run
    from mmgclip_tpu_torch.utils.tb import read_scalars

    on_card = device.type == "cuda"
    cpu_args = [] if on_card else ["--device", str(device)]
    root = os.path.join(tmp, "biogpt")
    os.makedirs(root)
    run_dir = os.path.join(root, "run")
    overrides = ["networks=clip_convnext_biogpt", "tokenizer=biogpt", *extra]
    if text:
        overrides.append(f"networks.text_encoder.config={text}")
    cfg = train_config(run_dir, tree, overrides)
    reset_launch_counts()
    t0 = time.perf_counter()
    experiment = run(cfg, device=device)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_counts("BioGPT training + test() (the key splits of each traced step; 1xLinear512 has "
                 "no Dropout)", launch_counts(), train_launches(experiment))
    text_tower = experiment.model.text_module
    gpt = experiment.model.bert_config
    if not isinstance(text_tower, CausalTextEncoder):
        raise AssertionError(f"the text tower is {type(text_tower).__name__}, not CausalTextEncoder")
    n_params = sum(p.numel() for p in text_tower.parameters())
    scalars = read_scalars(cfg.base.tensorboard_export_dir)
    train_loss, val_loss = scalars["loss/train"], scalars["loss/val"]
    if not (np.isfinite(train_loss).all() and np.isfinite(val_loss).all() and len(train_loss) == 3):
        raise AssertionError(f"BioGPT epoch losses {train_loss} / {val_loss}")
    if not train_loss[-1] < train_loss[0]:
        raise AssertionError(f"BioGPT train loss did not fall on separable data: {train_loss}")
    with open(os.path.join(cfg.base.results_export_dir, "results.json")) as fh:
        tested = json.load(fh)
    steps, ms = experiment.timings["epoch_steps"], experiment.timings["epoch_device_ms"]
    per_step = [m / n for m, n in zip(ms, steps)]
    times = {"bank_s": experiment.timings["bank_s"], "test_s": experiment.timings["test_s"],
             "step_ms": per_step, "run_s": wall}
    results = tested["BenignMalignantDatasetLabels"]["zeroshot_label_prompt"]
    log(f"    BioGPT {gpt.hidden_size}x{gpt.num_hidden_layers}x{gpt.num_attention_heads} "
        f"({gpt.intermediate_size}, vocab {gpt.vocab_size}, {n_params / 1e6:.1f} M params, "
        f"{n_params * 4 / 2**30:.2f} GiB fp32, seeded), tokenizer {experiment.tokenizer.name} "
        f"(Moses+BPE, {experiment.tokenizer.vocab_size} ids): train loss {train_loss}, val loss "
        f"{val_loss}, test() accuracy {results['accuracy']}, AUC CI mean {results.get('auc_ci_mean')}")
    log(f"    times ({smi}): text bank {times['bank_s']:.3f} s (host clock); train step "
        f"{', '.join(f'{v:.4f}' for v in per_step)} ms per epoch (CUDA events); test() "
        f"{times['test_s']:.3f} s; run() {wall:.1f} s (host clock)")

    reset_launch_counts()
    t0 = time.perf_counter()
    evaluate_main(["--experiment_path", run_dir, "--run_name", "replay", *cpu_args])
    times["evaluate_s"] = time.perf_counter() - t0
    check_counts("evaluate_clip over the BioGPT run", launch_counts(), {})
    with open(os.path.join(run_dir, "replay", "results.json")) as fh:
        if json.load(fh) != tested:
            raise AssertionError("evaluate_clip's results.json differs from test()'s (BioGPT run)")
    log(f"    evaluate_clip of the BioGPT run: results.json equal to test()'s, "
        f"{times['evaluate_s']:.2f} s (host clock)")

    report_dir, _image, _views = report_run(root, run_dir, shapes, tower)
    reset_launch_counts()
    decisions, report, times["report_s"] = run_generate_report(device, report_dir, "--image_id",
                                                               REPORT_IMAGE)
    check_counts("generate_report --image_id (BioGPT text tower, feature-store preset)",
                 launch_counts(), PER_VIEW_LAUNCHES if on_card else {})
    if not report or not decisions:
        raise AssertionError(f"generate_report over the BioGPT run: {decisions}, {report!r}")
    log(f"    generate_report --image_id {REPORT_IMAGE} ({shapes[0][0]}x{shapes[0][1]}, BioGPT prompts): "
        f"{times['report_s']:.2f} s with the model load (host clock); {report[:80]}...")

    feats = np.random.default_rng(18).standard_normal((3, 768)).astype("<f4")
    request = {"op": "classify", "features_b64": base64.b64encode(feats.tobytes()).decode(),
               "features_rows": 3, "class_list": ["Finding suggesting benign.",
                                                  "Finding suggesting malignant."], "id": 18}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve.main(["--experiment_path", run_dir, *cpu_args, "--once", json.dumps(request)])
    times["serve_s"] = time.perf_counter() - t0
    response = json.loads(out.getvalue().strip().splitlines()[-1])
    probs = np.asarray(response.get("result", {}).get("classes_similarities", []))
    if response.get("id") != 18 or probs.shape != (3, 2) or not np.isfinite(probs).all() \
            or not np.allclose(probs.sum(1), 1.0, atol=1e-5):
        raise AssertionError(f"serve --once classify over the BioGPT run: {response}")
    log(f"    serve --once classify over the BioGPT run: argmax {response['result']['similarities_argmax']} "
        f"in {times['serve_s']:.2f} s with the model load (host clock)")

    if on_card:
        tiny = CausalTextEncoder(GPTConfig.tiny(), torch.Generator().manual_seed(18)).eval()
        rng = np.random.default_rng(18)
        ids = torch.from_numpy(rng.integers(4, 256, size=(6, 40)))
        mask = torch.from_numpy((np.arange(40)[None] < np.array([40, 33, 1, 17, 39, 8])[:, None]).astype(np.int64))
        with torch.no_grad():
            want = tiny(ids, mask)
            got = tiny.to(device)(ids.to(device), mask.to(device)).cpu()
        err = (got - want).abs().max().item()
        log(f"    CausalTextEncoder at tiny width, card vs CPU: max_abs {err:.3e} (tol {GPT_TINY_ABS_TOL:.0e})")
        if not err <= GPT_TINY_ABS_TOL:
            raise AssertionError(f"the causal tower on the card differs from the CPU by {err}")
    return times


# ----------------------------------------------------------------------
# phase 19: the ResNet-50 family at full width (the tower trains its layer4)
RESNET_FEATURE_REL_L2 = 1e-5  # the tower's pooled features, card vs CPU, fp32 (TF32 off)
RESNET_CHECK_ROWS = 8         # rows of the card-vs-CPU tower check


def resnet_groups(name):
    """A trainable name -> its group in the layer-by-layer check."""
    parts = name.split(".")
    if parts[0] != "image_encoder":
        return "heads + logit_scale"
    return parts[1].split("_")[0] if parts[1].startswith("layer") else "stem"


def phase_resnet(device, tmp, smi, tree, micro=False, text=None, shapes=FFDM_SHAPES,
                 tower=REPORT_TOWER, extra=()):
    """``train --config-name train_binary_class_clf networks=clip_resnet50_bert``
    through ``train.run`` on ``tree`` (phase 14's seeded features): ResNet-50
    as configured (``(3, 4, 6, 3)``, width 64, 2048-d pooled, ``remat`` on;
    ``micro`` and ``text`` shrink the towers, ``extra`` sets the batch sizes,
    for the CPU rehearsal) beside BERT, 3 epochs, ``test()``; the stem and
    ``layer1`` - ``layer3`` bit-unchanged after training while every
    ``layer4`` and head tensor moved; ``evaluate_clip`` of the stored run
    (results equal ``test()``'s); ``generate_report`` for one full-field image
    through the feature-store preset (the tower's kernels per view on the
    card), then the ResNet; one ``serve --once`` ``classify``; the graphed
    fused epoch against the eager one from one seeded state (cuDNN's
    deterministic algorithms pinned for the comparison); on the card the
    tower's features against the CPU within ``RESNET_FEATURE_REL_L2``.
    -> times and the run's launch counts."""
    import contextlib
    import io

    from mmgclip_tpu_torch import serve
    from mmgclip_tpu_torch.evaluate_clip import main as evaluate_main
    from mmgclip_tpu_torch.models.clip import MMGCLIP
    from mmgclip_tpu_torch.models.resnet import ResNet50Encoder
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgclip_tpu_torch.train import run
    from mmgclip_tpu_torch.utils.tb import read_scalars
    from mmgclip_tpu_torch.weights import clip_params_tree, flatten_tree

    on_card = device.type == "cuda"
    cpu_args = [] if on_card else ["--device", str(device)]
    root = os.path.join(tmp, "resnet")
    os.makedirs(root)
    run_dir = os.path.join(root, "run")
    overrides = ["networks=clip_resnet50_bert", *extra]
    if micro:
        overrides.append("networks.image_encoder.config={micro: true}")
    if text:
        overrides.append(f"networks.text_encoder.config={text}")
    cfg = train_config(run_dir, tree, overrides)
    reset_launch_counts()
    t0 = time.perf_counter()
    experiment = run(cfg, device=device)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check_counts("ResNet training + test() (the key splits of each traced step; 1xLinear512 has "
                 "no Dropout)", counts, train_launches(experiment))
    model = experiment.model
    tower_module = model.image_module
    if not isinstance(tower_module, ResNet50Encoder) or not tower_module.config.remat:
        raise AssertionError(f"the image tower is {type(tower_module).__name__} "
                             f"({getattr(tower_module, 'config', None)}), not ResNet50Encoder with remat")
    rn = tower_module.config
    scalars = read_scalars(cfg.base.tensorboard_export_dir)
    train_loss, val_loss = scalars["loss/train"], scalars["loss/val"]
    if not (np.isfinite(train_loss).all() and np.isfinite(val_loss).all() and len(train_loss) == 3):
        raise AssertionError(f"ResNet epoch losses {train_loss} / {val_loss}")
    if not train_loss[-1] < train_loss[0]:
        raise AssertionError(f"ResNet train loss did not fall on separable data: {train_loss}")
    with open(os.path.join(cfg.base.results_export_dir, "results.json")) as fh:
        tested = json.load(fh)
    results = tested["BenignMalignantDatasetLabels"]["zeroshot_label_prompt"]
    params = model.trainable_parameters()
    trainable = sum(p.numel() for p in params.values() if p.requires_grad)
    log(f"    ResNet-50 {rn.stage_sizes} width {rn.width} -> {tower_module.output_dimension}-d, remat "
        f"{rn.remat}; {model.count_parameters()} trainable-tree params, {trainable} with "
        f"requires_grad (layer4 + heads); batch {cfg.dataloader.train.batch_size}: train loss "
        f"{train_loss}, val loss {val_loss}, test() accuracy {results['accuracy']}, AUC CI mean "
        f"{results.get('auc_ci_mean')}")

    # the layer-by-layer check: the init rebuilt from the seed on the CPU
    init = MMGCLIP(cfg, seed=int(cfg.base.seed), vocab_size=experiment.tokenizer.vocab_size)
    before, after = flatten_tree(clip_params_tree(init)), flatten_tree(clip_params_tree(model))
    moved = {}
    for name in before:
        moved.setdefault(resnet_groups(name), []).append(not np.array_equal(before[name], after[name]))
    log("    tensors moved by training, per group: " + ", ".join(
        f"{group} {sum(flags)}/{len(flags)}" for group, flags in moved.items()))
    for group, flags in moved.items():
        want = group in ("layer4", "heads + logit_scale")
        if (all(flags) if want else not any(flags)):
            continue
        raise AssertionError(f"{group}: {sum(flags)} of {len(flags)} tensors moved "
                             f"({'all' if want else 'none'} should)")
    if any(p.grad is not None for name, p in params.items() if not p.requires_grad):
        raise AssertionError("a frozen ResNet parameter holds a gradient")

    steps, ms = experiment.timings["epoch_steps"], experiment.timings["epoch_device_ms"]
    per_step = [m / n for m, n in zip(ms, steps)]
    times = {"bank_s": experiment.timings["bank_s"], "test_s": experiment.timings["test_s"],
             "step_ms": per_step, "run_s": wall, "train_launches": counts}
    log(f"    times ({smi}): text bank {times['bank_s']:.3f} s (host clock); train step "
        f"{', '.join(f'{v:.4f}' for v in per_step)} ms per epoch (CUDA events over the fused "
        f"epoch; the first holds the eager warm-up and the capture); test() {times['test_s']:.3f} s; "
        f"run() {wall:.1f} s (host clock)")

    # the tower's work in one train step, counted from the shapes: the forward,
    # then the layer4 backward with its remat recompute (the heads add <1%)
    from torch.utils.flop_counter import FlopCounterMode

    rows = experiment._feats_bank[:int(cfg.dataloader.train.batch_size)]
    with FlopCounterMode(display=False) as forward, torch.no_grad():
        tower_module(rows)
    with FlopCounterMode(display=False) as step:
        tower_module(rows).sum().backward()
    tower_module.zero_grad(set_to_none=True)
    times["step_gflop"] = step.get_total_flops() / 1e9
    line = (f"    the tower's work a step of {rows.shape[0]} rows (torch.utils.flop_counter): forward "
            f"{forward.get_total_flops() / 1e9:.1f} GFLOP, forward + layer4 backward with its remat "
            f"recompute {times['step_gflop']:.1f} GFLOP")
    if on_card:
        fp32 = peaks_for(torch.cuda.get_device_name(0))["fp32"]
        line += (f"; bound {times['step_gflop'] * 1e9 / fp32 * 1e3:.3f} ms at the fp32 rate, the "
                 f"graphed step {times['step_gflop'] / per_step[-1]:.2f} TFLOP/s ({smi})")
    log(line)

    reset_launch_counts()
    t0 = time.perf_counter()
    evaluate_main(["--experiment_path", run_dir, "--run_name", "replay", *cpu_args])
    times["evaluate_s"] = time.perf_counter() - t0
    check_counts("evaluate_clip over the ResNet run", launch_counts(), {})
    with open(os.path.join(run_dir, "replay", "results.json")) as fh:
        if json.load(fh) != tested:
            raise AssertionError("evaluate_clip's results.json differs from test()'s (ResNet run)")
    log(f"    evaluate_clip of the ResNet run: results.json equal to test()'s, "
        f"{times['evaluate_s']:.2f} s (host clock, {smi})")

    report_dir, _image, _views = report_run(root, run_dir, shapes, {**tower, "micro": micro})
    reset_launch_counts()
    decisions, report, times["report_s"] = run_generate_report(device, report_dir, "--image_id",
                                                               REPORT_IMAGE)
    check_counts("generate_report --image_id (the ResNet over the feature-store preset's feature)",
                 launch_counts(), PER_VIEW_LAUNCHES if on_card else {})
    if not report or not decisions:
        raise AssertionError(f"generate_report over the ResNet run: {decisions}, {report!r}")
    log(f"    generate_report --image_id {REPORT_IMAGE} ({shapes[0][0]}x{shapes[0][1]}, ConvNeXt "
        f"store preset -> 768-d -> ResNet): {times['report_s']:.2f} s with the model load (host "
        f"clock, {smi}); launches {PER_VIEW_LAUNCHES if on_card else {}}; {report[:80]}...")

    feats = np.random.default_rng(19).standard_normal((3, 768)).astype("<f4")
    request = {"op": "classify", "features_b64": base64.b64encode(feats.tobytes()).decode(),
               "features_rows": 3, "class_list": ["Finding suggesting benign.",
                                                  "Finding suggesting malignant."], "id": 19}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve.main(["--experiment_path", run_dir, *cpu_args, "--once", json.dumps(request)])
    times["serve_s"] = time.perf_counter() - t0
    response = json.loads(out.getvalue().strip().splitlines()[-1])
    probs = np.asarray(response.get("result", {}).get("classes_similarities", []))
    if response.get("id") != 19 or probs.shape != (3, 2) or not np.isfinite(probs).all() \
            or not np.allclose(probs.sum(1), 1.0, atol=1e-5):
        raise AssertionError(f"serve --once classify over the ResNet run: {response}")
    log(f"    serve --once classify over the ResNet run: argmax {response['result']['similarities_argmax']} "
        f"in {times['serve_s']:.2f} s with the model load (host clock, {smi})")

    times["graph"] = graph_vs_eager(device, train_config(os.path.join(root, "graph_check"), tree,
                                                         overrides),
                                    f"ResNet-50 {rn.stage_sizes} x{rn.width} + layer4 backward "
                                    f"(cuDNN deterministic; {smi})")

    if on_card:
        rows = experiment._feats_bank[:RESNET_CHECK_ROWS]
        cpu_tower = ResNet50Encoder(rn)
        cpu_tower.load_state_dict({k: v.cpu() for k, v in tower_module.state_dict().items()})
        with torch.no_grad():
            got = tower_module(rows).cpu()
            want = cpu_tower(rows.cpu())
        rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        log(f"    ResNet-50 pooled features of {RESNET_CHECK_ROWS} trained-run rows, card vs CPU "
            f"(fp32, TF32 off): rel L2 {rel:.3e} (tol {RESNET_FEATURE_REL_L2:.0e}), max_abs "
            f"{(got - want).abs().max().item():.3e}")
        if not rel <= RESNET_FEATURE_REL_L2:
            raise AssertionError(f"the ResNet tower on the card differs from the CPU: rel L2 {rel}")
        times["card_vs_cpu_rel_l2"] = rel
    return times


# ----------------------------------------------------------------------
# phase 20: reproduction from torch artifacts at full width, then the tools
REPRO_PER_CLASS = 16          # 16 + 16 full-field 16-bit PNGs
REPRO_EPOCHS = 2
REPRO_BATCHES = ("dataloader.train.batch_size=8", "dataloader.valid.batch_size=2",
                 "dataloader.test.batch_size=2")  # the 32-image tree's splits are 22 / 5 / 5
CONVERT_VERIFY_TOL = 1e-3     # the JAX converter's --verify bound (tools/convert_convnext.py:79)
PRESETS = ("fused_int8_tanh", "fused_tanh_glue")  # GATE_VARIANTS keys: the store preset's kernels
TSNE_SIZES = (4096, 16384)
TSNE_CHECK_N = 300            # card vs CPU: KL within 1% relative, trustworthiness within 0.01
TSNE_KL_REL = 0.01
TSNE_TRUST_ABS = 0.01


def write_reproduce_tree(root, shapes, n_per_class=REPRO_PER_CLASS):
    """``write_gate_tree``'s annotations and lists over 16-bit PNGs of the two
    full-field shapes (alternating), malignant images brighter (the class is
    in the pixels), written by a thread pool (zlib releases the GIL).
    -> (base, annotated, lists, [(image_id, label)])."""
    from concurrent.futures import ThreadPoolExecutor

    base, annotated, lists = write_gate_tree(root, n_per_class, size=8)
    jobs, labels = [], []
    for benign in (True, False):
        for i in range(n_per_class):
            pid = f"{(2000000 if benign else 2100000) + i:08d}"
            image_id = f"p{pid}02{VIEWS[i % 4]}"
            png = os.path.join(base, pid[:2], pid, "st02", f"{image_id}.png")
            jobs.append((png, shapes[i % len(shapes)], 200 + i + (0 if benign else 100), benign))
            labels.append((image_id, 0 if benign else 1))

    def write(job):
        png, shape, seed, benign = job
        pixels = synthetic_mammogram(*shape, seed=seed).astype(np.float32)
        write_png16(png, (pixels * (0.5 if benign else 1.5)).clip(0, 65535).astype(np.uint16))

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write, jobs))
    return base, annotated, lists, labels


def write_artifacts(root, text_vocab):
    """The reference's artifact files, seeded: a ConvNeXt-Tiny classifier
    (1-channel stem, 2 classes, torchvision's names and ``[C, 1, 1]`` layer
    scales) traced from plain ``nn`` layers to TorchScript, and an HF
    BERT-base snapshot (the offline tokenizer's vocabulary) as
    ``pytorch_model.bin`` and as a hand-written ``model.safetensors``.
    -> (TorchScript path, .bin dir, .safetensors dir)."""
    from mmgclip_tpu_torch.tools.fixtures import (
        TorchvisionConvNeXt,
        bert_state_dict,
        write_hf_snapshot,
        write_torchscript,
    )

    scripted = os.path.join(root, "classifier_convnext_tiny_16bits_images.pt")
    write_torchscript(TorchvisionConvNeXt(in_channels=1, num_classes=2, seed=0), scripted,
                      torch.zeros(1, 1, 64, 64))
    hf_config = {"vocab_size": text_vocab, "hidden_size": 768, "num_hidden_layers": 12,
                 "num_attention_heads": 12, "intermediate_size": 3072,
                 "max_position_embeddings": 512, "type_vocab_size": 2}
    state = bert_state_dict(hf_config, seed=0)
    bin_dir = write_hf_snapshot(os.path.join(root, "bert_bin"), hf_config, state, "bin")
    st_dir = write_hf_snapshot(os.path.join(root, "bert_safetensors"), hf_config, state, "safetensors")
    return scripted, bin_dir, st_dir


def trustworthiness(x, embedding, k=5):
    """scikit-learn's ``trustworthiness`` (Euclidean), in numpy."""
    n = len(x)
    x = np.asarray(x, np.float64)
    e = np.asarray(embedding, np.float64)
    dist_x = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(dist_x, np.inf)
    dist_e = ((e[:, None, :] - e[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(dist_e, np.inf)
    rank = np.empty((n, n), np.int64)
    rank[np.arange(n)[:, None], np.argsort(dist_x, axis=1, kind="stable")] = np.arange(1, n + 1)
    near_e = np.argsort(dist_e, axis=1, kind="stable")[:, :k]
    ranks = rank[np.arange(n)[:, None], near_e] - k
    return 1.0 - ranks[ranks > 0].sum() * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))


def tsne_clusters(n, seed, dim=512, k=10):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, dim)) * 4
    return (centers[rng.integers(0, k, n)] + rng.normal(size=(n, dim))).astype(np.float32)


def store_aucs(run, features, device):
    """The trained run's zero-shot AUC per prompt over one store."""
    from mmgclip_tpu_torch.config import recompose

    cfg = recompose(run)
    cfg.base.features_export_dir = features
    return evaluator_aucs(cfg, device)


def phase_reproduce(device, tmp, smi, shapes=FFDM_SHAPES, tsne_sizes=TSNE_SIZES,
                    tsne_check_n=TSNE_CHECK_N):
    """Phase 20: the port started from the reference's torch artifacts.

    Synthesizes the artifacts (``write_artifacts``), converts them on the
    card (``convert_convnext --verify`` at 64 x 64, then the converted tower
    against the TorchScript module on one full-field bucket; ``convert_bert``
    from ``.bin`` and from ``.safetensors``, byte-equal), runs ``reproduce``
    over 16 + 16 full-field PNGs (convert, encode, train 2 epochs, ``test()``,
    report), encodes the store preset's two variants over the converted
    weights (launches of the int8 block, the block, the stem and the
    downsample; zero-shot AUC of the trained run within phase 15's 0.005 of
    the plain store's), ``generate_report`` through the int8 preset (the
    plain tower's decisions), ``tsne_eval`` over the run, the t-SNE timed
    alone at ``tsne_sizes`` and held card vs CPU at ``tsne_check_n``, then
    ``data_efficiency`` (0.5, 1.0; 1 epoch), ``eda``, ``parity_harness`` and
    ``demo_run``.  -> {"seconds": {...}, "launches": {kernel: n}} (every
    launch of the phase, step by step: the counts set to 0 before each step
    and read after it)."""
    from mmgclip_tpu_torch.config import Config, recompose, save_snapshot
    from mmgclip_tpu_torch.data.ingest import create_dataset_df
    from mmgclip_tpu_torch.data.tokenizer import Tokenizer
    from mmgclip_tpu_torch.ingest.encode import ImageFeatureExtractor
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgclip_tpu_torch.tools import (
        convert_bert,
        convert_convnext,
        data_efficiency,
        demo_run,
        eda,
        parity_harness,
        reproduce,
        tsne_eval,
    )
    from mmgclip_tpu_torch.utils.tsne import tsne

    on_card = device.type == "cuda"
    root = os.path.join(tmp, "phase20")
    os.makedirs(root)
    seconds, launches = {}, {}

    def tally():
        """The launches since the last reset, added to the phase's; reset."""
        counts = launch_counts()
        for kernel, count in counts.items():
            launches[kernel] = launches.get(kernel, 0) + count
        reset_launch_counts()
        return {k: v for k, v in counts.items() if v}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    vocab = Tokenizer.from_pretrained("emilyalsentzer/Bio_ClinicalBERT", sequence_length=256).vocab_size
    scripted_path, bin_dir, st_dir = write_artifacts(root, vocab)
    tree = write_reproduce_tree(os.path.join(root, "tree"), shapes)
    seconds["artifacts_and_tree"] = time.perf_counter() - t0
    log(f"    artifacts (TorchScript ConvNeXt-Tiny, BERT-base 768 x 12 vocab {vocab} as .bin and "
        f".safetensors) and {2 * REPRO_PER_CLASS} PNGs of {shapes} in "
        f"{seconds['artifacts_and_tree']:.2f} s (host)")

    # (2) convert on the card
    device_arg = [] if on_card else ["--device", str(device)]
    npz = os.path.join(root, "converted", "convnext_tiny_clf.npz")
    t0 = time.perf_counter()
    result = convert_convnext.main(["--input", scripted_path, "--output", npz, "--verify", *device_arg])
    seconds["convert_convnext"] = time.perf_counter() - t0
    err64 = result["max_abs_err"]
    scripted = torch.jit.load(scripted_path, map_location=device)
    tower = convert_convnext.load_tower(scripted.state_dict(), device)
    # the full-field bucket at a multiple of 32 (2304 x 1920, the bucket-rounding
    # canvas): there the JAX tower's bottom/right zero padding and torchvision's
    # flooring strided convs see the same pixels; at 2294 x 1914 they do not
    errors = {}
    for shape in (tuple(-(-s // 32) * 32 for s in shapes[0]), shapes[0]):
        image = synthetic_mammogram(*shape, seed=7).astype(np.float32)[None, :, :, None] / 65535.0
        with torch.no_grad():
            x = torch.from_numpy(image).to(device)
            ours = tower(x)
            theirs = scripted.avgpool(scripted.features(x.permute(0, 3, 1, 2).contiguous())).flatten(1)
        errors[shape] = ((ours - theirs).abs().max().item(), theirs.abs().max().item())
    del tower
    (bucket, (err_ff, scale)), (raw, (err_raw, _)) = errors.items()
    log(f"    convert_convnext --verify (64 x 64, the TorchScript module on the CPU): max_abs "
        f"{err64:.3e}; the converted tower vs the TorchScript module on one {bucket} bucket "
        f"(both on {device}, fp32, TF32 off): max_abs {err_ff:.3e} of |features| <= {scale:.3f} "
        f"(tol {CONVERT_VERIFY_TOL:.0e}); {seconds['convert_convnext']:.2f} s.  At {raw} (not a "
        f"multiple of 32; not held): max_abs {err_raw:.3e}, the JAX tower's bottom/right padding "
        f"against torchvision's flooring convs")
    if not (err64 <= CONVERT_VERIFY_TOL and err_ff <= CONVERT_VERIFY_TOL):
        raise AssertionError(f"converted ConvNeXt: 64x64 err {err64}, {bucket} err {err_ff}")
    bert_files = []
    for kind, snapshot in (("bin", bin_dir), ("safetensors", st_dir)):
        out = os.path.join(root, "converted", f"bert_{kind}.msgpack")
        t0 = time.perf_counter()
        convert_bert.main(["--input", snapshot, "--output", out, *device_arg])
        seconds[f"convert_bert_{kind}"] = time.perf_counter() - t0
        with open(out, "rb") as fh:
            bert_files.append(fh.read())
    log(f"    convert_bert from pytorch_model.bin {seconds['convert_bert_bin']:.2f} s, from "
        f"model.safetensors {seconds['convert_bert_safetensors']:.2f} s: "
        f"{len(bert_files[0])} bytes, {'byte-equal' if bert_files[0] == bert_files[1] else 'DIFFER'}")
    if bert_files[0] != bert_files[1]:
        raise AssertionError("convert_bert wrote different bytes from .bin and .safetensors")

    # (3) reproduce
    base, annotated, lists, labels = tree
    run = os.path.join(root, "reproduce")
    args = reproduce.parse_args([
        "--convnext", scripted_path, "--bert", bin_dir, "--base-data", base,
        "--annotated-data", annotated, "--lists-data", lists, "--out", run,
        "--epochs", str(REPRO_EPOCHS), "--device", str(device)])
    reset_launch_counts()
    t0 = time.perf_counter()
    run, steps = reproduce.reproduce(args, device, REPRO_BATCHES)
    sync()
    seconds["reproduce"] = time.perf_counter() - t0
    log(f"    reproduce: {json.dumps({k: round(v, 3) for k, v in steps.items()})} s per step, "
        f"{seconds['reproduce']:.2f} s in all (host clock, synchronized; {smi}); launches {tally()}")
    with open(os.path.join(run, "results", "results.json")) as fh:
        results = json.load(fh)
    with open(os.path.join(run, "generated_report.txt")) as fh:
        report_text = fh.read()
    stored = sorted(os.path.join(dp, f) for dp, _dn, fn in os.walk(os.path.join(run, "encoded"))
                    for f in fn if f.endswith(".npy"))
    if len(stored) != 2 * REPRO_PER_CLASS or "decisions:" not in report_text \
            or "BenignMalignantDatasetLabels" not in results:
        raise AssertionError(f"reproduce: {len(stored)} features, results {sorted(results)}, "
                             f"report {report_text[:200]!r}")
    log(f"    reproduce report: {report_text.splitlines()[1][:150]}")

    # (4) the store preset's kernels over the converted weights
    cfg = recompose(run)
    plain_aucs = store_aucs(run, os.path.join(run, "encoded"), device)
    plain = {os.path.relpath(p, os.path.join(run, "encoded")): np.load(p).reshape(-1) for p in stored}
    for tag in PRESETS:
        knobs, kernels = GATE_VARIANTS[tag]
        pcfg = recompose(run)
        pcfg.networks.image_encoder.config = Config(dict(knobs))
        pcfg.base.features_export_dir = os.path.join(root, f"store_{tag}")
        rows = create_dataset_df(pcfg)
        ex = ImageFeatureExtractor(config=pcfg, dataset=rows, device=device)
        tally()
        t0 = time.perf_counter()
        n = ex.extract()
        sync()
        seconds[f"encode_{tag}"] = time.perf_counter() - t0
        counts = tally()
        feats = {rel: np.load(os.path.join(pcfg.base.features_export_dir, rel)).reshape(-1)
                 for rel in plain}
        cos = cosine([feats[r] for r in plain], [plain[r] for r in plain])
        aucs = store_aucs(run, pcfg.base.features_export_dir, device)
        delta = max(abs(aucs[k] - v) for k, v in plain_aucs.items())
        log(f"    encode_images {tag} ({knobs}) over the converted weights: {n} images in "
            f"{seconds[f'encode_{tag}']:.2f} s, launches {counts}; "
            f"cosine vs the plain store min {cos.min():.6f}; zero-shot AUC {aucs} vs plain "
            f"{plain_aucs}: max |delta| {delta:.6f} (tol {GATE_AUC_DELTA})")
        if n != 2 * REPRO_PER_CLASS or set(aucs) != set(plain_aucs) or not delta <= GATE_AUC_DELTA:
            raise AssertionError(f"preset {tag}: {n} stored, AUC delta {delta}")
        if on_card and not all(counts.get(k, 0) > 0 for k in kernels):
            raise AssertionError(f"preset {tag} launched {counts}, expected {kernels}")
    report_dir = os.path.join(root, "report_int8")
    rcfg = recompose(run)
    rcfg.networks.image_encoder.config = Config(dict(GATE_VARIANTS["fused_int8_tanh"][0]))
    rcfg.checkpoints.checkpoints_export_dir = os.path.join(report_dir, "checkpoints")
    save_snapshot(rcfg, report_dir)
    shutil.copytree(os.path.join(run, "checkpoints"), rcfg.checkpoints.checkpoints_export_dir)
    image_id = labels[0][0]
    want, _text, _s = run_generate_report(device, run, "--image_id", image_id)
    tally()
    got, text, seconds["generate_report_int8"] = run_generate_report(device, report_dir, "--image_id",
                                                                     image_id)
    log(f"    generate_report {image_id} through the int8 preset: {seconds['generate_report_int8']:.2f} s "
        f"(model load included), launches {tally()}; decisions "
        f"{'equal to' if got == want else 'DIFFER from'} the plain tower's {want}")
    if got != want:
        raise AssertionError(f"preset report decisions {got} != plain {want}")
    if on_card:
        for kernel in ("fused_convnext_block_int8", "fused_convnext_block", "fused_stem",
                       "fused_ln_downsample"):
            if not launches.get(kernel, 0) > 0:
                raise AssertionError(f"phase 20 never launched {kernel}: {launches}")

    # (5) t-SNE
    t0 = time.perf_counter()
    out = tsne_eval.main(["--experiment_path", run, *device_arg])
    seconds["tsne_eval"] = time.perf_counter() - t0
    if out["coords"].shape != (2 * REPRO_PER_CLASS, 2) or not np.isfinite(out["coords"]).all():
        raise AssertionError(f"tsne_eval coords {out['coords'].shape}")
    log(f"    tsne_eval over the run ({len(out['coords'])} points): {seconds['tsne_eval']:.2f} s, "
        f"KL {out['kl_divergence']:.4f}")
    for n in tsne_sizes:
        x = tsne_clusters(n, seed=n)
        sync()
        t0 = time.perf_counter()
        res = tsne(x, perplexity=30.0, device=device)
        sync()
        seconds[f"tsne_{n}"] = time.perf_counter() - t0
        if not np.isfinite(res.embedding).all():
            raise AssertionError(f"t-SNE at N = {n} is not finite")
        log(f"    t-SNE alone, N = {n} x 512 (10 clusters): {seconds[f'tsne_{n}']:.2f} s on {device} "
            f"(host clock, synchronized; {smi}), {res.n_iter + 1} iterations, KL {res.kl_divergence:.4f}")
    x = tsne_clusters(tsne_check_n, seed=3)
    card = tsne(x, perplexity=30.0, device=device)
    cpu = tsne(x, perplexity=30.0, device="cpu")
    kl_rel = abs(card.kl_divergence - cpu.kl_divergence) / cpu.kl_divergence
    trust = (trustworthiness(x, card.embedding), trustworthiness(x, cpu.embedding))
    log(f"    t-SNE N = {tsne_check_n}, {device} vs CPU: KL {card.kl_divergence:.6f} / "
        f"{cpu.kl_divergence:.6f} (rel {kl_rel:.2e}, tol {TSNE_KL_REL}); trustworthiness(5) "
        f"{trust[0]:.4f} / {trust[1]:.4f} (tol {TSNE_TRUST_ABS})")
    if not (kl_rel <= TSNE_KL_REL and abs(trust[0] - trust[1]) <= TSNE_TRUST_ABS):
        raise AssertionError(f"t-SNE card vs CPU: KL rel {kl_rel}, trust {trust}")

    # (6) the other tools
    data = [f"dataset.config.base_dataset_path={base}",
            f"dataset.config.annotated_dataset_path={annotated}",
            f"dataset.config.lists_dataset_path={lists}"]
    t0 = time.perf_counter()
    rows = data_efficiency.main([
        "--fractions", "0.5", "1.0", "--out", os.path.join(root, "sweep"), *device_arg, *data,
        f"base.features_export_dir={cfg.base.features_export_dir}",
        f"networks.image_encoder.convnext_tiny_clf_path={npz}",
        f"networks.text_encoder.weights_path={cfg.networks.text_encoder.weights_path}",
        "scheduler.config.epochs=1", *REPRO_BATCHES])
    seconds["data_efficiency"] = time.perf_counter() - t0
    # a row per fraction with an AUC; this tree's 5-image test split may hold
    # one class only, and then test() has no AUC to report (as in JAX)
    for tag in ("p50", "p100"):
        if not os.path.isfile(os.path.join(root, "sweep", tag, "results", "results.json")):
            raise AssertionError(f"data_efficiency wrote no results for {tag}")
    if {r["fraction"] for r in rows} - {0.5, 1.0}:
        raise AssertionError(f"data_efficiency rows {rows}")
    report = eda.main(["--out", os.path.join(root, "eda"), *data])
    want_lines = [f"images: {2 * REPRO_PER_CLASS}", "image_label counts (0=benign, 1=malignant, 2=uncertain):",
                  f"  0: {REPRO_PER_CLASS}"]
    if not all(line in report.splitlines() for line in want_lines):
        raise AssertionError(f"eda report: {report}")
    sweep_launches = tally()
    parity_harness.main(["--results", os.path.join(run, "results", "results.json")])
    t0 = time.perf_counter()
    demo = demo_run.main(["--out", os.path.join(root, "demo"), *device_arg])
    sync()
    seconds["demo_run"] = time.perf_counter() - t0
    demo_launches = tally()
    manifests = []
    for path in (os.path.join(demo, "MANIFEST.txt"),
                 os.path.join(REPO, "outputs", "demo", "run", "MANIFEST.txt")):
        with open(path) as fh:
            manifests.append(fh.read().split())
    # the PNGs only where matplotlib imports (not on every card's machine)
    if [f for f in manifests[0] if not f.endswith(".png")] != \
            [f for f in manifests[1] if not f.endswith(".png")]:
        raise AssertionError(f"demo_run wrote {manifests[0]}, the committed demo {manifests[1]}")
    log(f"    data_efficiency (0.5, 1.0; 1 epoch, BERT-base) {seconds['data_efficiency']:.2f} s: "
        f"{[(r['fraction'], round(r['mean_auc'], 4)) for r in rows]}, launches {sweep_launches}; "
        f"eda, parity_harness (exit 0); demo_run {seconds['demo_run']:.2f} s, launches "
        f"{demo_launches}: the committed artifact set ({sum(f.endswith('.png') for f in manifests[0])} "
        f"of {sum(f.endswith('.png') for f in manifests[1])} PNGs)")
    log(f"    phase 20 launches, every step: { {k: v for k, v in launches.items() if v} }")
    return {"seconds": seconds, "launches": launches}


def timing_ring(device, peaks, smi, launches, max_err):
    """The ring per (P, shape, dtype) beside its bound, its plain version and
    the library pair (torch.cat, then a copy into each output), all as device
    time per call of back-to-back calls (``device_ms``); the kernel through
    ``_launch_ring``, the call ``ring_all_gather_diff`` makes in the global
    losses.  Then the global loss forward + backward with the ring and with
    the plain gather (CUDA events around each call, host time included)."""
    from mmgclip_tpu_torch.parallel import (global_clip_loss, global_mmgclip_loss,
                                            launch_ring_all_gather, ring_all_gather_plain)
    from mmgclip_tpu_torch.parallel.collectives import _launch_ring

    rng = np.random.default_rng(14)
    entry = None
    for ranks in RING_RANKS:
        for shape, dtype in RING_CASES:
            shards = ring_shards(ranks, shape, dtype, device, rng)
            outs = [torch.empty((ranks * shape[0], *shape[1:]), dtype=dtype, device=device)
                    for _ in range(ranks)]

            def library():
                full = torch.cat(shards)
                for out in outs:
                    out.copy_(full)

            ms = device_ms(lambda: _launch_ring(shards))
            plain = device_ms(lambda: ring_all_gather_plain(shards))
            lib = device_ms(library)
            host = time_ms(lambda: launch_ring_all_gather(shards))
            # each shard read once, each of the P outputs of P chunks written once
            moved = (ranks * ranks + ranks) * shards[0].numel() * shards[0].element_size()
            bms = moved / peaks["bytes"] * 1e3
            log(f"    ring_all_gather P={ranks} {shape} {str(dtype)[6:]}: kernel {ms:.5f} ms, plain "
                f"{plain:.5f} ms, library (cat + {ranks} copies) {lib:.5f} ms, bound {bms:.5f} ms "
                f"(bytes); one checked call {host:.4f} ms with its host time ({smi})")
            if (ranks, shape, dtype) == (8, (32, 512), torch.float32):
                entry = {"name": "ring_all_gather", "route": "cuda",
                         "source": "mmgclip_tpu_torch/csrc/ring_all_gather.cu",
                         "replaces": "mmgclip_tpu/parallel/collectives.py:189", "launches": launches,
                         "max_abs_err": max_err, "ms": ms, "plain_ms": plain, "bound_ms": bms,
                         "bound_by": "bytes", "library_ms": lib,
                         "work": "8 ranks x [32, 512] fp32, the global loss's gather"}
    scale = torch.tensor(1 / 0.07, device=device)
    for name, fn, kinds in (("global_clip_loss", global_clip_loss, 2),
                            ("global_mmgclip_loss", global_mmgclip_loss, 3)):
        shards = [unit_rows(8, 32, 512, device, rng) for _ in range(kinds)]
        for ring in (True, False):
            def step():
                loss, _ = fn(*shards, scale, use_ring_gather=ring)
                loss.backward()

            log(f"    {name} forward + backward, 8 ranks x 32 x 512 fp32, "
                f"{'ring' if ring else 'plain'} gather: {time_ms(step):.4f} ms ({smi})")
    return entry


# ----------------------------------------------------------------------
# 21. the parallel layer across processes (ranks sharing the card)
# ----------------------------------------------------------------------

PEER_RANKS = (2, 4)
PEER_REPEATS = 50             # back-to-back calls, no check between
PEER_TIMEOUT_TEST_S = 2.0     # the watchdog's deadline in the withheld-signal check
DP_LOSS_REL_TOL = 1e-5        # 2-process data-parallel epochs vs phase 14's single-process run
BANK_REL_TOL = 1e-5           # TP 2 / PP 2 banks vs the plain bank: max_abs over max |plain|
ATTN_ABS_TOL = 1e-5           # ring attention vs attention over the whole sequence, fp32
MOE_REL_TOL = 1e-5            # the EP head vs the replicated head, outputs and gradients:
                              # max_abs over max |replicated|; cuBLAS sums each expert block
                              # in another order than the whole (exact on the CPU)
PEER_TIMEOUT = 600            # seconds for a group of child processes


def _peer_main(what, rank, world, store, out_dir, arg_json):
    """One child of phase 21 (a rank of a gloo process group; the ranks
    share the card): ``what`` is "ring" or "train"; writes its results as
    JSON and prints ``peer_ok=1``."""
    from mmgclip_tpu_torch.parallel.multihost import initialize_distributed, shutdown

    args = json.loads(arg_json)
    cpu = args.get("device") == "cpu"  # a CPU rehearsal of the training children
    initialize_distributed(store, world, rank, backend="gloo", device="cpu" if cpu else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
    results = (_peer_ring_checks(device, rank, world) if what == "ring"
               else _peer_train_checks(device, rank, world, args))
    with open(os.path.join(out_dir, f"{what}_{rank}.json"), "w") as fh:
        json.dump(results, fh)
    shutdown()
    print("peer_ok=1", flush=True)


def run_peers(what, world, tmp, args=None):
    """Phase 21's children: ``world`` processes of ``_peer_main``; a failing
    or hanging child fails the phase (and kills the rest)."""
    from mmgclip_tpu_torch.parallel.multihost import file_store, spawn

    out_dir = tempfile.mkdtemp(prefix=f"peers_{what}_", dir=tmp)
    store = file_store(out_dir)
    arg_json = json.dumps(args or {})

    def code(rank):
        return (f"import chip_smoke\nchip_smoke._peer_main({what!r}, {rank}, {world}, {store!r}, "
                f"{out_dir!r}, {arg_json!r})\n")

    spawn(code, world, PEER_TIMEOUT, "peer_ok=")
    out = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"{what}_{rank}.json")) as fh:
            out.append(json.load(fh))
    return out


def _seeded_shards(ranks, shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)
            for _ in range(ranks)]


def _peer_ring_checks(device, rank, world):
    """The cross-process ring at P = 2 and 4 (bit-equal to ``torch.cat``, back
    to back, a withheld signal), its times beside the in-process mode and
    gloo, the global losses and ring attention."""
    import torch.distributed as dist

    from mmgclip_tpu_torch.losses import clip_loss, mmgclip_loss
    from mmgclip_tpu_torch.models.clip import l2_normalize
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgclip_tpu_torch.ops.flash_attention import attention_reference
    from mmgclip_tpu_torch.ops.ring_attention import ring_attention
    from mmgclip_tpu_torch.parallel import collectives as C
    from mmgclip_tpu_torch.parallel import global_clip_loss, global_mmgclip_loss
    from mmgclip_tpu_torch.parallel.mesh import DATA_AXIS, create_mesh

    meshes = {4: create_mesh(data=4), 2: create_mesh(data=2, ranks=[0, 1])}
    out = {"stream_ops": C.stream_memory_ops(), "checks": [], "times": [], "worst": 0.0}
    for ranks in PEER_RANKS:
        mesh = meshes[ranks]
        dist.barrier()
        if not mesh.member:
            continue
        me, group = mesh.index(DATA_AXIS), mesh.group(DATA_AXIS)
        for shape in ((32, 512), (32 // ranks, 512)):
            for dtype in (torch.float32, torch.bfloat16):
                shards = _seeded_shards(ranks, shape, dtype, device, 21)
                ref = torch.cat(shards)
                reset_launch_counts()
                got = C.ring_all_gather(shards[me], DATA_AXIS, mesh=mesh)
                launched = launch_counts()["ring_all_gather"]
                if launched != 1 or not bit_equal([got], [ref]):
                    raise AssertionError(f"peer ring P={ranks} {shape} {dtype}: "
                                         f"launches {launched}, bit-equal {bit_equal([got], [ref])}")
                out["checks"].append(f"P={ranks} {shape} {str(dtype)[6:]}")
        # back to back, no check between
        batches = [_seeded_shards(ranks, (32 // ranks, 512), torch.float32, device, 100 + i)
                   for i in range(PEER_REPEATS)]
        outs = [C._peer_ring(b[me], mesh, DATA_AXIS) for b in batches]
        C.check_ring(device)
        if not all(bit_equal([o], [torch.cat(b)]) for o, b in zip(outs, batches)):
            raise AssertionError(f"peer ring P={ranks}: a back-to-back call differs from torch.cat")
        # times: CUDA events around back-to-back calls on every rank at once
        for shape in ((32, 512), (32 // ranks, 512)):
            shards = _seeded_shards(ranks, shape, torch.float32, device, 7)
            x = shards[me]
            chunk = x.numel() * x.element_size()
            row = {"P": ranks, "shape": list(shape), "bound_ms": (ranks * ranks + ranks) * chunk / 3.35e12 * 1e3}
            C._peer_ring(x, mesh, DATA_AXIS)
            C.check_ring(device)
            dist.barrier(group=group)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(PEER_REPEATS):
                C._peer_ring(x, mesh, DATA_AXIS)
            end.record()
            C.check_ring(device)
            row["ms"] = start.elapsed_time(end) / PEER_REPEATS
            # the library call: gloo's all_gather_into_tensor on the card's tensors
            full = torch.empty((ranks * shape[0], shape[1]), device=device)
            try:
                lib = lambda: dist.all_gather_into_tensor(full, x, group=group)  # noqa: E731
                lib()
                row["library"] = "gloo all_gather_into_tensor (CUDA tensors)"
            except RuntimeError as exc:
                lib = lambda: C._all_gather_raw(x, mesh, DATA_AXIS)  # noqa: E731
                row["library"] = f"gloo all_gather through the host ({str(exc)[:60]})"
            dist.barrier(group=group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                lib()
            torch.cuda.synchronize()
            row["library_ms"] = (time.perf_counter() - t0) / 20 * 1e3
            dist.barrier(group=group)
            if me == 0:  # the in-process mode and the plain version, on this rank alone
                row["in_process_ms"] = device_ms(lambda: C._launch_ring(shards))
                row["plain_ms"] = device_ms(lambda: torch.cat(shards))
            dist.barrier(group=group)
            out["times"].append(row)
        # a withheld hand-off raises (bounded) on the rank that waits for it, and the next call is right
        if ranks == 2:
            shards = _seeded_shards(2, (16, 512), torch.float32, device, 5)
            saved, C.PEER_TIMEOUT_S = C.PEER_TIMEOUT_S, PEER_TIMEOUT_TEST_S
            try:
                t0 = time.perf_counter()
                try:
                    C._peer_ring(shards[me], mesh, DATA_AXIS, withhold=me == 1)
                    C.check_ring(device)
                    raised = None
                except RuntimeError as exc:
                    raised = str(exc)
                waited = time.perf_counter() - t0
            finally:
                C.PEER_TIMEOUT_S = saved
            if (me == 0) != (raised is not None):
                raise AssertionError(f"withheld hand-off on rank {me}: raised {raised!r}")
            out["timeout"] = {"rank": me, "raised": raised, "seconds": waited}
            dist.barrier(group=group)
            again = C.ring_all_gather(shards[me], DATA_AXIS, mesh=mesh)
            if not bit_equal([again], [torch.cat(shards)]):
                raise AssertionError("peer ring: the call after a withheld hand-off is wrong")
        # the global losses through the ring against the single-process losses
        scale = torch.tensor(1 / 0.07, device=device)
        for name, fn, kinds, expected in (("global_clip_loss", global_clip_loss, 2, 2),
                                          ("global_mmgclip_loss", global_mmgclip_loss, 3, 4)):
            full = [l2_normalize(t) for t in _seeded_shards(kinds, (32, 512), torch.float32, device, 13)]
            local = [t[me * (32 // ranks):(me + 1) * (32 // ranks)].clone().requires_grad_() for t in full]
            reset_launch_counts()
            loss, _labels = fn(*local, scale, use_ring_gather=True, mesh=mesh)
            launched = launch_counts()["ring_all_gather"]
            loss.backward()
            ref_in = [t.clone().requires_grad_() for t in full]
            if kinds == 2:
                ref = clip_loss(scale * ref_in[0] @ ref_in[1].T, scale * ref_in[1] @ ref_in[0].T)[0]
            else:
                ref = mmgclip_loss(*ref_in, scale)[0]
            ref.backward()
            rel = abs(loss.item() - ref.item()) / abs(ref.item())
            rows = slice(me * (32 // ranks), (me + 1) * (32 // ranks))
            grad = max((a.grad - b.grad[rows]).abs().max().item() for a, b in zip(local, ref_in))
            if launched != expected or not (rel <= LOSS_REL_TOL and grad <= GRAD_ABS_TOL):
                raise AssertionError(f"{name} over {ranks} processes: launches {launched}, rel {rel}, "
                                     f"gradient {grad}")
            out["checks"].append(f"{name} P={ranks}: rel {rel:.3e}, grad {grad:.3e}, launches {launched}")
            out["worst"] = max(out["worst"], rel)
        # ring attention at BERT-base width over the sequence split across the ranks
        rng = np.random.default_rng(17)
        b, h, s, d = 2, 12, 512, 64
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32)).to(device)
                   for _ in range(3))
        mask = torch.ones((b, s), dtype=torch.int32, device=device)
        mask[1, 300:] = 0
        block = slice(me * (s // ranks), (me + 1) * (s // ranks))
        got = ring_attention(q[:, :, block], k[:, :, block], v[:, :, block], DATA_AXIS,
                             kv_valid=mask[:, block], mesh=mesh)
        err = (got - attention_reference(q, k, v, mask)[:, :, block]).abs().max().item()
        if not err <= ATTN_ABS_TOL:
            raise AssertionError(f"ring attention over {ranks} processes: max_abs {err}")
        out["checks"].append(f"ring attention b=2 h=12 s=512 d=64 over {ranks}: max_abs {err:.3e}")
    C.release_workspaces()
    return out


def _peer_train_checks(device, rank, world, args):
    """``train_binary_class_clf`` at full width over two processes (data
    parallel), then ZeRO-1, the TP 2 and PP 2 banks and the EP MoE head."""
    import torch.distributed as dist

    from mmgclip_tpu_torch.models.projections import MoEProjectionHead
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgclip_tpu_torch.parallel.expert import shard_moe_params
    from mmgclip_tpu_torch.parallel.mesh import MODEL_AXIS, create_mesh
    from mmgclip_tpu_torch.train import build_experiment, run

    tree, root, base = args["tree"], args["root"], args.get("extra", [])
    out = {}

    def config(name, extra=()):
        return train_config(os.path.join(root, f"{name}_{rank}"), tree, [
            f"checkpoints.checkpoints_export_dir={root}/{name}_ckpt", *base, *extra])

    reset_launch_counts()
    t0 = time.perf_counter()
    exp = run(config("dp"), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["dp"] = {"wall_s": time.perf_counter() - t0, "launches": launch_counts(),
                 "steps": exp.timings["epoch_steps"], "epoch_ms": exp.timings["epoch_device_ms"],
                 "bank_s": exp.timings["bank_s"], "ckpt": exp.ckp_path,
                 "run_dir": config("dp").base.tensorboard_export_dir}
    plain_bank = exp._text_bank

    t0 = time.perf_counter()
    zero = run(config("zero", ["optimizer.config.zero_sharding=true"]), device=device)
    from mmgclip_tpu_torch.parallel.zero import opt_state_bytes_per_device

    out["zero"] = {"wall_s": time.perf_counter() - t0, "sharded": zero.optimizer.sharded_names(),
                   "moment_bytes": opt_state_bytes_per_device(zero.optimizer),
                   "replicated_bytes": opt_state_bytes_per_device(exp.optimizer),
                   "run_dir": config("zero").base.tensorboard_export_dir}
    for layout in ("tp2", "pp2"):
        t0 = time.perf_counter()
        other = build_experiment(config(layout, [f"parallel={layout}"]), device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = ((other._text_bank - plain_bank).abs().max() / plain_bank.abs().max()).item()
        out[layout] = {"bank_rel": err, "bank_s": time.perf_counter() - t0}
        if not err <= BANK_REL_TOL:
            raise AssertionError(f"{layout} bank vs the plain bank: {err}")
    # the EP MoE head: E = 4 over a model axis of 2, against the replicated head
    mesh = create_mesh(data=1, model=world)
    gen = torch.Generator().manual_seed(3)
    whole = MoEProjectionHead(768, 512, n_experts=4, generator=gen).to(device)
    split = MoEProjectionHead(768, 512, n_experts=4,
                              generator=torch.Generator().manual_seed(3)).to(device)
    shard_moe_params(split, mesh, 4, MODEL_AXIS)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((32, 768)).astype(np.float32)).to(device)
    (whole(x) ** 2).sum().backward()
    y = split(x)
    ((y ** 2).sum() / world).backward()  # the replicated loss, counted once over the ranks
    router = split.router.grad.clone()
    dist.all_reduce(router)
    local = split.w_in.shape[0]
    lo = rank * local

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    errs = [rel(y, whole(x)), rel(router, whole.router.grad)]
    for leaf in ("w_in", "b_in", "w_out", "b_out"):
        errs.append(rel(getattr(split, leaf).grad, getattr(whole, leaf).grad[lo:lo + local]))
    out["ep"] = {"max_rel": max(errs), "local_experts": local}
    if not max(errs) <= MOE_REL_TOL:
        raise AssertionError(f"EP MoE head vs replicated: {errs}")
    moe = ["parallel=tp2", "projection=moe512", "projection.config.n_experts=4",
           "scheduler.config.epochs=1"]
    t0 = time.perf_counter()
    ep = run(config("ep", moe), device=device)
    out["ep_train"] = {"expert_sharded": ep._expert_sharded, "wall_s": time.perf_counter() - t0,
                       "run_dir": config("ep", moe).base.tensorboard_export_dir}
    # the same run with the head replicated: the same tensor-parallel bank
    replicated = run(config("tp_moe", moe + ["parallel.expert_sharding=false"]), device=device)
    out["tp_moe"] = {"expert_sharded": replicated._expert_sharded,
                     "run_dir": config("tp_moe", moe).base.tensorboard_export_dir}
    return out


def peer_ring_entry(phase21):
    """The ``kernels`` entry of the ring across processes: phase 21's times
    at the 2-process training gather, launches from its data-parallel run."""
    row = phase21["row"]
    return {"name": "ring_all_gather_peer", "route": "cuda",
            "source": "mmgclip_tpu_torch/csrc/ring_all_gather.cu",
            "replaces": "mmgclip_tpu/parallel/collectives.py:189", "launches": phase21["launches"],
            "max_abs_err": 0.0, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes", "library_ms": row["library_ms"],
            "work": f"2 processes x {row['shape']} fp32 sharing the card, one hop "
                    f"(the data-parallel trainer's gather); library: {row['library']}"}


def phase_parallel(device, tmp, smi, train_run, train_tree):
    """Phase 21: the ring across 2 and 4 processes on the card, the global
    losses and ring attention across them, and the trainer data parallel
    over 2 processes (against phase 14's single-process run) with ZeRO-1,
    the TP 2 / PP 2 banks and the EP MoE head."""
    t0 = time.perf_counter()
    ring = run_peers("ring", 4, tmp)
    ring_s = time.perf_counter() - t0
    log(f"    4 processes on the card ({ring_s:.1f} s with their start): stream memory operations "
        f"{ring[0]['stream_ops']}; {len(ring[0]['checks'])} checks on rank 0, all held:")
    for line in ring[0]["checks"]:
        log(f"      {line}")
    timeout = [r["timeout"] for r in ring if "timeout" in r]
    log(f"    withheld hand-off (rank 1 keeps its signal, {PEER_TIMEOUT_TEST_S} s deadline): "
        f"{[(t['rank'], round(t['seconds'], 3), (t['raised'] or '')[:60]) for t in timeout]}; the next call "
        f"bit-equal")
    for row in ring[0]["times"]:
        others = [r["times"] for r in ring[1:] if r["times"]]
        log(f"    ring across {row['P']} processes, {row['P']} x {row['shape']} fp32 (CUDA events over "
            f"{PEER_REPEATS} back-to-back calls, rank 0): {row['ms']:.4f} ms; in-process mode "
            f"{row['in_process_ms']:.4f} ms, plain (torch.cat) {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms (bytes); {row['library']} {row['library_ms']:.4f} ms (host clock) "
            f"({smi}); other ranks "
            f"{[t['ms'] for ts in others for t in ts if t['P'] == row['P'] and t['shape'] == row['shape']]}")

    train = phase_parallel_train(device, tmp, train_run, train_tree)
    row = next(r for r in ring[0]["times"] if r["P"] == 2 and r["shape"] == [16, 512])
    return {"launches": train["launches"], "row": row, "err": ring[0]["worst"],
            "seconds": ring_s + train["seconds"]}


def phase_parallel_train(device, tmp, train_run, train_tree, extra=()):
    """Phase 21's training half: two processes against ``train_run`` (a
    single-process run of the same config).  ``extra`` config overrides and
    a CPU ``device`` rehearse it off the card."""
    from mmgclip_tpu_torch.train import build_experiment, run
    from mmgclip_tpu_torch.training.checkpoint import load_checkpoint
    from mmgclip_tpu_torch.utils.tb import read_scalars
    from mmgclip_tpu_torch.weights import flatten_tree

    t0 = time.perf_counter()
    args = {"tree": list(train_tree), "root": os.path.join(tmp, "dp"), "extra": list(extra)}
    if device.type == "cpu":
        args["device"] = "cpu"
    train = run_peers("train", 2, tmp, args)
    train_s = time.perf_counter() - t0
    dp = train[0]["dp"]
    single = read_scalars(os.path.join(train_run, "runs"))
    multi = read_scalars(dp["run_dir"])
    worst = 0.0
    for tag in ("loss/train", "loss/val"):
        a, b = np.asarray(multi[tag]), np.asarray(single[tag])
        rel = np.abs(a - b) / np.abs(b)
        worst = max(worst, float(rel.max()))
        log(f"    {tag}: 2 processes {a.tolist()} vs phase 14 {b.tolist()}: max rel {rel.max():.3e} "
            f"(tol {DP_LOSS_REL_TOL:.0e})")
    if not worst <= DP_LOSS_REL_TOL:
        raise AssertionError(f"data-parallel losses vs phase 14: {worst}")
    with open(os.path.join(train_run, "results", "results.json")) as fh:
        single_results = json.load(fh)
    dp_results_path = os.path.join(os.path.dirname(dp["run_dir"]), "results", "results.json")
    with open(dp_results_path) as fh:
        same_results = json.load(fh) == single_results
    counts = dp["launches"]
    steps = sum(dp["steps"])
    if counts["ring_all_gather"] != (2 * steps if device.type == "cuda" else 0):
        raise AssertionError(f"DP training: {counts['ring_all_gather']} ring launches for {steps} steps")
    log(f"    train_binary_class_clf over 2 processes ({train_s:.1f} s for the whole child group): "
        f"{steps} steps, launches {counts} (rank 0), epoch ms {[round(m, 2) for m in dp['epoch_ms']]} "
        f"(CUDA events, eager, gloo gradient all-reduce through the host), bank {dp['bank_s']:.2f} s, "
        f"run() {dp['wall_s']:.1f} s; results.json {'equal to' if same_results else 'differs from'} "
        f"phase 14's")
    zero = train[0]["zero"]
    zl = read_scalars(zero["run_dir"])
    zrel = max(float(np.max(np.abs(np.asarray(zl[t]) - np.asarray(multi[t])) / np.abs(np.asarray(multi[t]))))
               for t in ("loss/train", "loss/val"))
    if not (zero["sharded"] and zrel <= DP_LOSS_REL_TOL
            and zero["moment_bytes"] < zero["replicated_bytes"]):
        raise AssertionError(f"ZeRO-1: {zero}, rel {zrel}")
    log(f"    ZeRO-1: moments of {zero['sharded']} split, {zero['moment_bytes']} B of moments a rank vs "
        f"{zero['replicated_bytes']} B replicated; losses vs the DP run max rel {zrel:.3e}")
    for layout in ("tp2", "pp2"):
        log(f"    {layout} BERT-base bank vs the plain bank: max_abs / max |plain| "
            f"{train[0][layout]['bank_rel']:.3e} (tol {BANK_REL_TOL:.0e}), {train[0][layout]['bank_s']:.2f} s")
    log(f"    EP MoE head (E = 4, model axis 2, {train[0]['ep']['local_experts']} experts a rank) vs the "
        f"replicated head: outputs and gradients max_abs / max |replicated| "
        f"{train[0]['ep']['max_rel']:.3e} (tol {MOE_REL_TOL:.0e})")
    ep_run = train[0]["ep_train"]
    moe_cfg = train_config(os.path.join(tmp, "moe_single"), train_tree, [
        *extra, "projection=moe512", "projection.config.n_experts=4", "scheduler.config.epochs=1"])
    run(moe_cfg, device=device)
    a = np.asarray(read_scalars(ep_run["run_dir"])["loss/train"])
    b = np.asarray(read_scalars(moe_cfg.base.tensorboard_export_dir)["loss/train"])
    r = np.asarray(read_scalars(train[0]["tp_moe"]["run_dir"])["loss/train"])
    ep_rel = float(np.max(np.abs(a - b) / np.abs(b)))
    split_rel = float(np.max(np.abs(a - r) / np.abs(r)))
    if not (ep_run["expert_sharded"] and not train[0]["tp_moe"]["expert_sharded"]
            and ep_rel <= DP_LOSS_REL_TOL and split_rel <= DP_LOSS_REL_TOL):
        raise AssertionError(f"EP + TP training: {a} vs one process {b}, vs the head replicated {r}")
    log(f"    EP + TP 2 training (1 epoch): {a.tolist()} vs one process {b.tolist()} (rel {ep_rel:.3e}), "
        f"vs the head replicated on the same TP bank {r.tolist()} (rel {split_rel:.3e})")

    # the DP checkpoint resumed in one process
    cfg = train_config(os.path.join(tmp, "dp_resume"), train_tree, [
        *extra, f"checkpoints.checkpoints_export_dir={os.path.dirname(dp['ckpt'])}",
        "scheduler.config.epochs=4"])
    resumed = build_experiment(cfg, device=device)
    if not resumed.resume():
        raise AssertionError("the DP checkpoint did not resume in one process")
    saved = flatten_tree(load_checkpoint(dp["ckpt"])["params"])
    mine = flatten_tree(resumed._host_params())
    if any(not np.array_equal(saved[k], mine[k]) for k in saved):
        raise AssertionError("the resumed params differ from the DP checkpoint's")
    resumed.run()
    tail = read_scalars(cfg.base.tensorboard_export_dir)["loss/train"]
    if not np.isfinite(tail).all():
        raise AssertionError(f"the resumed run's loss {tail}")
    log(f"    the DP checkpoint resumed in one process (epoch {resumed.current_epoch}): params equal, "
        f"epoch 4 train loss {tail}")
    return {"launches": counts["ring_all_gather"], "seconds": train_s}


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this smoke runs only on a CUDA card")
        return 1
    from mmgclip_tpu_torch.config import compose
    from mmgclip_tpu_torch.evaluation.report_cascade import BANKS, BANK_ORDER
    from mmgclip_tpu_torch.ops import _build, launch_counts, reset_launch_counts

    device = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device ------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    peaks = peaks_for(name)
    log(f"[1] device: {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"    peaks used for bounds ({peaks['variant']} data sheet): {peaks}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    seconds = _build.build_all()
    log(f"[2] build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s")
    for source, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {source}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    stage_shapes = [(2, 256, 208, 96), (2, 128, 104, 192), (2, 64, 52, 384), (2, 32, 26, 768)]
    ffdm_shape = (1, 574, 479, 96)  # 2294x1914 input after the br_pad stem
    # the micro tower's stages on phase 15's bucket of 32 images of 32x32:
    # C = 8 and 16 pad the mma's K, C = 768 at H = W = 1
    micro_shapes = [(32, 8, 8, 8), (32, 4, 4, 16), (32, 2, 2, 32), (32, 1, 1, 768)]

    # 3. kernel 1 parity ------------------------------------------------------
    log("[3] fused_convnext_block vs plain_convnext_block")
    block_err = phase_block_parity(device, gen, stage_shapes + [ffdm_shape] + micro_shapes)

    # 4. kernel 2 parity ------------------------------------------------------
    log("[4] flash_attention vs attention_reference")
    flash_err = phase_flash_parity(device, gen)

    # 5. kernels 3-6 parity ----------------------------------------------------
    log("[5] int8 block, fused stem, fused downsample, depthwise conv vs their plain versions")
    glue_err = phase_glue_parity(device, gen)

    # 5b. the port-only threefry and dropout kernels ---------------------------
    log("[5b] threefry2x32 and dropout vs their plain versions (utils/prng.py, on the CPU)")
    dropout_err = phase_dropout_parity(device)

    # 6. the serving path ---------------------------------------------------------
    log("[6] serving path: ConvNeXt-Tiny (fused blocks, bf16) + BERT-base (flash), seeded weights")
    from mmgclip_tpu_torch.serve import handle
    from mmgclip_tpu_torch.serving import InferenceEngine

    tmp = tempfile.TemporaryDirectory(prefix="mmgclip_smoke_")
    try:
        configs = os.path.join(REPO, "configs")
        cfg = compose(configs, "train_binary_class_clf", ["networks=clip_convnext_fused_bert"],
                      run_dir=tmp.name)
        cfg_plain = compose(configs, "train_binary_class_clf",
                            ["networks=clip_convnext_fused_bert",
                             "networks.image_encoder.config.use_fused_blocks=false"],
                            run_dir=tmp.name)
        t0 = time.perf_counter()
        engine = InferenceEngine(cfg)
        plain_engine = InferenceEngine(cfg_plain)
        log(f"    engines built in {time.perf_counter() - t0:.1f}s; tower "
            f"{engine.cn_config.depths}/{engine.cn_config.dims} {engine.cn_config.dtype}, "
            f"text {engine.model.bert_config.hidden_size}x{engine.model.bert_config.num_hidden_layers}"
            f"x{engine.model.bert_config.num_attention_heads}")
        if not engine.cn_config.use_fused_blocks or plain_engine.cn_config.use_fused_blocks:
            raise AssertionError("the two engines must differ in use_fused_blocks only")
        # the flash text tower, built directly as bench.py does in the JAX
        # package (no config key reaches BertConfig.use_flash_attention)
        text = engine.model.text_module
        text.config = dataclasses.replace(text.config, use_flash_attention=True)
        for e in (engine, plain_engine):
            set_layer_scale(e.encode_module, 0.1)

        paths = []
        for i, (h, w) in enumerate([(1024, 832), (1024, 832), (2294, 1914)]):
            path = os.path.join(tmp.name, f"view_{i}.png")
            write_png16(path, synthetic_mammogram(h, w, seed=i))
            paths.append(path)
        n_buckets = 2
        class_list = ["Mammogram revealed a mass.", "Mammogram revealed calcifications.",
                      "No findings are present."]

        reset_launch_counts()
        t0 = time.perf_counter()
        responses = {
            "ping": handle(engine, {"op": "ping"}),
            "encode": handle(engine, {"op": "encode", "paths": paths}),
        }
        after_encode = launch_counts()
        feats = np.asarray(responses["encode"]["features"], np.float32)
        responses["classify_paths"] = handle(engine, {"op": "classify", "paths": paths,
                                                      "class_list": class_list})
        responses["classify_b64"] = handle(engine, {
            "op": "classify", "features_b64": base64.b64encode(feats.astype("<f4").tobytes()).decode(),
            "features_rows": len(paths), "class_list": class_list})
        responses["report_paths"] = handle(engine, {"op": "report", "paths": paths, "seed": 42})
        responses["report_exam"] = handle(engine, {"op": "report", "exam_dir": tmp.name})
        torch.cuda.synchronize()
        main_path_s = time.perf_counter() - t0
        counts = launch_counts()
        log(f"    requests answered in {main_path_s:.2f}s; launches {counts} "
            f"(after the encode request: {after_encode})")

        if responses["ping"] != {"ok": True}:
            raise AssertionError(f"ping: {responses['ping']}")
        if feats.shape != (3, 768) or not np.isfinite(feats).all():
            raise AssertionError(f"encode features: shape {feats.shape}, finite {np.isfinite(feats).all()}")
        if after_encode["fused_convnext_block"] != 18 * n_buckets:
            raise AssertionError(f"encode launched the block kernel {after_encode} times, "
                                 f"not 18 per bucket x {n_buckets} buckets")
        for key in ("classify_paths", "classify_b64"):
            probs = np.asarray(responses[key]["classes_similarities"])
            argmax = responses[key]["similarities_argmax"]
            if (probs.shape != (3, len(class_list)) or not np.isfinite(probs).all()
                    or not np.allclose(probs.sum(axis=1), 1.0, atol=1e-5)
                    or not all(0 <= a < len(class_list) for a in argmax)):
                raise AssertionError(f"{key}: {responses[key]}")
        diff = np.abs(np.asarray(responses["classify_paths"]["classes_similarities"])
                      - np.asarray(responses["classify_b64"]["classes_similarities"])).max()
        if diff > 1e-6:
            raise AssertionError(f"classify by paths and by features_b64 differ by {diff}")
        for key, n_expected in (("report_paths", 3), ("report_exam", 1)):
            reports = responses[key]["reports"]
            if len(reports) != n_expected or not all(isinstance(r, str) and r for r in reports):
                raise AssertionError(f"{key}: {reports}")
        for decisions in engine.cascade_decisions(feats):
            for bank in BANK_ORDER:
                if not 0 <= decisions[bank] < len(BANKS[bank]):
                    raise AssertionError(f"decision {bank}={decisions[bank]} out of range")
        for kernel in ("fused_convnext_block", "flash_attention"):
            if counts[kernel] <= 0:
                raise AssertionError(f"the serving path never launched {kernel}")
        log(f"    classify: {responses['classify_paths']['similarities_argmax']}; "
            f"report[0]: {responses['report_paths']['reports'][0][:90]}...")

        plain_feats = plain_engine.encode_paths(paths)
        cosine = (feats * plain_feats).sum(1) / (np.linalg.norm(feats, axis=1) * np.linalg.norm(plain_feats, axis=1))
        log(f"    fused vs unfused tower features, per image cosine: {cosine.tolist()}")
        if not (cosine >= FEATURE_COSINE_MIN).all():
            raise AssertionError(f"feature cosine {cosine} < {FEATURE_COSINE_MIN}")

        # 7. text tower with flash -------------------------------------------------
        log("[7] BERT-base text tower: flash vs plain attention, same weights (fp32)")
        from mmgclip_tpu_torch.models.bert import BertEncoder, trim_padded_tail

        flash_tower = engine.model.text_module
        plain_tower = BertEncoder(dataclasses.replace(flash_tower.config, use_flash_attention=False))
        plain_tower.load_state_dict(flash_tower.state_dict())
        plain_tower.to(device).eval()
        prompts = [p for bank in BANK_ORDER for p in BANKS[bank]]
        tokens = trim_padded_tail(engine.tokenizer(prompts, max_length=256), 32)
        rng = np.random.default_rng(0)
        full_ids = rng.integers(5, flash_tower.config.vocab_size, size=(8, 256)).astype(np.int64)
        full_mask = (np.arange(256)[None, :] < np.array([256, 200, 31, 1, 256, 128, 77, 255])[:, None])
        cases = {
            f"prompt banks b={len(prompts)} s={tokens['input_ids'].shape[1]}":
                (tokens["input_ids"], tokens["attention_mask"]),
            "random ids b=8 s=256": (full_ids, full_mask.astype(np.int64)),
        }
        text_err = 0.0
        with torch.inference_mode():
            for label, (ids, mask) in cases.items():
                ids_t = torch.as_tensor(ids, device=device)
                mask_t = torch.as_tensor(mask, device=device)
                before = launch_counts()["flash_attention"]
                a = flash_tower(ids_t, mask_t)
                launched = launch_counts()["flash_attention"] - before
                b = plain_tower(ids_t, mask_t)
                err = (a - b).abs().max().item()
                text_err = max(text_err, err)
                log(f"    {label}: max_abs {err:.3e} (tol {TOWER_FP32_ABS_TOL:.0e}), "
                    f"flash launches {launched}")
                if not err <= TOWER_FP32_ABS_TOL or launched != flash_tower.config.num_hidden_layers:
                    raise AssertionError(f"text tower {label}: err {err}, launches {launched}")

        # 8. the feature-store path ------------------------------------------------
        log("[8] feature store: ImageFeatureExtractor.extract(), ConvNeXt-Tiny int8 + fused "
            "stem/downsample (clip_convnext_fused_tanh_bert), 16-bit full-field PNGs")
        tree, rows, store_feats, _s, store_counts, store_ex, bf16_enc = phase_feature_store(
            device, tmp.name)

        # 9. the masked paths ------------------------------------------------------
        log("[9] masked paths: resize + host prepool, bucket rounding")
        resize_ex, round_ex, _fp32 = phase_masked(device, tmp.name, tree, rows, store_feats)

        # 10. the depthwise tower ---------------------------------------------------
        log("[10] unfused tower with the depthwise kernel (use_pallas_dwconv)")
        dw_towers, dw_pixels, dw_counts = phase_depthwise_tower(device, engine)

        # 12. the ring all-gather ------------------------------------------------------
        log("[12] ring_all_gather vs ring_all_gather_plain (P logical ranks on one card)")
        ring_err = phase_ring_parity(device)

        # 13. the global contrastive loss through the ring -------------------------------
        log("[13] global contrastive losses with use_ring_gather=True vs the single-device losses")
        ring_launches = phase_global_loss(device)

        # 14. training and test() ------------------------------------------------------
        log("[14] training: mmgclip_tpu_torch.train.run (train_binary_class_clf), then test()")
        _train_times, train_run, train_tree = phase_training(device, tmp.name, smi)

        # 15. the product gates -------------------------------------------------------
        log("[15] product gates: one checkpoint, a feature store per speed knob of the tower")
        phase_product_gates(device, tmp.name)

        # 16. main-path step 4 and the other entry points ------------------------------------
        log("[16] generate_report (one image, one four-view exam), evaluate_cnn and the unix-socket "
            "server over the trained run, the tower in the feature-store preset")
        report = phase_report_paths(device, tmp.name, train_run, train_tree)

        # 17. the exam-report family --------------------------------------------------------
        log("[17] the exam-report family: encode_studies (feature-store preset), "
            "train_exam_reports_clf (CLIPLoss, MMGCLIPLoss), PromptClassifier and the heads")
        exam_times = phase_exam(device, tmp.name, smi)

        # 18. the BioGPT text-tower family -----------------------------------------------
        log("[18] BioGPT at full width: train (networks=clip_convnext_biogpt tokenizer=biogpt), "
            "test(), evaluate_clip, generate_report and serve --once over the run")
        phase_biogpt(device, tmp.name, smi, train_tree)

        # 19. the ResNet-50 family ------------------------------------------------------
        log("[19] ResNet-50 at full width: train (networks=clip_resnet50_bert, layer4 trains inside "
            "the graphed step), test(), evaluate_clip, generate_report and serve --once over the run")
        resnet_times = phase_resnet(device, tmp.name, smi, train_tree)

        # 20. the port from the reference's torch artifacts, then the tools -------------
        log("[20] reproduce from torch artifacts at full width (TorchScript ConvNeXt-Tiny, HF "
            "BERT-base): convert, encode, train, test(), report; the store preset over the "
            "converted weights; tsne_eval, data_efficiency, eda, parity_harness, demo_run")
        t0 = time.perf_counter()
        phase20 = phase_reproduce(device, tmp.name, smi)
        log(f"    phase 20 in {time.perf_counter() - t0:.1f}s")

        # 21. the parallel layer across processes ----------------------------------------
        log("[21] the parallel layer across processes sharing the card (gloo): the ring transport "
            "at P = 2, 4, the global losses, ring attention; train_binary_class_clf data parallel "
            "over 2 processes, ZeRO-1, the TP 2 / PP 2 banks, the EP MoE head")
        t0 = time.perf_counter()
        phase21 = phase_parallel(device, tmp.name, smi, train_run, train_tree)
        log(f"    phase 21 in {time.perf_counter() - t0:.1f}s")

        # 11. times (after 12-21) --------------------------------------------------------
        log("[11] times (CUDA events, median of 10 after 3 warmup unless stated)")
        kernels = timing_phase(device, gen, peaks, stage_shapes, ffdm_shape, tokens, counts,
                               block_err, flash_err)
        kernels += timing_glue(device, gen, peaks, glue_err, store_counts, dw_counts)
        kernels.append(timing_ring(device, peaks, smi, ring_launches, ring_err))
        split_launches = {name: exam_times["train_launches"].get(name, 0)
                          + resnet_times["train_launches"].get(name, 0)
                          for name in ("threefry2x32", "dropout")}
        kernels += timing_dropout(device, peaks, split_launches, dropout_err)
        kernels.append(peer_ring_entry(phase21))
        for entry in kernels:
            entry["phase20_launches"] = phase20["launches"].get(entry["name"], 0)
        timing_programs(device, engine, store_ex, resize_ex, round_ex, bf16_enc, dw_towers,
                        dw_pixels, tree, smi)
        timing_reports(device, report, smi)
        enc_times = {}
        with torch.inference_mode():
            for label, shape, n in (("1024x832 bucket of 2", (1024, 832), 2),
                                    ("2294x1914 bucket of 1", (2294, 1914), 1)):
                pixels = torch.from_numpy(np.stack(
                    [synthetic_mammogram(*shape, seed=9 + j) for j in range(n)])).to(device)
                for e, tag in ((engine, "fused"), (plain_engine, "unfused")):
                    ms = time_ms(lambda: e._encode(pixels), warmup=2, iters=5)
                    enc_times[f"{label} {tag}"] = ms
                    log(f"    encode program {label}, {tag} blocks: {ms:.2f} ms = {1e3 * n / ms:.2f} img/s")
        request_ms = {}
        b64 = base64.b64encode(feats[:1].astype("<f4").tobytes()).decode()
        for label, request in (
                ("classify 1 image (features_b64)", {"op": "classify", "features_b64": b64,
                                                     "class_list": class_list}),
                ("report 1 image (features_b64)", {"op": "report", "features_b64": b64}),
                ("encode 2x1024x832 + 1x2294x1914 PNG paths", {"op": "encode", "paths": paths})):
            handle(engine, request)
            samples = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                handle(engine, request)
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t0) * 1e3)
            request_ms[label] = float(np.median(samples))
            log(f"    request {label}: {request_ms[label]:.2f} ms (host clock, median of 5)")
        engine.close()
        plain_engine.close()
    finally:
        tmp.cleanup()

    log(f"    smoke wall time {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


def block_halves(x, p):
    """Launchers of the fp / bf16 block's two halves alone on preallocated
    buffers (``mmg_fused_block_depthwise`` into the fp32 workspace, then
    ``mmg_fused_block_ln_mlp``), for timing each; they count no launch."""
    from mmgclip_tpu_torch.ops import _build
    from mmgclip_tpu_torch.ops import fused_block as fb

    lib = _build.load_typed(fb._SOURCE, fb._SIGNATURES)
    n, h, w, c = x.shape
    ws = torch.empty((n * h * w, c), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, *p)]  # x, dwk, dwb, ns, nb, w1, b1, w2, b2, gamma
    stream = torch.cuda.current_stream().cuda_stream
    code = fb._DTYPES[x.dtype]

    def front():
        _build.check(lib, lib.mmg_fused_block_depthwise(code, *ptrs[:3], ws.data_ptr(), n, h, w, c,
                                                        stream), "block depthwise half")

    def back():
        _build.check(lib, lib.mmg_fused_block_ln_mlp(code, ws.data_ptr(), ptrs[0], *ptrs[3:],
                                                     out.data_ptr(), n, h, w, c, fb.EPS, 0, stream),
                     "block ln_mlp half")
    return front, back


def timing_phase(device, gen, peaks, stage_shapes, ffdm_shape, tokens, counts, block_err, flash_err):
    import torch.nn.functional as F

    from mmgclip_tpu_torch.ops.depthwise_conv import launch_depthwise_conv7x7
    from mmgclip_tpu_torch.ops.flash_attention import attention_reference, launch_flash_attention
    from mmgclip_tpu_torch.ops.fused_block import launch_fused_block, plain_convnext_block

    # kernel 1 per shape as device time per call of back-to-back calls,
    # beside its two halves, the standalone depthwise tile (T output: the
    # difference to the front half is the fp32 hand-off), the plain version
    # and the bound (fp32 at the TF32 / 3 rate); the JSON entry is the
    # 18-block work of one encode of a 2 x 1024x832 bucket in bf16 (depths
    # 3/3/9/3), the main path's case
    depths = (3, 3, 9, 3)
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0.0, "bytes": 0.0,
             "depthwise_ms": 0.0, "ln_mlp_ms": 0.0}
    for shape in stage_shapes + [ffdm_shape]:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(*shape, generator=gen).to(device, dtype)
            p = block_params(shape[-1], dtype, gen, device)
            front, back = block_halves(x, p)
            ms = device_ms(lambda: launch_fused_block(x, *p))
            front_ms, back_ms = device_ms(front), device_ms(back)
            dw_ms = device_ms(lambda: launch_depthwise_conv7x7(x, p[0], p[1]))
            plain = device_ms(lambda: plain_convnext_block(x, *p))
            ops, moved = block_work(*shape, 2 if dtype == torch.bfloat16 else 4)
            rate, rate_label = flash_rate(dtype, peaks)
            bms, by = bound_ms(ops, moved, dtype, peaks, rate)
            log(f"    fused_convnext_block {shape} {str(dtype)[6:]}: kernel {ms:.4f} ms = depthwise half "
                f"{front_ms:.4f} (standalone tile {dw_ms:.4f}) + ln_mlp {back_ms:.4f} "
                f"({ops / back_ms / 1e9:.1f} TFLOP/s); plain {plain:.4f} ms; bound {bms:.4f} ms ({by}; "
                f"{rate_label}); device time per call")
            if dtype == torch.bfloat16 and shape in stage_shapes:
                reps = depths[stage_shapes.index(shape)]
                for key, value in (("ms", ms), ("plain_ms", plain), ("bound_ms", bms), ("ops", ops),
                                   ("bytes", moved), ("depthwise_ms", front_ms),
                                   ("ln_mlp_ms", back_ms)):
                    total[key] += reps * value
    bound_by = "operations" if total["ops"] / peaks["bf16"] >= total["bytes"] / peaks["bytes"] else "bytes"
    log(f"    fused_convnext_block, 18 blocks of 2 x 1024x832 bf16: {total['ms']:.4f} ms (depthwise "
        f"halves {total['depthwise_ms']:.4f}, ln_mlp halves {total['ln_mlp_ms']:.4f}), plain "
        f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms; device time")
    block_entry = {
        "name": "fused_convnext_block", "route": "cuda",
        "source": "mmgclip_tpu_torch/csrc/fused_block.cu",
        "replaces": "mmgclip_tpu/ops/fused_block.py:252",
        "launches": counts["fused_convnext_block"],
        "max_abs_err": max(v for (shape, dt, _t), v in block_err.items()
                           if dt == torch.bfloat16 and shape in stage_shapes),
        "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": bound_by, "library_ms": None,
        "depthwise_ms": total["depthwise_ms"], "ln_mlp_ms": total["ln_mlp_ms"],
        "work": "18 blocks of one 2x1024x832 encode bucket, bf16; device time",
    }

    # kernel 2: the serving path's prompt-bank batch (fp32, pad-trimmed s);
    # per-shape lines also at s=256 and in bf16.  Kernel, plain and SDPA as
    # device time per call of back-to-back calls; beside them the host time
    # of one checked call (allocation, ctypes, launch)
    lengths_banks = torch.as_tensor(np.asarray(tokens["attention_mask"]).sum(1), dtype=torch.int32)
    b_banks, s_banks = tokens["input_ids"].shape
    entry = None
    for (b, s, lengths) in ((b_banks, s_banks, lengths_banks),
                            (8, 256, torch.tensor([256, 200, 31, 1, 256, 128, 77, 255], dtype=torch.int32))):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, 12, s, 64, generator=gen).to(device, dtype) for _ in range(3))
            lens = lengths.to(device)
            mask = torch.arange(s, device=device)[None, :] < lens[:, None]
            ms = device_ms(lambda: launch_flash_attention(q, k, v, lens))
            # attention_reference copies its -1e30 fill to the card, which
            # waits for the queue: back-to-back calls with their stalls
            plain = chained_ms(lambda: attention_reference(q, k, v, mask))
            sdpa = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask[:, None, None, :]))
            host = time_ms(lambda: launch_flash_attention(q, k, v, lens))
            ops, moved = flash_work(b, 12, s, 64, lengths.tolist(), 2 if dtype == torch.bfloat16 else 4)
            rate, rate_label = flash_rate(dtype, peaks)
            bms, by = bound_ms(ops, moved, dtype, peaks, rate)
            log(f"    flash_attention b={b} h=12 s={s} d=64 {str(dtype)[6:]}: kernel {ms:.5f} ms, "
                f"sdpa {sdpa:.5f} ms (device time per call), plain {plain:.5f} ms (chained calls), "
                f"bound {bms:.5f} ms ({by}; {rate_label}); one checked call {host:.4f} ms with its "
                f"host time")
            if entry is None:
                entry = {
                    "name": "flash_attention", "route": "cuda",
                    "source": "mmgclip_tpu_torch/csrc/flash_attention.cu",
                    "replaces": "mmgclip_tpu/ops/flash_attention.py:135",
                    "launches": counts["flash_attention"],
                    "max_abs_err": max(v for (_s, dt), v in flash_err.items() if dt == torch.float32),
                    "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": sdpa,
                    "work": f"prompt-bank batch b={b} h=12 s={s} d=64, fp32; device time; "
                            f"bound at {rate_label}",
                }
    return [block_entry, entry]


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        log("chip_smoke: FAILED")
        raise
