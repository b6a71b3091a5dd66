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

Each path runs with the launch counts set to 0 just before it and read just
after.  It checks what comes out, and times every kernel beside its plain
version, its bound and (where one exists) the one PyTorch call that computes
the same function, plus the encode programs, ``extract()`` and PNG decode.

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
# and bf16 (tensor core) operations/s, keyed by the name nvidia-smi reports.
PEAKS = {
    "H100 80GB HBM3": {"variant": "H100 SXM5", "bytes": 3.35e12, "fp32": 67e12, "bf16": 989e12,
                       "int8": 1979e12},
    "H100 PCIe": {"variant": "H100 PCIe", "bytes": 2.0e12, "fp32": 51e12, "bf16": 756e12,
                  "int8": 1513e12},
    "H100 NVL": {"variant": "H100 NVL", "bytes": 3.9e12, "fp32": 60e12, "bf16": 835e12,
                 "int8": 1671e12},
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


def write_png16(path: str, pixels: np.ndarray, paeth: bool = False) -> None:
    """Grayscale 16-bit PNG with the standard library's zlib: every row
    unfiltered, or every row Paeth-filtered (the slow case for decoders)."""
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

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(data)


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


def bound_ms(ops, moved, dtype, peaks):
    rate = peaks["bf16"] if dtype == torch.bfloat16 else peaks["fp32"]
    t_ops, t_bytes = ops / rate, moved / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    from mmgclip_tpu_torch.ops.fused_block import launch_fused_block, plain_convnext_block

    worst = {}
    for shape in shapes:
        n, h, w, c = shape
        for dtype in (torch.float32, torch.bfloat16):
            for tanh in (False, True):
                x = torch.randn(n, h, w, c, generator=gen).to(device, dtype)
                p = block_params(c, dtype, gen, device)
                out = launch_fused_block(x, *p, gelu_tanh=tanh)
                ref = plain_convnext_block(x, *p, gelu_tanh=tanh)
                torch.cuda.synchronize()
                err, rel = rel_err(out, ref)
                tol = FP32_REL_TOL if dtype == torch.float32 else BF16_REL_TOL
                log(f"  block {shape} {str(dtype)[6:]} gelu={'tanh' if tanh else 'exact'}: "
                    f"max_abs {err:.3e} rel {rel:.3e} (tol {tol:.1e})")
                if not rel <= tol:
                    raise AssertionError(f"fused block {shape} {dtype} tanh={tanh}: rel {rel} > {tol}")
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
                ms = time_ms(lambda: launch(*args))
                plain_ms = time_ms(lambda: plain(*args))
                library = None
                if kind == "depthwise":
                    x, w, b = args
                    w_oihw = w.permute(3, 2, 0, 1).contiguous()
                    library = time_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, padding=3,
                                                       groups=shape[-1]))
                bms, by = {"stem": lambda: stem_bound(shape, cout, torch.float32, dtype, peaks),
                           "downsample": lambda: downsample_bound(shape, cout, dtype, peaks),
                           "depthwise": lambda: depthwise_bound(shape, dtype, peaks),
                           "int8": lambda: int8_block_bound(shape, dtype, peaks)}[kind]()
                lib = "" if library is None else f", library {library:.3f} ms"
                log(f"    {kind} {shape}" + (f"->{cout}" if cout else "") + f" {str(dtype)[6:]}: "
                    f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, bound {bms:.4f} ms ({by})")
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
                        if library is not None:
                            t["library_ms"] = (t["library_ms"] or 0.0) + reps * library
    meta = {
        "int8": ("fused_convnext_block_int8", "mmgclip_tpu_torch/csrc/fused_block.cu",
                 "mmgclip_tpu/ops/fused_block.py:280", store_counts,
                 "18 int8 blocks of one 2x2294x1914 feature-store bucket, bf16"),
        "stem": ("fused_stem", "mmgclip_tpu_torch/csrc/fused_stem.cu",
                 "mmgclip_tpu/ops/fused_stem.py:98", store_counts,
                 "the stem of one 2x2294x1914 feature-store bucket, fp32 input, bf16 weights"),
        "downsample": ("fused_ln_downsample", "mmgclip_tpu_torch/csrc/fused_downsample.cu",
                       "mmgclip_tpu/ops/fused_downsample.py:132", store_counts,
                       "3 downsamples of one 2x2294x1914 feature-store bucket, bf16"),
        "depthwise": ("depthwise_conv7x7", "mmgclip_tpu_torch/csrc/depthwise_conv.cu",
                      "mmgclip_tpu/ops/depthwise_conv.py:45", dw_counts,
                      "18 depthwise convs of one 2x1024x832 bucket, bf16"),
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
        })
    return entries


def timing_programs(device, engine, store_ex, resize_ex, round_ex, bf16_enc, dw_towers, dw_pixels,
                    tree):
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

    # extract() end to end on the host clock, a second time into a fresh dir
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
    out["extract"] = seconds
    log(f"    extract() of {n} full-field PNGs (int8 preset), second run: {seconds:.3f} s = "
        f"{n / seconds:.2f} img/s (host clock, decode and writes included)")

    # the Average/Paeth unfilter is a Python loop: time one full-field file
    png = os.path.join(os.path.dirname(store_ex.export_dir), "paeth.png")
    pixels = synthetic_mammogram(*FFDM_SHAPES[0], seed=41)
    write_png16(png, pixels, paeth=True)
    t0 = time.perf_counter()
    decoded = decode_png(png)
    paeth_s = time.perf_counter() - t0
    if not np.array_equal(decoded, pixels):
        raise AssertionError("Paeth-filtered PNG decoded wrong")
    t0 = time.perf_counter()
    decode_png(tree[3][0])
    plain_s = time.perf_counter() - t0
    out["paeth_decode_s"], out["unfiltered_decode_s"] = paeth_s, plain_s
    log(f"    decode_png {h}x{w} 16-bit: every row Paeth {paeth_s:.2f} s, unfiltered {plain_s:.3f} s "
        f"(host clock)")
    return out


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

    # 3. kernel 1 parity ------------------------------------------------------
    log("[3] fused_convnext_block vs plain_convnext_block")
    block_err = phase_block_parity(device, gen, stage_shapes + [ffdm_shape])

    # 4. kernel 2 parity ------------------------------------------------------
    log("[4] flash_attention vs attention_reference")
    flash_err = phase_flash_parity(device, gen)

    # 5. kernels 3-6 parity ----------------------------------------------------
    log("[5] int8 block, fused stem, fused downsample, depthwise conv vs their plain versions")
    glue_err = phase_glue_parity(device, gen)

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

        # 11. times -----------------------------------------------------------------
        log("[11] times (CUDA events, median of 10 after 3 warmup unless stated)")
        kernels = timing_phase(device, gen, peaks, stage_shapes, ffdm_shape, tokens, counts,
                               block_err, flash_err)
        kernels += timing_glue(device, gen, peaks, glue_err, store_counts, dw_counts)
        timing_programs(device, engine, store_ex, resize_ex, round_ex, bf16_enc, dw_towers,
                        dw_pixels, tree)
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


def timing_phase(device, gen, peaks, stage_shapes, ffdm_shape, tokens, counts, block_err, flash_err):
    import torch.nn.functional as F

    from mmgclip_tpu_torch.ops.flash_attention import attention_reference, launch_flash_attention
    from mmgclip_tpu_torch.ops.fused_block import launch_fused_block, plain_convnext_block

    # kernel 1 per shape; the JSON entry is the 18-block work of one encode
    # of a 2 x 1024x832 bucket in bf16 (depths 3/3/9/3), the main path's case
    depths = (3, 3, 9, 3)
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0.0, "bytes": 0.0}
    for shape in stage_shapes + [ffdm_shape]:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(*shape, generator=gen).to(device, dtype)
            p = block_params(shape[-1], dtype, gen, device)
            ms = time_ms(lambda: launch_fused_block(x, *p))
            plain = time_ms(lambda: plain_convnext_block(x, *p))
            ops, moved = block_work(*shape, 2 if dtype == torch.bfloat16 else 4)
            bms, by = bound_ms(ops, moved, dtype, peaks)
            log(f"    fused_convnext_block {shape} {str(dtype)[6:]}: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
                f"bound {bms:.4f} ms ({by}), {ops / ms / 1e9:.2f} TFLOP/s")
            if dtype == torch.bfloat16 and shape in stage_shapes:
                reps = depths[stage_shapes.index(shape)]
                total["ms"] += reps * ms
                total["plain_ms"] += reps * plain
                total["bound_ms"] += reps * bms
                total["ops"] += reps * ops
                total["bytes"] += reps * moved
    bound_by = "operations" if total["ops"] / peaks["bf16"] >= total["bytes"] / peaks["bytes"] else "bytes"
    block_entry = {
        "name": "fused_convnext_block", "route": "cuda",
        "source": "mmgclip_tpu_torch/csrc/fused_block.cu",
        "replaces": "mmgclip_tpu/ops/fused_block.py:251",
        "launches": counts["fused_convnext_block"],
        "max_abs_err": max(v for (shape, dt, _t), v in block_err.items()
                           if dt == torch.bfloat16 and shape in stage_shapes),
        "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": bound_by, "library_ms": None,
        "work": "18 blocks of one 2x1024x832 encode bucket, bf16",
    }

    # kernel 2: the serving path's prompt-bank batch (fp32, pad-trimmed s);
    # per-shape lines also at s=256 and in bf16
    lengths_banks = torch.as_tensor(np.asarray(tokens["attention_mask"]).sum(1), dtype=torch.int32)
    b_banks, s_banks = tokens["input_ids"].shape
    entry = None
    for (b, s, lengths) in ((b_banks, s_banks, lengths_banks),
                            (8, 256, torch.tensor([256, 200, 31, 1, 256, 128, 77, 255], dtype=torch.int32))):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, 12, s, 64, generator=gen).to(device, dtype) for _ in range(3))
            lens = lengths.to(device)
            mask = torch.arange(s, device=device)[None, :] < lens[:, None]
            ms = time_ms(lambda: launch_flash_attention(q, k, v, lens))
            plain = time_ms(lambda: attention_reference(q, k, v, mask))
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None, None, :]))
            ops, moved = flash_work(b, 12, s, 64, lengths.tolist(), 2 if dtype == torch.bfloat16 else 4)
            bms, by = bound_ms(ops, moved, dtype, peaks)
            log(f"    flash_attention b={b} h=12 s={s} d=64 {str(dtype)[6:]}: kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, sdpa {sdpa:.4f} ms, bound {bms:.5f} ms ({by})")
            if entry is None:
                entry = {
                    "name": "flash_attention", "route": "cuda",
                    "source": "mmgclip_tpu_torch/csrc/flash_attention.cu",
                    "replaces": "mmgclip_tpu/ops/flash_attention.py:134",
                    "launches": counts["flash_attention"],
                    "max_abs_err": max(v for (_s, dt), v in flash_err.items() if dt == torch.float32),
                    "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": sdpa,
                    "work": f"prompt-bank batch b={b} h=12 s={s} d=64, fp32",
                }
    return [block_entry, entry]


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        log("chip_smoke: FAILED")
        raise
