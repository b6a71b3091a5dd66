"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mmgclip_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, then drives the serving path
(``mmgclip_tpu_torch.serve.handle`` over ``InferenceEngine``) at the full
width of ConvNeXt-Tiny + BERT-base with seeded random weights, checks what
comes out, and times every kernel beside its plain version, its bound and
(where one exists) the one PyTorch call that computes the same function.

Imports nothing of JAX or of ``mmgclip_tpu``.  Exits non-zero, without the
result line, when CUDA is unavailable or any phase fails.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels as JSON.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import math
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
    "H100 80GB HBM3": {"variant": "H100 SXM5", "bytes": 3.35e12, "fp32": 67e12, "bf16": 989e12},
    "H100 PCIe": {"variant": "H100 PCIe", "bytes": 2.0e12, "fp32": 51e12, "bf16": 756e12},
    "H100 NVL": {"variant": "H100 NVL", "bytes": 3.9e12, "fp32": 60e12, "bf16": 835e12},
}
FP32_REL_TOL = 1e-4           # kernel 1 vs plain, fp32 with TF32 off
BF16_REL_TOL = 2.0 ** -6      # both kernels in bf16: two bf16 steps of the largest value
FLASH_FP32_ABS_TOL = 1e-5     # kernel 2 vs attention_reference, fp32
TOWER_FP32_ABS_TOL = 1e-4     # BERT-base hidden states, flash vs plain attention, 12 layers
FEATURE_COSINE_MIN = 0.9999   # fused vs unfused ConvNeXt-Tiny features, bf16


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


def write_png16(path: str, pixels: np.ndarray) -> None:
    """Grayscale 16-bit PNG with the standard library's zlib (filter 0)."""
    h, w = pixels.shape
    rows = np.zeros((h, 1 + 2 * w), np.uint8)
    rows[:, 1:] = pixels.astype(">u2").view(np.uint8).reshape(h, 2 * w)

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

    # 5. the serving path ---------------------------------------------------------
    log("[5] serving path: ConvNeXt-Tiny (fused blocks, bf16) + BERT-base (flash), seeded weights")
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
        for kernel, launched in counts.items():
            if launched <= 0:
                raise AssertionError(f"the serving path never launched {kernel}")
        log(f"    classify: {responses['classify_paths']['similarities_argmax']}; "
            f"report[0]: {responses['report_paths']['reports'][0][:90]}...")

        plain_feats = plain_engine.encode_paths(paths)
        cosine = (feats * plain_feats).sum(1) / (np.linalg.norm(feats, axis=1) * np.linalg.norm(plain_feats, axis=1))
        log(f"    fused vs unfused tower features, per image cosine: {cosine.tolist()}")
        if not (cosine >= FEATURE_COSINE_MIN).all():
            raise AssertionError(f"feature cosine {cosine} < {FEATURE_COSINE_MIN}")

        # 6. text tower with flash -------------------------------------------------
        log("[6] BERT-base text tower: flash vs plain attention, same weights (fp32)")
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

        # 7. times -----------------------------------------------------------------
        log("[7] times (CUDA events, median of 10 after 3 warmup)")
        kernels = timing_phase(device, gen, peaks, stage_shapes, ffdm_shape, tokens, counts,
                               block_err, flash_err)
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
