"""The feature store: ``ImageFeatureExtractor.extract()`` over full-field PNGs.

Set-up writes ``images`` seeded phantom PNGs (``data/phantom.py``: 16-bit,
Paeth rows, zlib ``zlib_level``) and the tower's weight file, builds the
extractor with its defaults (``batch_size``; 8 decode threads) over the
cell's cards, and runs one pass to build and warm every kernel at the
images' one shape.  The window runs whole passes over the same files, each
into its own export directory, until ``--seconds`` have passed:
``store_img_per_s`` is the images written over the seconds of those passes.
A traced run profiles the first ``trace_passes`` passes, one profiler
session each, so that the trace's windows hold exactly the passes its
readings count (starting the profiler takes seconds on the card).
Afterwards a seeded sample of (pass, image) features is read back and
compared with the plain float32 tower on the source pixels
(``check_images`` images, at least one from the last pass).
"""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np

from ..data.phantom import phantom, write_phantoms
from . import common


def run(ctx):
    import torch

    from mmgclip_tpu_torch.ingest.encode import ImageFeatureExtractor
    from mmgclip_tpu_torch.ops import launch_counts, reset_launch_counts

    from ..reference import precision
    from ..reference.convnext import ConvNeXt
    from ..run import Check, Result

    tr, cfg_json = ctx.traffic, ctx.config
    common.set_precision(cfg_json)
    device = ctx.devices[0]
    n, hw = int(tr["images"]), (int(tr["height"]), int(tr["width"]))
    with ctx.spans.span("setup.images"):
        paths = write_phantoms(os.path.join(ctx.workdir, "images"), ctx.seed, n, *hw,
                               tr["tissue_share"], tr["bits"], tr["zlib_level"])
    with ctx.spans.span("setup.weights"):
        weight_file = os.path.join(ctx.workdir, "convnext.npz")
        tree = common.convnext_weights(cfg_json, ctx.seed, device, weight_file)
    cfg = common.compose(cfg_json, ctx.workdir, [
        f"networks.image_encoder.convnext_tiny_clf_path={weight_file}",
        f"base.features_export_dir={os.path.join(ctx.workdir, 'store', 'warm')}"])
    extractor = ImageFeatureExtractor(cfg, dataset=[{"image_path": p} for p in paths],
                                      batch_size=int(tr["batch_size"]), device=ctx.devices)
    with ctx.spans.span("setup.warm"):
        extractor.extract()
    if device != "cpu":
        torch.cuda.synchronize()

    ctx.window_started()
    passes = []
    launches = 0
    with ctx.spans.span("window"):
        t0 = time.perf_counter()
        while True:
            k = len(passes)
            traced = ctx.tracing and k < int(tr["trace_passes"])
            if traced:  # one profiler session a pass
                ctx.trace.start()
                reset_launch_counts()
            extractor.export_dir = os.path.join(ctx.workdir, "store", f"pass{k}")
            t_pass = time.perf_counter()
            with ctx.spans.span("store.extract"):
                count = extractor.extract()
            passes.append({"count": count, "seconds": time.perf_counter() - t_pass,
                           "traced": traced, **extractor.timings})
            if traced:
                launches += launch_counts().get("fused_convnext_block", 0)
                ctx.trace.stop()
            elapsed = time.perf_counter() - t0
            if elapsed >= ctx.seconds:
                window_s = elapsed
                break
    written = sum(p["count"] for p in passes)
    # each pass's time and decode wait: where a run's rate moved from another's
    print("store passes (s / decode wait s): "
          + " ".join(f"{p['seconds']:.3f}/{p['decode_wait_s']:.3f}" for p in passes),
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    readings = {}
    traced = [p for p in passes if p["traced"]]
    if traced:
        readings = {
            "images": sum(p["count"] for p in traced),
            "pass_counts": [p["count"] for p in traced],
            "passes_s": sum(p["seconds"] for p in traced),
            "decode_wait_s": sum(p["decode_wait_s"] for p in traced),
            "block_launches": launches,
            "image_hw": hw, "batch_size": int(tr["batch_size"]),
            "in_channels": int(cfg_json["image_tower"]["in_channels"]),
            "depths": cfg_json["image_tower"]["depths"], "dims": cfg_json["image_tower"]["dims"],
        }

    # the port's state goes before the reference runs on the card
    del extractor
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    chosen = common.sample(ctx.seed, n, int(tr["check_images"]), salt=1)
    which = np.random.default_rng([ctx.seed, 2]).integers(0, len(passes), size=len(chosen))
    which[-1] = len(passes) - 1
    worst = 0.0
    missing = 0
    with precision(tf32=False):
        reference = ConvNeXt(tree, device)
        for index, k in zip(chosen, which):
            rel = os.path.relpath(paths[index], os.path.join(ctx.workdir, "images", "2D_100micron"))
            stored = os.path.join(ctx.workdir, "store", f"pass{k}", rel).replace(".png", ".npy")
            if not os.path.isfile(stored):
                missing += 1
                continue
            ref = reference.features(phantom(ctx.seed, index, *hw, tr["tissue_share"], tr["bits"]))
            worst = max(worst, common.one_minus_cos(np.load(stored), ref.cpu().numpy()))
    limits = tr["limits"]
    checks = [Check("feature_1mcos_max", worst, limits["feature_1mcos_max"]),
              Check("unwritten_images", float(n * len(passes) - written + missing), 0.0)]
    return Result(e2e={"store_img_per_s": written / window_s},
                  attempted=n * len(passes), failed=n * len(passes) - written,
                  memory_peak_bytes=peak, checks=checks, readings=readings)
