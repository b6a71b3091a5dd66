"""Time the flash attention, depthwise, fp / bf16 block, int8 block,
downsample and stem kernels of two checkouts on one card.

    python3 kernel_ab.py --parent <directory holding the other checkout> [--out <json>] [--only <text>]

Builds ``mmgclip_tpu_torch/csrc/{flash_attention,depthwise_conv,fused_block,
fused_downsample,fused_stem}.cu`` of the other checkout (unpacked with ``git archive``)
with this tree's ``nvcc`` flags and loads both trees' libraries through
ctypes, each tree's entry points typed by that tree's own ``_SIGNATURES``
(read from its ``ops/*.py`` source): ``mmg_fused_block`` and
``mmg_fused_block_int8`` gained a workspace pointer, so a block's call
passes one only where the tree's signature has it.  Each case is the main
path's work of a kernel, timed as device time per call of back-to-back
calls (``chip_smoke.device_ms``) in the order parent, change, change,
parent, on the same inputs and preallocated outputs:

* flash: the serving path's prompt-bank batch (b=28, s=32 after the pad
  trim) and BERT-base at b=8 s=256 with phase 7's lengths, fp32 and bf16;
* depthwise: the 18 convs of a 2 x 1024x832 bucket (depths 3/3/9/3), bf16
  and fp32, and the full-field stage-1 shape alone;
* block: the 18 fp / bf16 blocks of the same bucket, bf16 and fp32, and the
  full-field stage-1 shape alone;
* int8: the 18 int8 blocks of a 2 x 2294x1914 feature-store bucket, bf16
  and fp32, on weights quantised and packed once (both trees pack alike);
* downsample: the three downsamples of the same bucket, bf16 and fp32;
* stem: the stem of the same bucket (fp32 input, 3 -> 96) with bf16 and
  with fp32 weights, and the micro tower's (32 x 32x32x1 -> 8, bf16
  weights: phase 15's bucket).

The two trees' outputs are held against each other with chip_smoke's
tolerances (the int8 blocks' own term x + mlp - x within ``INT8_REL_TOL``;
the stem, whose input is fp32, within ``FP32_REL_TOL``).
One line per case is printed and all of them are written to ``--out``
(default ``outputs/kernel_ab.json``); ``--only`` keeps the cases whose label
contains the text.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PHASE7_LENGTHS = (256, 200, 31, 1, 256, 128, 77, 255)
DEPTHS = (3, 3, 9, 3)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


KERNELS = {  # source -> the ops module that registers its entry points
    "flash_attention.cu": "flash_attention",
    "depthwise_conv.cu": "depthwise_conv",
    "fused_block.cu": "fused_block",
    "fused_downsample.cu": "fused_downsample",
    "fused_stem.cu": "fused_stem",
}
EPS = 1e-6  # the block's LayerNorm epsilon (ops.fused_block.EPS)


def tree_signatures(root: str, module: str) -> dict:
    """``_SIGNATURES`` of ``mmgclip_tpu_torch/ops/<module>.py`` in the tree at
    ``root``, read from its source (the dict literal over _I, _P, _F)."""
    path = os.path.join(root, "mmgclip_tpu_torch", "ops", f"{module}.py")
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "_SIGNATURES"
                                                for t in node.targets):
            names = {"_I": ctypes.c_int, "_P": ctypes.c_void_p, "_F": ctypes.c_float, "ctypes": ctypes}
            return eval(compile(ast.Expression(node.value), path, "eval"), names)
    raise KeyError(f"no _SIGNATURES in {path}")


def typed(lib, signatures):
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def build_parent(parent: str, out_dir: str) -> dict:
    """The other checkout's libraries, built in parallel and typed."""
    from mmgclip_tpu_torch.ops import _build

    csrc = os.path.join(parent, "mmgclip_tpu_torch", "csrc")
    jobs = {}
    for source in KERNELS:
        target = os.path.join(out_dir, "lib" + source.replace(".cu", ".so"))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", target, os.path.join(csrc, source)]
        jobs[source] = (target, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    libs = {}
    for source, (target, proc) in jobs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {source}:\n{output}")
        libs[source] = typed(ctypes.CDLL(target), tree_signatures(parent, KERNELS[source]))
    return libs


def change_libs() -> dict:
    from mmgclip_tpu_torch.ops import _build

    return {source: _build.load_typed(source, tree_signatures(REPO, module))
            for source, module in KERNELS.items()}


def prompt_bank_lengths():
    """(s, [b] valid lengths) of the serving path's pad-trimmed prompt banks."""
    from mmgclip_tpu_torch.config import compose
    from mmgclip_tpu_torch.data.tokenizer import Tokenizer
    from mmgclip_tpu_torch.evaluation.report_cascade import BANK_ORDER, BANKS
    from mmgclip_tpu_torch.models.bert import trim_padded_tail

    cfg = compose(os.path.join(REPO, "configs"), "train_binary_class_clf",
                  ["networks=clip_convnext_fused_bert"])
    tok = Tokenizer.from_pretrained(cfg.tokenizer.config.tokenizer_name,
                                    sequence_length=int(cfg.tokenizer.config.sequence_length))
    prompts = [p for bank in BANK_ORDER for p in BANKS[bank]]
    mask = np.asarray(trim_padded_tail(tok(prompts, max_length=256), 32)["attention_mask"])
    return mask.shape[1], mask.sum(1).astype(np.int32)


def flash_items(s, lengths, dtype, rng, device):
    b = len(lengths)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, 12, s, 64)).astype(np.float32)).to(device, dtype)
               for _ in range(3))
    lens = torch.as_tensor(np.asarray(lengths, np.int32), device=device)
    return [((q, k, v, lens), torch.empty_like(q), 1)]


def depthwise_items(shapes_reps, dtype, rng, device):
    items = []
    for shape, reps in shapes_reps:
        c = shape[-1]
        args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * scale).to(device, dtype)
                for s, scale in ((shape, 1.0), ((7, 7, 1, c), 0.2), ((c,), 0.1))]
        items.append((tuple(args), torch.empty_like(args[0]), reps))
    return items


def block_items(shapes_reps, dtype, rng, device):
    """chip_smoke.block_params's scales, from numpy; + the fp32 workspace."""
    items = []
    for shape, reps in shapes_reps:
        c = shape[-1]

        def r(*s, scale=1.0, offset=0.0, dt=dtype):
            return torch.from_numpy((offset + rng.standard_normal(s) * scale).astype(np.float32)).to(device, dt)

        x = r(*shape)
        params = [r(7, 7, 1, c, scale=0.2), r(c, scale=0.1), r(c, scale=0.1, offset=1.0, dt=torch.float32),
                  r(c, scale=0.1, dt=torch.float32), r(c, 4 * c, scale=c ** -0.5), r(4 * c, scale=0.1),
                  r(4 * c, c, scale=(4 * c) ** -0.5), r(c, scale=0.1), r(c, scale=0.5)]
        ws = torch.empty((x.numel() // c, c), dtype=torch.float32, device=device)
        items.append(((x, *params, ws), torch.empty_like(x), reps))
    return items


def int8_items(shapes_reps, dtype, rng, device):
    """``block_items``'s inputs with the weights quantised and packed
    (``ops.fused_block.int8_weights``) in the entry point's order."""
    from mmgclip_tpu_torch.ops.fused_block import int8_weights

    items = []
    for (x, dwk, dwb, ns, nb, w1, b1, w2, b2, g, ws), out, reps in block_items(shapes_reps, dtype, rng,
                                                                              device):
        w1p, ws1, w2p, ws2 = int8_weights(w1, w2)
        items.append(((x, dwk, dwb, ns, nb, w1p, ws1, b1, w2p, ws2, b2, g, ws), out, reps))
    return items


def downsample_items(pairs, dtype, rng, device):
    """chip_smoke.glue_inputs's scales for [n, H, W, Cin] -> Cout, from numpy."""
    items = []
    for shape, cout in pairs:
        cin = shape[-1]

        def r(*s, scale=1.0, offset=0.0, dt=dtype):
            return torch.from_numpy((offset + rng.standard_normal(s) * scale).astype(np.float32)).to(device, dt)

        x = r(*shape)
        args = (x, r(cin, scale=0.1, offset=1.0, dt=torch.float32), r(cin, scale=0.1, dt=torch.float32),
                r(2, 2, cin, cout, scale=(4 * cin) ** -0.5), r(cout, scale=0.1))
        n, h, w, _ = shape
        items.append((args, torch.empty(n, -(-h // 2), -(-w // 2), cout, dtype=dtype, device=device), 1))
    return items


def stem_items(shape, cout, w_dtype, rng, device):
    """chip_smoke.glue_inputs's scales for the stem: fp32 x [n, H, W, Cin],
    weights [4, 4, Cin, Cout] and bias in ``w_dtype``, fp32 LN affine."""
    cin = shape[-1]

    def r(*s, scale=1.0, offset=0.0, dt=torch.float32):
        return torch.from_numpy((offset + rng.standard_normal(s) * scale).astype(np.float32)).to(device, dt)

    args = (r(*shape), r(4, 4, cin, cout, scale=(16 * cin) ** -0.5, dt=w_dtype), r(cout, scale=0.1, dt=w_dtype),
            r(cout, scale=0.1, offset=1.0), r(cout, scale=0.1))
    n, h, w, _ = shape
    return [(args, torch.empty(n, -(-h // 4), -(-w // 4), cout, device=device), 1)]


def launcher(kind, lib):
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "flash":
        def call(args, out):
            q, k, v, lens = args
            b, h, s, d = q.shape
            return lib.mmg_flash_attention(DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                                           v.data_ptr(), lens.data_ptr(), out.data_ptr(), b, h, s,
                                           d, 1.0 / math.sqrt(d), stream)
    elif kind == "depthwise":
        def call(args, out):
            x, w, b = args
            n, h, wd, c = x.shape
            return lib.mmg_depthwise_conv7x7(DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
                                             b.data_ptr(), out.data_ptr(), n, h, wd, c, stream)
    elif kind == "downsample":
        def call(args, out):
            x, ns, nb, k, b = args
            n, h, wd, cin = x.shape
            return lib.mmg_fused_downsample(DTYPE_CODES[x.dtype], x.data_ptr(), ns.data_ptr(),
                                            nb.data_ptr(), k.data_ptr(), b.data_ptr(), out.data_ptr(),
                                            n, h, wd, cin, k.shape[-1], EPS, stream)
    elif kind == "stem":
        def call(args, out):
            x, k, b, ns, nb = args
            n, h, wd, cin = x.shape
            return lib.mmg_fused_stem(DTYPE_CODES[x.dtype], DTYPE_CODES[k.dtype], x.data_ptr(), k.data_ptr(),
                                      b.data_ptr(), ns.data_ptr(), nb.data_ptr(), out.data_ptr(), n, h, wd,
                                      cin, k.shape[-1], EPS, stream)
    else:
        # the parents' entry points have no workspace
        entry = lib.mmg_fused_block_int8 if kind == "int8" else lib.mmg_fused_block
        with_ws = len(entry.argtypes) == (22 if kind == "int8" else 20)

        def call(args, out):
            *tensors, ws = args
            n, h, wd, c = tensors[0].shape
            ptrs = [t.data_ptr() for t in tensors] + [out.data_ptr()] + ([ws.data_ptr()] if with_ws else [])
            return entry(DTYPE_CODES[tensors[0].dtype], *ptrs, n, h, wd, c, EPS, 0, stream)

    def work(items):
        for args, out, reps in items:
            for _ in range(reps):
                code = call(args, out)
                if code != 0:
                    raise RuntimeError(f"{kind} launch failed: CUDA error {code}")
    return work


def agree(kind, dtype, a, b, x):
    """The two trees' outputs within chip_smoke's kernel-vs-plain tolerance
    (the int8 block's own term: x dominates x + mlp)."""
    from chip_smoke import BF16_REL_TOL, FLASH_FP32_ABS_TOL, FP32_REL_TOL, INT8_REL_TOL

    if kind == "int8":
        a, b = a.float() - x.float(), b.float() - x.float()
    err = (a.float() - b.float()).abs().max().item()
    scale = b.float().abs().max().item()
    if kind == "int8":
        return err, err <= INT8_REL_TOL * scale
    if kind == "stem":  # fp32 input, whatever the weights
        return err, err <= FP32_REL_TOL * scale
    if dtype == torch.bfloat16:
        return err, err <= BF16_REL_TOL * scale
    if kind == "flash":
        return err, err <= FLASH_FP32_ABS_TOL
    return err, err <= FP32_REL_TOL * scale


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, help="root of the other checkout")
    parser.add_argument("--out", default=os.path.join(REPO, "outputs", "kernel_ab.json"))
    parser.add_argument("--only", default="", help="run only the cases whose label contains this")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", flush=True)
        return 1
    from chip_smoke import FFDM_SHAPES, PAIR_HW, device_ms, log, stage_shapes_of

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        parent = build_parent(os.path.abspath(args.parent), tmp)
        change = change_libs()
        s_bank, bank_lengths = prompt_bank_lengths()
        bucket = stage_shapes_of(2, *PAIR_HW)
        ffdm = stage_shapes_of(1, *FFDM_SHAPES[0])[0]
        rng = np.random.default_rng(0)
        cases = []
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((f"flash prompt banks b={len(bank_lengths)} s={s_bank}", "flash", dtype,
                          flash_items(s_bank, bank_lengths, dtype, rng, device)))
            cases.append(("flash b=8 s=256 phase-7 lengths", "flash", dtype,
                          flash_items(256, PHASE7_LENGTHS, dtype, rng, device)))
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"depthwise 18 convs of 2x{PAIR_HW[0]}x{PAIR_HW[1]}", "depthwise", dtype,
                          depthwise_items(list(zip(bucket, DEPTHS)), dtype, rng, device)))
        cases.append((f"depthwise stage 1 {ffdm}", "depthwise", torch.bfloat16,
                      depthwise_items([(ffdm, 1)], torch.bfloat16, rng, device)))
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"block 18 blocks of 2x{PAIR_HW[0]}x{PAIR_HW[1]}", "block", dtype,
                          block_items(list(zip(bucket, DEPTHS)), dtype, rng, device)))
        cases.append((f"block stage 1 {ffdm}", "block", torch.bfloat16,
                      block_items([(ffdm, 1)], torch.bfloat16, rng, device)))
        store = stage_shapes_of(2, *FFDM_SHAPES[0])
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"int8 18 blocks of 2x{FFDM_SHAPES[0][0]}x{FFDM_SHAPES[0][1]}", "int8", dtype,
                          int8_items(list(zip(store, DEPTHS)), dtype, rng, device)))
            cases.append((f"downsample 3 of 2x{FFDM_SHAPES[0][0]}x{FFDM_SHAPES[0][1]}", "downsample",
                          dtype, downsample_items([(s, d[-1]) for s, d in zip(store, store[1:])], dtype,
                                                  rng, device)))
        for dtype in (torch.bfloat16, torch.float32):
            cases.append((f"stem of 2x{FFDM_SHAPES[0][0]}x{FFDM_SHAPES[0][1]}x3 -> 96, fp32 x", "stem", dtype,
                          stem_items((2, *FFDM_SHAPES[0], 3), 96, dtype, rng, device)))
        cases.append(("stem micro tower 32x32x32x1 -> 8, fp32 x", "stem", torch.bfloat16,
                      stem_items((32, 32, 32, 1), 8, torch.bfloat16, rng, device)))

        rows = []
        for label, kind, dtype, items in [c for c in cases if args.only in c[0]]:
            source = {"flash": "flash_attention.cu", "depthwise": "depthwise_conv.cu",
                      "block": "fused_block.cu", "int8": "fused_block.cu",
                      "downsample": "fused_downsample.cu", "stem": "fused_stem.cu"}[kind]
            runs = {"parent": launcher(kind, parent[source]), "change": launcher(kind, change[source])}
            outs = {}
            for tree, run in runs.items():  # one checked call each: the outputs to compare
                run(items)
                outs[tree] = items[-1][1].clone()
            torch.cuda.synchronize()
            err, ok = agree(kind, dtype, outs["change"], outs["parent"], items[-1][0][0])
            if not ok:
                raise AssertionError(f"{label} {dtype}: the two trees differ by {err}")
            times = {tree: device_ms(lambda: runs[tree](items), calls=10)
                     for tree in ("parent", "change")}
            second = {tree: device_ms(lambda: runs[tree](items), calls=10)
                      for tree in ("change", "parent")}
            row = {"case": label, "dtype": str(dtype)[6:],
                   "parent_ms": [times["parent"], second["parent"]],
                   "change_ms": [times["change"], second["change"]], "max_abs_diff": err}
            row["ratio"] = float(np.mean(row["change_ms"]) / np.mean(row["parent_ms"]))
            rows.append(row)
            log(f"{label} {row['dtype']}: parent {row['parent_ms'][0]:.5f} / {row['parent_ms'][1]:.5f} ms, "
                f"change {row['change_ms'][0]:.5f} / {row['change_ms'][1]:.5f} ms "
                f"(order parent, change, change, parent; device time per call of the work), "
                f"change / parent {row['ratio']:.4f}, outputs differ by {err:.3e}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": smi, "cases": rows}, fh, indent=1)
    log(json.dumps({"card": smi, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
