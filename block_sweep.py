"""Time variants of the fp / bf16 block's ``ln_mlp`` kernel side by side on one card.

    python3 block_sweep.py [--out <json>]

Each variant is ``mmgclip_tpu_torch/csrc/fused_block.cu`` with one part
taken out or one choice forced, by textual substitutions that must match
(once, or once in each of the bf16 and fp32 routes); all variants are built in parallel with ``ops/_build``'s nvcc
flags and run on the same inputs and the same fp32 workspace (the depthwise
front half, computed once):

* ``base``: the source as it is;
* ``nosplit``: no cluster split of the hidden units (one CTA a row tile);
* ``noload``: the weight tiles after the first stages are never copied;
* ``nocompute``: no ``mma`` (the LN, the GELU, the copies and the epilogue stay);
* ``nogelu``: the GELU left out (b1 only);
* ``noln``: the LN left out (the A tile is not written).

The variants that take a part out give wrong outputs: their error against
``plain_convnext_block`` is printed only to show it.  Times are device time
per call of back-to-back calls (``chip_smoke.device_ms``); the totals weigh
the stage shapes by ConvNeXt-Tiny's depths (3, 3, 9, 3), the 18 blocks of a
2 x 1024x832 encode.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from chip_smoke import block_params, device_ms, rel_err  # noqa: E402

VARIANTS = {
    "base": [],
    "nosplit": [(r"p\.split = pick_split\([^;]*;", "p.split = 1;")],
    "noload": [(r"    if \(tile \+ p\.stages - 1 < tiles\) load\(tile \+ p\.stages - 1\);\n", "")],
    "nocompute": [(r"for \(int kk = 0; kk < rows; kk \+= KSTEP\)", "for (int kk = 0; kk < 0; kk += KSTEP)")],
    "nogelu": [(r"round_to<T>\(gelu\((acc1\[blk\]\[2 \* half(?: \+ 1)?\] \+ bj[01]), gelu_tanh\)\)",
                r"round_to<T>(\1)")],
    "noln": [(r"  if \(c <= 64 \* 3\) \{", "  if (c < 0) {"),
             (r"\} else if \(c <= 64 \* 12\) \{", "} else if (c < 0) {"),
             (r"for \(int r = warp; r < bm; r \+= nwarps\) \{\n      const long long pix = pix0 \+ r;",
              "for (int r = warp; r < 0; r += nwarps) {\n      const long long pix = pix0 + r;")],
}
# a pattern may match more than once where the same line stands in the bf16 and fp32 routes
REPEATS = {"nocompute": 2, "nogelu": 2}
STAGES = [((2, 256, 208, 96), 3), ((2, 128, 104, 192), 3), ((2, 64, 52, 384), 9), ((2, 32, 26, 768), 3)]
EXTRA = [(1, 574, 479, 96), (32, 1, 1, 768)]


def variant_source(text: str, name: str) -> str:
    for pattern, replacement in VARIANTS[name]:
        text, n = re.subn(pattern, replacement, text)
        if n != REPEATS.get(name, 1):
            raise RuntimeError(f"variant {name}: {pattern!r} matched {n} times")
    return text


def build(out_dir: str) -> dict:
    """Every variant's library, built in parallel and typed."""
    from mmgclip_tpu_torch.ops import _build
    from mmgclip_tpu_torch.ops import fused_block as fb

    with open(os.path.join(_build.CSRC_DIR, "fused_block.cu")) as fh:
        text = fh.read()
    jobs = {}
    for name in VARIANTS:
        source = os.path.join(out_dir, f"fused_block_{name}.cu")
        with open(source, "w") as fh:
            fh.write(variant_source(text, name))
        target = os.path.join(out_dir, f"lib_{name}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o", target, source]
        jobs[name] = (target, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (target, proc) in jobs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{output[-4000:]}")
        lib = ctypes.CDLL(target)
        for fn, argtypes in fb._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.mmg_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="write every row as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("block_sweep.py needs a CUDA card", file=sys.stderr)
        return 1
    from mmgclip_tpu_torch.ops import fused_block as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows, totals = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for dtype in (torch.bfloat16, torch.float32):
            for shape, reps in STAGES + [(s, 0) for s in EXTRA]:
                n, h, w, c = shape
                x = torch.randn(*shape, generator=gen).to(device, dtype)
                p = block_params(c, dtype, gen, device)
                ref = fb.plain_convnext_block(x, *p)
                ws = torch.empty((n * h * w, c), dtype=torch.float32, device=device)
                ptrs = [t.data_ptr() for t in (x, *p)]
                code = fb._DTYPES[dtype]
                if libs["base"].mmg_fused_block_depthwise(code, *ptrs[:3], ws.data_ptr(), n, h, w, c,
                                                          stream):
                    raise RuntimeError("depthwise half failed")
                cells = []
                for name, lib in libs.items():
                    out = torch.empty_like(x)

                    def call(lib=lib, out=out):
                        return lib.mmg_fused_block_ln_mlp(code, ws.data_ptr(), ptrs[0], *ptrs[3:],
                                                          out.data_ptr(), n, h, w, c, fb.EPS, 0, stream)

                    rc = call()
                    torch.cuda.synchronize()
                    if rc:
                        raise RuntimeError(f"{name} {shape}: {lib.mmg_cuda_error_string(rc)}")
                    _, rel = rel_err(out, ref)
                    first = out.clone()
                    call()
                    torch.cuda.synchronize()
                    ms = device_ms(call)
                    row = {"variant": name, "shape": list(shape), "dtype": str(dtype)[6:], "ms": ms,
                           "rel_err": rel, "repeats_bits": torch.equal(first, out), "card": smi}
                    rows.append(row)
                    cells.append(f"{name} {ms:.4f} (rel {rel:.1e}"
                                 f"{'' if row['repeats_bits'] else ', bits differ'})")
                    totals[(name, row["dtype"])] = totals.get((name, row["dtype"]), 0.0) + reps * ms
                print(shape, str(dtype)[6:], " | ".join(cells), flush=True)
    for (name, dtype), ms in totals.items():
        print(f"18 ln_mlp halves of 2 x 1024x832, {dtype}, {name}: {ms:.4f} ms", flush=True)
        rows.append({"variant": name, "dtype": dtype, "eighteen_blocks_ms": ms, "card": smi})
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
