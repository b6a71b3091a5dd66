"""Time variants of the stem kernel side by side on one card.

    python3 stem_sweep.py [--out <json>]

Each variant is ``mmgclip_tpu_torch/csrc/fused_stem.cu`` with one part
taken out or one choice forced, by textual substitutions that must match
as often as stated; all variants are built in parallel with ``ops/_build``'s
nvcc flags and run on the same inputs, the stem of a 2 x 2294x1914 feature-
store bucket (fp32 x, 3 -> 96) with bf16 and with fp32 weights:

* ``base``: the source as it is;
* ``nostore``: no output stores (the LN'd values are dropped);
* ``nomma``: no ``mma`` (the copies, the A fragments, the LN and the stores stay);
* ``uncapped``: no register cap (``__launch_bounds__`` without a CTA count);
* ``guarded``: Cout = 96 through the kernel that guards every column;
* ``tile32``: tiles of 32 output pixels, 2 warps a CTA.

The variants that take a part out give wrong outputs: their error against
``plain_stem`` is printed only to show it.  Each variant's registers and
spills for the Cout = 96 kernels come from ptxas.  Times are device time per
call of back-to-back calls (``chip_smoke.device_ms``).  Needs one CUDA card
and nvcc.
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

from chip_smoke import device_ms, rel_err  # noqa: E402

VARIANTS = {  # name -> [(pattern, replacement, matches)]
    "base": [],
    "nostore": [(r"if \(row < rows && \(FULL \|\| vcol < cout\)\)", "if (row < 0)", 1),
                (r"if \(!stored && rows > 0\) \{", "if (false) {", 1)],
    "nomma": [(r"mma_bf16\(acc\[blk\], a, b\.x, b\.y\);", "", 1),
              (r"mma_3xtf32\(st, ahi, alo, bh0, bh1, bl0, bl1\);", "", 1)],
    "uncapped": [(r"__launch_bounds__\(THREADS, NB <= 12 \? 16 / WARPS : 1\)", "__launch_bounds__(THREADS)", 1)],
    "guarded": [(r"if \(cout == 96\) return run<TX, TW, 12, true>", "if (cout == 96) return run<TX, TW, 12, false>", 1)],
    "tile32": [(r"constexpr int WARPS = 4;", "constexpr int WARPS = 2;", 1)],
}
SHAPE, COUT = (2, 2294, 1914, 3), 96


def variant_source(text: str, name: str) -> str:
    for pattern, replacement, count in VARIANTS[name]:
        text, n = re.subn(pattern, replacement, text)
        if n != count:
            raise RuntimeError(f"variant {name}: {pattern!r} matched {n} times")
    return text


def registers(ptxas: str, full: bool) -> list:
    """(registers, spill bytes) of each Cout = 96 kernel (NB = 12, FULL or not)."""
    tag = "Li12ELb1E" if full else "Li12ELb0E"
    lines = ptxas.splitlines()
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and tag in line:
            text = " ".join(lines[i:i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            found.append((int(regs.group(1)) if regs else None, int(spill.group(1)) if spill else None))
    return found


def build(out_dir: str) -> dict:
    """Every variant's library, built in parallel and typed, with its ptxas report."""
    from mmgclip_tpu_torch.ops import _build
    from mmgclip_tpu_torch.ops import fused_stem as fs

    with open(os.path.join(_build.CSRC_DIR, "fused_stem.cu")) as fh:
        text = fh.read()
    jobs = {}
    for name in VARIANTS:
        source = os.path.join(out_dir, f"fused_stem_{name}.cu")
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
        for fn, argtypes in fs._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.mmg_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, registers(output, full=name != "guarded"))
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="write every row as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("stem_sweep.py needs a CUDA card", file=sys.stderr)
        return 1
    from mmgclip_tpu_torch.ops import fused_stem as fs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    n, h, w, cin = SHAPE
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for name, (_lib, regs) in libs.items():
            print(f"{name}: (registers, spill bytes) of the Cout = 96 kernels {regs}", flush=True)
        x = torch.randn(*SHAPE, generator=gen).to(device)
        for w_dtype in (torch.bfloat16, torch.float32):
            k = (torch.randn(4, 4, cin, COUT, generator=gen) * (16 * cin) ** -0.5).to(device, w_dtype)
            b = (0.1 * torch.randn(COUT, generator=gen)).to(device, w_dtype)
            ns = (1 + 0.1 * torch.randn(COUT, generator=gen)).to(device)
            nb = (0.1 * torch.randn(COUT, generator=gen)).to(device)
            ref = fs.plain_stem(x, k, b, ns, nb)
            out = torch.empty_like(ref)
            cells = []
            for name, (lib, regs) in libs.items():
                def call(lib=lib):
                    return lib.mmg_fused_stem(0, fs._DTYPES[w_dtype], x.data_ptr(), k.data_ptr(), b.data_ptr(),
                                              ns.data_ptr(), nb.data_ptr(), out.data_ptr(), n, h, w, cin, COUT,
                                              fs.EPS, stream)

                out.zero_()
                rc = call()
                torch.cuda.synchronize()
                if rc:
                    raise RuntimeError(f"{name}: {lib.mmg_cuda_error_string(rc)}")
                _, rel = rel_err(out, ref)
                ms = device_ms(call)
                rows.append({"variant": name, "shape": list(SHAPE), "cout": COUT, "w_dtype": str(w_dtype)[6:],
                             "ms": ms, "rel_err": rel, "registers_spills": regs, "card": smi})
                cells.append(f"{name} {ms:.4f} (rel {rel:.1e})")
            print(SHAPE, f"-> {COUT}, fp32 x, {str(w_dtype)[6:]} weights:", " | ".join(cells), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
