"""Build the port's CUDA and host C sources and load them through ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` straight into its own shared
library with a plain C interface (no PyTorch headers, so no ninja and a build
of seconds), keyed on a hash of the source, the shared ``csrc/*.cuh`` headers
and the flags, under
``mmgclip_tpu_torch/_build/``.  Builds happen at first use, never at import,
and every source of a ``build_all`` call compiles in parallel.  The host C
sources (``HOST_SOURCES``: the PNG unfilter) are built the same way by ``cc``
(or ``gcc``) from ``$PATH``, keyed on the source and ``CC_FLAGS``, and the
host C++ sources (``CXX_SOURCES``: the ASCII WordPiece encoder) by ``c++``
(or ``g++``), keyed on the source and ``CXX_FLAGS``.

A failed build raises ``RuntimeError`` with the compiler's output: there is
no fallback that would hide it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
SOURCES = ("fused_block.cu", "flash_attention.cu", "fused_stem.cu", "fused_downsample.cu",
           "depthwise_conv.cu", "ring_all_gather.cu", "threefry_dropout.cu", "png_unfilter.cu",
           "moe_experts.cu", "mla_attention.cu", "kda.cu", "rms_norm.cu")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_SOURCES = ("png_unfilter.c",)
CC_FLAGS = ("-O3", "-std=c99", "-shared", "-fPIC")
CXX_SOURCES = ("wordpiece.cc",)
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}  # source -> nvcc/ptxas output of this process's build


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``$PATH`` or ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin); "
        "the port's CUDA kernels are built from source at first use")


def cc_path() -> str:
    """The host C compiler: ``cc`` or ``gcc`` from ``$PATH``."""
    for name in ("cc", "gcc"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no C compiler (cc or gcc) on $PATH; the port's PNG unfilter is built from "
        "source at first use")


def cxx_path() -> str:
    """The host C++ compiler: ``c++`` or ``g++`` from ``$PATH``."""
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no C++ compiler (c++ or g++) on $PATH; the port's WordPiece encoder is built "
        "from source at first use")


def _is_host(source: str) -> bool:
    return source in HOST_SOURCES or source in CXX_SOURCES


def _flags(source: str) -> tuple:
    if source in HOST_SOURCES:
        return CC_FLAGS
    return CXX_FLAGS if source in CXX_SOURCES else NVCC_FLAGS


def _library_path(source: str) -> str:
    """The library's path, keyed on the source, the shared headers and the flags."""
    host = _is_host(source)
    digest = hashlib.sha256(" ".join(_flags(source)).encode())
    headers = [] if host else sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            digest.update(fh.read())
    digest = digest.hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def _start_build(source: str) -> Tuple[subprocess.Popen, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    compiler = (cc_path() if source in HOST_SOURCES else cxx_path() if source in CXX_SOURCES
                else nvcc_path())
    cmd = [compiler, *_flags(source), "-o", tmp, os.path.join(CSRC_DIR, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(source: str, target: str, proc: subprocess.Popen, tmp: str) -> None:
    output, _ = proc.communicate()
    BUILD_LOGS[source] = output
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{proc.args[0]} failed on {source} (exit {proc.returncode}):\n{output}")
    os.replace(tmp, target)  # atomic: a reader never sees a half-written library


def build_all(sources: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build every missing library, all ``nvcc`` processes started together.

    Returns seconds per source (0.0 where the library was already built)."""
    with _LOCK:
        pending = {}
        seconds = {}
        start = time.perf_counter()
        for source in sources:
            target = _library_path(source)
            if os.path.isfile(target):
                seconds[source] = 0.0
            else:
                pending[source] = (target, *_start_build(source))
        errors = []
        for source, (target, proc, tmp) in pending.items():
            try:
                _finish_build(source, target, proc, tmp)
            except RuntimeError as exc:
                errors.append(str(exc))
            seconds[source] = time.perf_counter() - start
        if errors:
            raise RuntimeError("\n".join(errors))
        return seconds


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    build_all([source])
    with _LOCK:
        if source not in _LIBS:
            _LIBS[source] = ctypes.CDLL(_library_path(source))
        return _LIBS[source]


def load_typed(source: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """``load(source)`` with each entry point's ``argtypes`` set (each returns
    an int: a ``cudaError_t`` for a CUDA launcher, a status for host C) and,
    for a CUDA source, ``mmg_cuda_error_string`` typed."""
    lib = load(source)
    with _LOCK:
        if not getattr(lib, "_mmg_typed", False):
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            if not _is_host(source):
                lib.mmg_cuda_error_string.argtypes = [ctypes.c_int]
                lib.mmg_cuda_error_string.restype = ctypes.c_char_p
            lib._mmg_typed = True
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        message = lib.mmg_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({message})")
