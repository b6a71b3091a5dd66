"""The plain reference: float32 PyTorch and NumPy, TF32 off, written from the
architectures' published equations over the benchmark's own weight trees.

It imports neither JAX nor the JAX package nor anything of the port, and
takes nothing the port made: weights, pixels, token ids and batch order are
worked out here from what the benchmark generated.
"""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """TF32 off for matmuls and convolutions inside (``tf32=True``: on, the
    control one precision below float32); the flags are restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
