"""PyTorch/CUDA port of mmgclip_tpu for one NVIDIA H100.

Mirrors the JAX package's module layout (``models/convnext.py`` here is the
counterpart of ``mmgclip_tpu/models/convnext.py``) and imports nothing of
it.  Hand-written CUDA kernels live in ``csrc/`` and are built at first use
(``ops/_build.py``).  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""
