"""The import guard: nothing the benchmark runs may load JAX or the JAX
package.  Top-level module names (the part before the first dot) are
compared whole, so ``mmgclip_tpu_torch`` is not ``mmgclip_tpu``."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmgclip_tpu")


def forbidden_loaded(module_names: Iterable[str]) -> List[str]:
    tops = {name.split(".", 1)[0] for name in module_names}
    return sorted(name for name in FORBIDDEN if name in tops)
