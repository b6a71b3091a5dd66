"""JAX's threefry PRNG in plain PyTorch (the counterpart of ``jax.random``
with ``jax_threefry_partitionable`` on, and of flax's ``make_rng``).

A key is an int64 tensor of shape ``[2]`` holding the two uint32 words
of ``jax.random.key_data``.  Every integer op runs on int64 holding uint32
values, masked with ``& 0xFFFFFFFF`` (torch has no uint32 shifts on the
CPU).  The semantics are jax 0.9's ``jax/_src/prng.py`` and
``jax/_src/random.py``:

* ``threefry2x32``: the 20-round Threefry-2x32 hash (``_threefry2x32_lowering``);
* ``split``: the counters are the row-major linear index as (hi, lo) words
  (``iota_2x32_shape``), the new keys the two hash words
  (``_threefry_split_foldlike``);
* ``fold_in``: the hash of the counter pair (0, data) (``_threefry_fold_in``
  over ``threefry_seed``);
* ``random_bits``: 32-bit output is the two hash words xor-ed
  (``_threefry_random_bits_partitionable``);
* ``uniform``: ``((bits >> 9) | 0x3F800000)`` as fp32, minus 1 (``_uniform``);
* ``bernoulli``: ``uniform < float32(p)`` (mode ``low``);
* ``fold_in_static``: flax's ``_fold_in_static``, the first four bytes of the
  SHA-1 of the scope suffix folded in (``flax_fix_rng_separator`` off).

These are the plain versions: the CPU path and the oracle of the kernels in
``ops/dropout.py``.  They run on any device.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000  # the bits of fp32 1.0


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words (x0, x1) under the key words
    (k0, k1); each an int or an int64 tensor of uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` with 64-bit types off:
    the seed as int32, so the words are (0, seed mod 2**32)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64, device=device)


def counters(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) words of the row-major linear index of each element of ``shape``."""
    index = torch.arange(math.prod(int(d) for d in shape), dtype=torch.int64, device=device)
    return (index >> 32).reshape(tuple(shape)), (index & MASK32).reshape(tuple(shape))


def split(key_: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` -> [n, 2]."""
    hi, lo = counters((n,), key_.device)
    b0, b1 = threefry2x32(key_[0], key_[1], hi, lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key_: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data`` -> [2]."""
    zero = torch.zeros((), dtype=torch.int64, device=key_.device)
    b0, b1 = threefry2x32(key_[0], key_[1], zero, zero + (int(data) & MASK32))
    return torch.stack([b0, b1])


def random_bits(key_: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values."""
    hi, lo = counters(shape, key_.device)
    b0, b1 = threefry2x32(key_[0], key_[1], hi, lo)
    return b0 ^ b1


def uniform(key_: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)``: 23 random mantissa bits
    under exponent 0, minus 1."""
    bits = random_bits(key_, shape)
    return ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key_: torch.Tensor, p: float, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode ``low``) as a bool tensor."""
    return uniform(key_, shape) < torch.tensor(p, dtype=torch.float32, device=key_.device)


def static_fold_constant(suffix: Sequence[Union[str, int]]) -> int:
    """The uint32 flax folds into a key for a static scope suffix: the first
    four bytes (big-endian) of the SHA-1 of the suffix's parts, strings as
    UTF-8 and ints as their minimal big-endian bytes."""
    digest = hashlib.sha1()
    for part in suffix:
        if isinstance(part, str):
            digest.update(part.encode("utf-8"))
        elif isinstance(part, int):
            digest.update(part.to_bytes((part.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"Expected int or string, got: {part!r}")
    return int.from_bytes(digest.digest()[:4], byteorder="big")


def fold_in_static(key_: torch.Tensor, suffix: Sequence[Union[str, int]]) -> torch.Tensor:
    """flax's ``_fold_in_static(key, suffix)``: the key unchanged for an
    empty suffix, else ``fold_in`` of its SHA-1 constant."""
    if not suffix:
        return key_
    return fold_in(key_, static_fold_constant(suffix))


def make_rng_constant(scope_path: Sequence[str], counter: int = 1) -> int:
    """The fold constant of flax's ``make_rng`` at ``scope_path`` (the module
    names from the applied root down) for its ``counter``-th call there:
    ``Dropout_0`` of a head applied on its own folds ``("Dropout_0", 1)``."""
    return static_fold_constant((*scope_path, int(counter)))
