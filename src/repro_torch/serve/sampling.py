"""The parts of ``jax.random`` the reference's serving calls, bit for bit.

The reference picks a sampled token with ``jax.random.categorical`` on a
threefry2x32 key: one engine-wide key split after every decode step in
the fixed loop, and ``fold_in(PRNGKey(request.seed), step)`` per lane in
the scheduler.  This module computes the same words in torch, without
JAX, as jax 0.9.0 computes them with its default
``jax_threefry_partitionable=True`` and 64-bit types off:

  * ``prng_key(seed)``: ``PRNGKey(seed)`` is ``[0, seed mod 2**32]`` (a
    Python int seed is taken as int64, narrowed to int32 and bit-cast;
    ``prng.py::threefry_seed``).
  * ``threefry2x32``: 20 rounds in 5 groups of 4, rotations (13, 15, 26, 6)
    and (17, 29, 16, 24) alternating, the key schedule ``k1, k2, k1 ^ k2 ^
    0x1BD11BDA`` injected after each group with the group's index added
    (``prng.py::_threefry2x32_lowering``).
  * ``fold_in(key, d)``: the hash of the counter pair ``(0, d mod
    2**32)``; ``split(key, n)``: the hash of ``(i >> 32, i & 0xffffffff)``
    for ``i < n``, key ``i`` the pair of outputs.
  * ``random_bits(key, shape, width)``: the partitionable counters, one
    per element of ``shape`` in row-major order split into high and low
    words (``iota_2x32_shape``), hashed; the word is ``bits1 ^ bits2``,
    its low ``width`` bits for a narrower width.
  * ``uniform``: the mantissa trick of ``random.py::_uniform`` (``nmant``
    random bits under the exponent of 1.0, minus 1, scaled and floored at
    ``minval``); a dtype of fewer than 8 mantissa bits (bf16) draws
    8-bit words.  ``gumbel``: mode "low", ``-log(-log(u))`` with ``u`` on
    ``[finfo.tiny, 1)``.  ``categorical``: ``argmax(gumbel + logits)``.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words; every
integer step runs in int64 masked to 32 bits (torch has no full uint32
arithmetic, and ``>>`` on int32 is arithmetic), so the card and the CPU
give the same words.  ``key[..., :]`` with leading dimensions is a batch
of keys, each drawing its own ``shape`` (``jax.vmap`` over the keys).
Nothing here synchronizes with the host.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# the bit pattern of 1.0 in each float dtype a pick may run in
_ONE_BITS = {torch.float32: 0x3F800000, torch.bfloat16: 0x3F80,
             torch.float16: 0x3C00}
_INT_VIEW = {32: torch.int32, 16: torch.int16}


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a host ``uint32[2]``."""
    return np.array([0, int(seed) & MASK32], np.uint32)


def key_tensor(keys, device=None) -> torch.Tensor:
    """Host keys (``uint32[..., 2]``) as the int64 tensor this module
    computes on."""
    return torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64)
                            ).to(device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block on broadcastable int64 tensors of uint32
    words: returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & MASK32
    x2 = (x2 + k2) & MASK32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(group + 1) % 3]) & MASK32
        x2 = (x2 + ks[(group + 2) % 3] + (group + 1)) & MASK32
    return x1, x2


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` of each key ``[..., 2]`` with the matching
    integer of ``data [...]`` (taken mod 2**32, as jax's uint32 cast)."""
    d = data.to(torch.int64) & MASK32
    a, b = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of one key ``[2]``: ``[num, 2]``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], i >> 32, i & MASK32)
    return torch.stack([a, b], dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int],
                width: int = 32) -> torch.Tensor:
    """``jax.random.bits`` of ``width`` (8, 16 or 32) bits and ``shape``
    for each key ``[..., 2]``: int64 words ``[..., *shape]``."""
    if width not in (8, 16, 32):
        raise ValueError(f"random_bits takes 8, 16 or 32 bits, got {width}")
    shape = tuple(int(s) for s in shape)
    batch = keys.shape[:-1]
    i = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=keys.device).reshape(shape)
    k1 = keys[..., 0].reshape(*batch, *([1] * len(shape)))
    k2 = keys[..., 1].reshape(*batch, *([1] * len(shape)))
    a, b = threefry2x32(k1, k2, i >> 32, i & MASK32)
    bits = a ^ b
    return bits if width == 32 else bits & ((1 << width) - 1)


def _float_layout(dtype: torch.dtype) -> Tuple[int, int]:
    """(bits, mantissa bits) of a float dtype the sampler draws in."""
    if dtype not in _ONE_BITS:
        raise ValueError(f"the sampler draws float32, bfloat16 or float16, "
                         f"got {dtype}")
    info = torch.finfo(dtype)
    return info.bits, int(round(-math.log2(info.eps)))


def uniform(keys: torch.Tensor, shape: Sequence[int], dtype: torch.dtype,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` on ``[minval, maxval)`` for each key."""
    nbits, nmant = _float_layout(dtype)
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(keys, shape, rng_bits)
    fbits = (bits >> (rng_bits - nmant)) | _ONE_BITS[dtype]
    floats = fbits.to(_INT_VIEW[nbits]).view(dtype) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=keys.device)
    hi = torch.tensor(maxval, dtype=dtype, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") for each key."""
    u = uniform(keys, shape, dtype, minval=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: one key ``[2]`` for
    all of ``logits``, or a batch of keys ``[*B, 2]`` each drawing its own
    rows (``jax.vmap(categorical)``).  Returns int64 indices."""
    batch = keys.dim() - 1
    g = gumbel(keys, logits.shape[batch:], logits.dtype)
    return torch.argmax(g + logits, dim=-1)
