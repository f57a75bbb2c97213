"""The piece of ``jax.random`` the walks use, in PyTorch, bit for bit.

The reference keys its walks with ``jax.random`` on the default
``threefry2x32`` implementation with ``jax_threefry_partitionable`` on
(jax 0.9.0's defaults) and 32-bit ints, so this module copies that
algorithm (``jax/_src/prng.py``: ``threefry_seed``, ``threefry_2x32``,
``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``:
``_randint``, ``_uniform``, ``_normal_real``).

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words;
every function is vectorised over the leading dims (a shaped draw takes
one key).  ``normal`` is ``sqrt(2) * erfinv(u)`` of a bitwise uniform
draw; ``torch.erfinv`` is not XLA's f32 polynomial, so its values differ
from jax's in the last bits.  uint32 arithmetic is
done in int64 and masked with ``& 0xFFFFFFFF`` (``torch.uint32`` lacks
shifts and ``%`` on some backends).  Counts are the partitionable scheme's
``iota_2x32_shape``: element ``i`` of a flat sample uses the count pair
``(i >> 32, i & mask)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

__all__ = ["key", "fold_in", "split", "random_bits", "randint", "uniform",
           "normal", "threefry_2x32"]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry_2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the count pairs ``(x1, x2)``
    under the key words ``(k1, k2)``; broadcasts; int64 words in, int64
    words out."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def _words(k: torch.Tensor):
    return k[..., 0], k[..., 1]


def key(seed: int, *, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` with 32-bit ints: ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of each key with ``data`` (an int, or a
    tensor broadcasting against the keys' leading dims), taken mod 2**32
    as jax takes it to uint32."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK
    k1, k2 = _words(k)
    b1, b2 = threefry_2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def _counts(n: int, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)``: ``(..., num, 2)`` keys."""
    hi, lo = _counts(num, k.device)
    k1, k2 = _words(k)
    b1, b2 = threefry_2x32(k1[..., None], k2[..., None], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(k: torch.Tensor, num: int = 0) -> torch.Tensor:
    """32-bit ``jax.random.bits``: one word per key (``num=0``, jax's
    shape ``()``), or ``num`` words per key as ``(..., num)``."""
    k1, k2 = _words(k)
    if num == 0:
        zero = torch.zeros_like(k1)
        b1, b2 = threefry_2x32(k1, k2, zero, zero)
    else:
        hi, lo = _counts(num, k.device)
        b1, b2 = threefry_2x32(k1[..., None], k2[..., None], hi, lo)
    return b1 ^ b2


def randint_words(k: torch.Tensor):
    """The two random words ``jax.random.randint`` draws for one int32
    sample per key: ``random_bits`` of the two halves of ``split(k)``."""
    halves = split(k)
    return random_bits(halves[..., 0, :]), random_bits(halves[..., 1, :])


def randint_from_words(higher: torch.Tensor, lower: torch.Tensor, lo, hi):
    """``_randint``'s arithmetic for int32 on drawn words: ``lo + (higher
    * 2**32 + lower) mod span`` the way jax computes it in uint32 (its
    ``2**32 mod span`` multiplier wraps to 0 for spans above 2**16), with
    ``span = 1`` where ``hi <= lo``.  int32 result."""
    lo = torch.as_tensor(lo, dtype=torch.int64, device=higher.device)
    hi = torch.as_tensor(hi, dtype=torch.int64, device=higher.device)
    span = torch.where(hi <= lo, 1, (hi - lo) & MASK)
    mult = (((2**16 % span) ** 2) & MASK) % span
    off = (((higher % span) * mult) & MASK) + lower % span
    off = (off & MASK) % span
    out = (lo + off) & MASK
    return (out - ((out >> 31) << 32)).to(torch.int32)


def randint(k: torch.Tensor, lo, hi, shape=()) -> torch.Tensor:
    """``jax.random.randint(k, shape, lo, hi, jnp.int32)``.  With ``shape
    ()``, one sample for each key, ``lo``/``hi`` int32 ints or tensors
    broadcasting against the keys' leading dims; with a shape, ``k`` is
    one key."""
    if not shape:
        return randint_from_words(*randint_words(k), lo, hi)
    n = math.prod(shape)
    halves = split(k)
    return randint_from_words(random_bits(halves[0], n),
                              random_bits(halves[1], n), lo,
                              hi).reshape(shape)


def uniform(k: torch.Tensor, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, jnp.float32, minval, maxval)`` for one
    key: 23 random mantissa bits under the exponent of 1.0, less 1, scaled
    and shifted in f32."""
    bits = random_bits(k, math.prod(shape))
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    out = (floats - 1.0) * (hi - lo) + lo
    return torch.maximum(lo, out.reshape(shape))


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(k, shape, jnp.float32)`` for one key:
    ``sqrt(2) * erfinv(u)``, ``u`` uniform on ``[nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return float(np.float32(np.sqrt(2))) * torch.erfinv(u)
