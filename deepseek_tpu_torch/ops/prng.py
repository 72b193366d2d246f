"""The ``jax.random`` calls of the JAX package's decode loop, bit for bit.

The JAX package draws its sampling noise from threefry2x32 keys
(``jax.random.PRNGKey``/``split``/``categorical``, JAX 0.9 with
``jax_threefry_partitionable`` on). This module computes the same keys and
the same uniform floats, so the port's on-device sampler picks the JAX
package's tokens at the same seed:

- ``PRNGKey(seed)``: the raw pair (0, seed mod 2^32), as JAX builds it
  without 64-bit mode;
- ``split(key, num)``: ``jax/_src/prng.py::_threefry_split_foldlike``, the
  hash of the counters (0, i), i < num;
- ``random_bits(key, shape)``: ``_threefry_random_bits_partitionable`` at
  32 bits, ``bits1 ^ bits2`` over the counters (0, i), i the flat index;
- ``uniform(key, shape, minval)`` on [minval, 1): the mantissa trick of
  ``jax/_src/random.py::_uniform``;
- ``gumbel(key, shape)``: ``-log(-log(u))``, the ``mode="low"`` branch.

The hash runs on int64 tensors (or numpy arrays, or Python ints) masked to
32 bits, not on ``torch.uint32``, whose shift, rotate and add ops are not
covered alike across torch builds. A key is a numpy (2,) uint32 array: the
key chain depends on nothing the device computes, so it stays on the host
and only the vocabulary-wide noise is made on the device.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)
_SPAN = float(np.float32(1.0) - np.float32(_TINY))     # maxval - minval in f32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds, ``jax/_src/prng.py::
    _threefry2x32_lowering``) of the counter pairs (x1, x2) under the key
    (k1, k2). Operands are ints, int64 numpy arrays or int64 tensors with
    values in [0, 2^32); the results likewise."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as its raw (2,) uint32 data."""
    return np.array([0, int(seed) & _M32], np.uint32)


def split(key: np.ndarray, num: int = 2):
    """``jax.random.split(key, num)`` -> a tuple of ``num`` (2,) uint32
    keys, key i the hash of the counter (0, i) (the default 2: (key,
    subkey))."""
    k1, k2 = int(key[0]), int(key[1])
    return tuple(np.array(threefry2x32(k1, k2, 0, i), np.uint32) for i in range(num))


def random_bits(keys, shape, device="cpu") -> torch.Tensor:
    """32 random bits per element, as ``jax.random.bits(key, shape)``, in an
    int64 tensor. ``keys`` is one (2,) key or a stack (n, 2), which gives
    (n, *shape): one draw per key."""
    keys = np.asarray(keys, np.uint32)
    lead = keys.shape[:-1]
    # a non-blocking copy: the decode block does not synchronize
    k = torch.from_numpy(keys.reshape(-1, 2).astype(np.int64)).to(
        device, non_blocking=True)
    k1, k2 = k[:, :1], k[:, 1:]                      # (n, 1) each
    size = int(np.prod(shape, dtype=np.int64))
    if size >= 1 << 32:
        raise ValueError(f"random_bits of {size} elements: the high counter "
                         "word is not ported")
    lo = torch.arange(size, dtype=torch.int64, device=device)[None, :]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(*lead, *shape)


def uniform(keys, shape, device="cpu", minval: float = _TINY) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval=1)``: the
    top 23 bits under the exponent of 1.0, minus 1, scaled and floored at
    minval as JAX does (float32). The default minval, tiny, is the one the
    gumbel noise takes; ``jax.random.uniform``'s own default is 0."""
    bits = (random_bits(keys, shape, device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    span = _SPAN if minval == _TINY else float(np.float32(1.0) - np.float32(minval))
    return torch.clamp_min(floats * span + minval, minval)


def gumbel(keys, shape, device="cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low")."""
    return -torch.log(-torch.log(uniform(keys, shape, device)))
