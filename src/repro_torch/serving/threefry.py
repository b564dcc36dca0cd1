"""The parts of ``jax.random`` the serving sampler uses, on torch tensors.

Threefry-2x32 (20 rounds) keys and bits as jax 0.9.0 computes them by
default (``jax_threefry_partitionable=True``): element i of a bits array is
``t0 ^ t1`` where ``(t0, t1) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``
and i runs over the flattened shape.  A key is an int64 tensor ``[..., 2]``
holding two uint32 words, so keys broadcast over leading axes (one per
batch row).

torch has no shifts on uint32 on the CPU, so every word is held in int64
and masked back to 32 bits after each add and rotate.

    PRNGKey(seed)           -> key [..., 2]   (seed: int or int tensor)
    fold_in(key, data)      -> key [..., 2]
    bits(key, shape)        -> int64 uint32 words [..., *shape]
    uniform(key, shape, minval, maxval) -> float32
    gumbel(key, shape)      -> float32
    categorical(key, logits) = argmax(logits + gumbel(key, logits.shape))
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counts (x0, x1) under key (k0, k1), all
    int64 tensors of uint32 words that broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed, device=None) -> torch.Tensor:  # noqa: N802 (jax's name)
    """``jax.random.PRNGKey`` of an int32 seed (a Python int or an integer
    tensor of any shape): ``[seed >> 32, seed & 0xFFFFFFFF]`` with the
    logical shift of a 32-bit word, so the first word is 0 and a negative
    seed keeps its two's-complement bits."""
    s = torch.as_tensor(seed, device=device).to(torch.int64)
    return torch.stack([torch.zeros_like(s), s & MASK], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of counts (0, data) under key,
    for int32 ``data`` (broadcast against the key's leading axes)."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 words, with the
    key's leading axes in front: [*key.shape[:-1], *shape]."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    lead = key.shape[:-1]
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    k0 = key[..., 0].reshape(*lead, 1)
    k1 = key[..., 1].reshape(*lead, 1)
    t0, t1 = threefry2x32(k0, k1, idx >> 32, idx & MASK)
    return (t0 ^ t1).reshape(*lead, *shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as a mantissa of
    [1, 2), minus 1, scaled to [minval, maxval) and clamped below."""
    b = bits(key, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # float32 bounds as Python scalars (a tensor made from a host value
    # would be a host-to-device copy, which a CUDA graph cannot capture)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(f * span + lo, lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 (its default "low" mode):
    -log(-log(u)) with u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    gumbel-max draw, the first maximum on ties.  A single key [2] draws
    the noise of the whole logits shape, as jax does; keys [..., 2] give
    one key per leading row of logits [..., V], as ``jax.vmap`` of it
    does."""
    g = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(g + logits.float(), dim=-1)
