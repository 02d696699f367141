"""Training-time randomness on explicit ``torch.Generator``s.

Counterpart of ``avsr_tpu/utils/rng.py`` (dropout masks) and of the key
folding the reference's train step does with ``jax.random.fold_in``.  JAX
splits one key per consumer; here one generator is drawn from in a fixed
order (noise, then each encoder layer's dropout, then the decoder's), which
is deterministic for a given seed.  The training draws cannot equal JAX's,
so the parity tests run with dropout 0 and noise off, and the random parts
are tested by their statistics.

The eval-time fixed-SNR noise draws are the exception: they are a few
uint32 words per utterance, and the last section reproduces JAX's
threefry2x32 in numpy on the host to draw them bit for bit as the JAX
package does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (the step, the micro-batch
    index): one round of splitmix64 over ``seed * 2^32 + data``.  Distinct
    (seed, data) pairs with ``data < 2^32`` give distinct inputs, and the
    mix spreads neighbouring inputs over the whole range."""
    z = ((int(seed) << 32) + int(data) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def generator_for(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def dropout_mask(generator: torch.Generator, keep: float, shape, dtype=torch.float32):
    """Inverted-dropout mask: bernoulli(keep)/keep in ``dtype``, drawn on the
    generator's device."""
    bits = torch.rand(shape, generator=generator, device=generator.device) < keep
    return bits.to(dtype) / keep


# ---------------------------------------------------------------------------
# JAX's threefry2x32 PRNG on the host (numpy): the eval noise draws
# ---------------------------------------------------------------------------
#
# ``ops/noise.py:mix_fixed_snr`` draws one (bank row, offset) pair per
# utterance as the JAX package draws it (``avsr_tpu/ops/noise.py:
# mix_fixed_snr``, jax's default ``jax_threefry_partitionable``):
#   fold_in(PRNGKey(seed), h) -> split -> randint(0, N), randint(0, L - S + 1)
# Every step is uint32 arithmetic, so the draws are reproduced bit for bit
# (``tests/test_torch_fixed_snr.py`` holds them against jax's).  Arrays of
# uint32 wrap as the device's integers do; Python ints would not.

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block (20 rounds) of key (k0, k1) over counters (x0,
    x1): uint32 arrays, broadcast together."""
    k0, k1, x0, x1 = (np.asarray(a, _U32) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):  # 0-d operands warn where arrays wrap silently
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """``jax.random.PRNGKey(seed)``'s two words; a negative seed wraps to
    32 bits as jax's int32 seeds do."""
    seed = int(seed)
    if seed < 0:
        seed &= 0xFFFFFFFF
    return _U32((seed >> 32) & 0xFFFFFFFF), _U32(seed & 0xFFFFFFFF)


def fold_in_key(key, data) -> Tuple[np.ndarray, np.ndarray]:
    """``jax.random.fold_in``: threefry of the counter (0, data)."""
    data = np.asarray(data, _U32)
    return threefry2x32(key[0], key[1], np.zeros_like(data), data)


def split_key(key, i: int) -> Tuple[np.ndarray, np.ndarray]:
    """Key ``i`` of ``jax.random.split(key)``: threefry of the counter (0, i)."""
    return threefry2x32(key[0], key[1], _U32(0), _U32(i))


def random_bits32(key, n=None) -> np.ndarray:
    """``jax.random.bits(key, (), uint32)`` (the two words of counter (0, 0)
    xor'ed), or with ``n`` the bits of shape (n,): counters (0, i), as jax's
    partitionable threefry counts a flattened shape."""
    count = _U32(0) if n is None else np.arange(n, dtype=_U32)
    y0, y1 = threefry2x32(key[0], key[1], _U32(0), count)
    return y0 ^ y1


def randint32(key, minval, maxval, n=None) -> np.ndarray:
    """``jax.random.randint(key, (), minval, maxval)`` (int32), or of shape
    (n,) with ``n`` (``minval`` / ``maxval`` scalars or arrays of that
    shape): two words of bits summed modulo the span in uint32, whose
    multiplier ``(2^16 mod span)^2`` wraps to 0 for spans past 2^16; a span
    of maxval <= minval is 1 (minval is drawn)."""
    hi = random_bits32(split_key(key, 0), n)
    lo = random_bits32(split_key(key, 1), n)
    minval = np.asarray(minval, np.int64)
    maxval = np.asarray(maxval, np.int64)
    span = np.where(maxval > minval, maxval - minval, 1).astype(_U32)
    mult = np.asarray(_U32(65536) % span, _U32)
    mult = (mult * mult) % span
    offset = ((hi % span) * mult + lo % span) % span
    return (minval + offset.astype(np.int64)).astype(np.int32)


def fixed_snr_draws(seed: int, uid_hashes, rows: int, offsets: int):
    """The (bank row, offset) of each utterance that ``mix_fixed_snr`` mixes:
    per uint32 hash h, ``fold_in(PRNGKey(seed), h)`` split in two keys, a row
    in [0, rows) from the first and an offset in [0, offsets) from the
    second -> two int32 arrays of the hashes' shape."""
    key = fold_in_key(prng_key(seed), np.asarray(uid_hashes).astype(_U32))
    return (randint32(split_key(key, 0), 0, rows),
            randint32(split_key(key, 1), 0, offsets))
