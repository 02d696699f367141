"""Training-time randomness on explicit ``torch.Generator``s.

Counterpart of ``avsr_tpu/utils/rng.py`` (dropout masks) and of the key
folding the reference's train step does with ``jax.random.fold_in``.  JAX
splits one key per consumer; here one generator is drawn from in a fixed
order (noise, then each encoder layer's dropout, then the decoder's), which
is deterministic for a given seed.  The draws cannot equal JAX's, so the
parity tests run with dropout 0 and noise off, and the random parts are
tested by their statistics.
"""

from __future__ import annotations

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
