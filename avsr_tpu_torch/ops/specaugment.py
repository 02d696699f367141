"""SpecAugment: time and frequency masks on the post-frontend features
(counterpart of ``avsr_tpu/ops/specaugment.py``; the reference runs it in
plain jnp, no kernel, and so does this module).

Opt-in training augmentation (Park et al., 2019; ``cfg.audio.spec_augment``)
applied to [B, T, D] features: ``num_time_masks`` spans of 0 to
``time_mask_width`` frames, each starting inside the utterance's valid
frames, then ``num_freq_masks`` bands of 0 to ``freq_mask_width`` feature
channels, are zeroed per example.  ``feat * keep_t * keep_d`` with 0/1
masks, as the reference multiplies.

The draws, per mask in the reference's order (``rng, k_start, k_width =
split(rng, 3)``; time masks first): a width in [0, W]; a time start
``randint(0, T) % max(len - width, 1)``; a frequency start in [0, max(D -
width, 1)).  In training they come from the step's ``torch.Generator``
(``spec_augment``; on the generator's device, no host sync), as dropout's
do.  ``spec_augment_masks_from_key`` reproduces JAX's draws bit for bit on
the host from a JAX key's two words (``utils/rng.py``'s threefry), which the
tests hold equal to the reference's masks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from avsr_tpu_torch.utils import rng as trng


def _span_masks(start: torch.Tensor, width: torch.Tensor, n: int) -> torch.Tensor:
    """[B] starts and widths -> [B, n] fp32 keep mask (0 inside [start,
    start + width))."""
    idx = torch.arange(n, device=start.device)[None, :]
    inside = (idx >= start[:, None]) & (idx < (start + width)[:, None])
    return 1.0 - inside.float()


def apply_masks(feat: torch.Tensor, keep_t: torch.Tensor, keep_d: torch.Tensor) -> torch.Tensor:
    """feat [B, T, D] * keep_t [B, T, 1] * keep_d [B, 1, D]."""
    return feat * keep_t.to(feat.dtype)[:, :, None] * keep_d.to(feat.dtype)[:, None, :]


def _randint(generator: torch.Generator, low: int, high: torch.Tensor) -> torch.Tensor:
    """[B] draws in [low, high) for per-row ``high`` (int64 on the
    generator's device), as 31 random bits modulo the span."""
    bits = torch.randint(0, 2 ** 31 - 1, high.shape, generator=generator,
                         device=generator.device)
    return low + bits % torch.clamp(high - low, min=1)


def spec_augment(generator: torch.Generator, feat: torch.Tensor, lengths: torch.Tensor, *,
                 num_time_masks: int = 2, time_mask_width: int = 20, num_freq_masks: int = 2,
                 freq_mask_width: int = 8) -> torch.Tensor:
    """Mask random time spans and feature bands of ``feat`` [B, T, D] (the
    training path: draws from ``generator``)."""
    B, T, D = feat.shape
    dev = feat.device
    full = lambda v: torch.full((B,), v, dtype=torch.int64, device=dev)  # noqa: E731
    lengths = lengths.to(dev).long()
    keep_t = torch.ones((B, T), dtype=torch.float32, device=dev)
    for _ in range(num_time_masks):
        width = _randint(generator, 0, full(time_mask_width + 1)).to(dev)
        start = _randint(generator, 0, full(T)).to(dev) % torch.clamp(lengths - width, min=1)
        keep_t = keep_t * _span_masks(start, width, T)
    keep_d = torch.ones((B, D), dtype=torch.float32, device=dev)
    for _ in range(num_freq_masks):
        width = _randint(generator, 0, full(freq_mask_width + 1)).to(dev)
        start = _randint(generator, 0, torch.clamp(D - width, min=1))
        keep_d = keep_d * _span_masks(start.to(dev), width, D)
    return apply_masks(feat, keep_t, keep_d)


def spec_augment_masks_from_key(key, lengths, T: int, D: int, *, num_time_masks: int = 2,
                                time_mask_width: int = 20, num_freq_masks: int = 2,
                                freq_mask_width: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's masks from a JAX key (its two uint32 words): (keep_t
    [B, T], keep_d [B, D]) float32, bit for bit as ``avsr_tpu``'s
    ``spec_augment`` draws them (``jax.random.split`` and ``randint`` of
    shape (B, 1) under the partitionable threefry)."""
    lengths = np.asarray(lengths, np.int64)
    B = lengths.shape[0]
    keep_t = np.ones((B, T), np.float32)
    t_idx = np.arange(T)[None, :]
    for _ in range(num_time_masks):
        key, k_start, k_width = (trng.split_key(key, i) for i in range(3))
        width = trng.randint32(k_width, 0, time_mask_width + 1, B).astype(np.int64)
        max_start = np.maximum(lengths - width, 1)
        start = trng.randint32(k_start, 0, T, B).astype(np.int64) % max_start
        inside = (t_idx >= start[:, None]) & (t_idx < (start + width)[:, None])
        keep_t = keep_t * (1.0 - inside.astype(np.float32))
    keep_d = np.ones((B, D), np.float32)
    d_idx = np.arange(D)[None, :]
    for _ in range(num_freq_masks):
        key, k_start, k_width = (trng.split_key(key, i) for i in range(3))
        width = trng.randint32(k_width, 0, freq_mask_width + 1, B).astype(np.int64)
        start = trng.randint32(k_start, 0, np.maximum(D - width, 1), B).astype(np.int64)
        inside = (d_idx >= start[:, None]) & (d_idx < (start + width)[:, None])
        keep_d = keep_d * (1.0 - inside.astype(np.float32))
    return keep_t, keep_d
