"""Shared transformer numerics (counterpart of
``avsr_tpu/models/transformer_common.py``): LayerNorm with fp32 statistics
and epsilon 1e-6 (torch's default is 1e-5), and absolute sinusoidal
position encodings with sin/cos INTERLEAVED (``pe[:, 0::2] = sin``,
``pe[:, 1::2] = cos``), not concatenated halves."""

from __future__ import annotations

import numpy as np
import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + 1e-6)
    return y * scale.float() + bias.float()


def sinusoidal_pe(length: int, d: int, device="cpu") -> torch.Tensor:
    """[length, d] fp32 position encodings; ``d`` must be even."""
    if d % 2:
        raise ValueError(f"sinusoidal position encodings need even d, got {d}")
    pos = np.arange(length, dtype=np.float32)[:, None]
    half = d // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half, dtype=np.float32) / half)
    ang = pos * freq[None, :]
    pe = np.zeros((length, d), np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return torch.from_numpy(pe).to(device)
