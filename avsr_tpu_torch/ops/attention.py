"""Prepared attention memories (counterpart of ``avsr_tpu/ops/attention.py``).

The port's decoder is the transformer decoder, which computes its own
multi-head scores and reads only a memory's VALUES (the reference's
``value_only`` path).  Padded positions get an additive bias of -1e30.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from avsr_tpu_torch.utils.numerics import dot_f32
from avsr_tpu_torch.utils.params import Params, glorot_uniform

NEG_INF = -1e30


class AttentionMemory(NamedTuple):
    """The reference's memory minus ``keys``, which value-only consumers
    never read (XLA drops them there; eager PyTorch would carry them)."""

    values: torch.Tensor  # [B, S, V] memory vectors (or their down-projection)
    mask: torch.Tensor    # [B, S] 1.0 = valid position
    bias: torch.Tensor    # [B, S] 0 where valid, NEG_INF where padded


def value_only_init(gen: torch.Generator, memory_dim: int, value_dim: Optional[int],
                    device="cpu") -> Params:
    params: Params = {}
    if value_dim is not None:
        params["wv"] = glorot_uniform(gen, (memory_dim, value_dim), device)
    return params


def prepare_memory(attention_type: str, params: Params, memory: torch.Tensor,
                   memory_lengths: torch.Tensor, cdt: torch.dtype) -> AttentionMemory:
    """Mask bias and the optional one-time value down-projection."""
    if attention_type != "value_only":
        raise ValueError("the port prepares value-only memories (transformer decoder)")
    B, S, _ = memory.shape
    mask = (torch.arange(S, device=memory.device)[None, :]
            < memory_lengths[:, None]).float()
    bias = (1.0 - mask) * NEG_INF
    values = memory
    if "wv" in params:
        values = dot_f32(memory, params["wv"], cdt)
    return AttentionMemory(values=values, mask=mask, bias=bias)
