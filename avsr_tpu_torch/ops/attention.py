"""Masked attention memories and the Bahdanau read (counterpart of
``avsr_tpu/ops/attention.py``).

A memory is prepared once: the mask, the additive bias (0 where valid,
-1e30 where padded), the optional value down-projection and, for Bahdanau
attention, the key projection ``bf16(memory) @ bf16(wm)`` kept in fp32.
The transformer decoder computes its own multi-head scores and reads only
a memory's VALUES (the reference's ``value_only`` path): its memories
carry ``keys=None``.

``attend`` is one Bahdanau read per query row, kernel K10: for tensors on
a GPU it launches ``csrc/bahdanau_attend.cu`` (the read body is
``csrc/bahdanau_core.cuh``, shared with the AV-Align fusion scan K8), for
tensors on the CPU it runs ``attend_plain``.  Per row, under the bf16
policy:

    q       = bf16(query) @ bf16(wq)                       (fp32)
    scores  = bf16(tanh(keys + q)) . bf16(v) + bias        (fp32)
    weights = softmax(scores) * mask, renormalized, times min(sum(mask), 1)
    context = bf16(weights) @ bf16(values)                 (fp32)

so a memory of length 0 gives zero weights and a zero context.  Luong
attention and ``attend_batched_queries`` are not ported and raise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from avsr_tpu_torch import kernels
from avsr_tpu_torch.utils.numerics import dot_f32
from avsr_tpu_torch.utils.params import Params, glorot_uniform

NEG_INF = -1e30


class AttentionMemory(NamedTuple):
    """A prepared memory, in the reference's field order."""

    values: torch.Tensor            # [B, S, V] memory vectors (or their down-projection)
    keys: Optional[torch.Tensor]    # [B, S, A] fp32 projected keys (Bahdanau), or None
    mask: torch.Tensor              # [B, S] 1.0 = valid position
    bias: torch.Tensor              # [B, S] 0 where valid, NEG_INF where padded


def _check_type(attention_type: str) -> None:
    if attention_type != "bahdanau":
        raise ValueError(f"{attention_type!r} attention is not ported (the port runs Bahdanau)")


def bahdanau_init(gen: torch.Generator, query_dim: int, memory_dim: int, attention_units: int,
                  device, value_dim: Optional[int] = None) -> Params:
    params = {
        "wq": glorot_uniform(gen, (query_dim, attention_units), device),
        "wm": glorot_uniform(gen, (memory_dim, attention_units), device),
        "v": glorot_uniform(gen, (attention_units, 1), device).squeeze(-1),
    }
    if value_dim is not None:
        params["wv"] = glorot_uniform(gen, (memory_dim, value_dim), device)
    return params


def attention_init(attention_type: str, gen: torch.Generator, query_dim: int, memory_dim: int,
                   attention_units: int, device, value_dim: Optional[int] = None) -> Params:
    _check_type(attention_type)
    return bahdanau_init(gen, query_dim, memory_dim, attention_units, device,
                         value_dim=value_dim)


def value_only_init(gen: torch.Generator, memory_dim: int, value_dim: Optional[int],
                    device) -> Params:
    params: Params = {}
    if value_dim is not None:
        params["wv"] = glorot_uniform(gen, (memory_dim, value_dim), device)
    return params


def prepare_memory(attention_type: str, params: Params, memory: torch.Tensor,
                   memory_lengths: torch.Tensor, cdt: torch.dtype) -> AttentionMemory:
    """Mask, bias, the Bahdanau keys (fp32) and the optional one-time value
    down-projection; ``value_only`` memories carry no keys."""
    B, S, _ = memory.shape
    mask = (torch.arange(S, device=memory.device)[None, :]
            < memory_lengths[:, None]).float()
    bias = (1.0 - mask) * NEG_INF
    keys = None
    if attention_type != "value_only":
        _check_type(attention_type)
        keys = dot_f32(memory, params["wm"], cdt)
    values = memory
    if "wv" in params:
        values = dot_f32(memory, params["wv"], cdt)
    return AttentionMemory(values=values, keys=keys, mask=mask, bias=bias)


def attend_plain(attention_type: str, params: Params, query: torch.Tensor,
                 mem: AttentionMemory, cdt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch K10: query [N, Q] -> (context [N, V] fp32, weights
    [N, S] fp32, padded positions exactly 0)."""
    _check_type(attention_type)
    q = dot_f32(query, params["wq"], cdt)                      # [N, A]
    e = torch.tanh(mem.keys + q[:, None, :])                   # [N, S, A] fp32
    scores = torch.einsum("nsa,a->ns", e.to(cdt).float(), params["v"].to(cdt).float())
    scores = scores + mem.bias
    weights = torch.softmax(scores, dim=-1) * mem.mask
    # renormalize, and zero a memory whose every position is masked
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-9)
    weights = weights * torch.clamp(mem.mask.sum(dim=-1, keepdim=True), max=1.0)
    context = torch.einsum("ns,nsh->nh", weights.to(cdt).float(), mem.values.to(cdt).float())
    return context, weights


def attend(attention_type: str, params: Params, query: torch.Tensor, mem: AttentionMemory,
           cdt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 wrapper: the CUDA kernel for GPU tensors, the plain version on
    the CPU; same contract as ``attend_plain``.  The kernel runs the bf16
    policy only; any other compute dtype on a GPU raises."""
    if query.device.type == "cpu":
        return attend_plain(attention_type, params, query, mem, cdt)
    _check_type(attention_type)
    if cdt != torch.bfloat16:
        raise ValueError(f"the Bahdanau attention kernel runs the bf16 policy only, got {cdt}")
    bf = torch.bfloat16
    return kernels.bahdanau_attend(
        query.float().contiguous(), params["wq"].to(bf).contiguous(),
        params["v"].to(bf).contiguous(), mem.keys.float().contiguous(),
        mem.values.to(bf).contiguous(), mem.bias.float().contiguous(),
        mem.mask.float().contiguous())
