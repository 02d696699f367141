"""Cross-attention fusion (counterpart of ``avsr_tpu/models/fusion.py``,
``cross_attention_fusion_init`` / ``cross_attention_fusion_apply``).

Multi-head cross-attention with audio queries over video keys/values; the
fused memory is [audio encoder output ; attended visual context],
time-major, with padded steps exactly zero.  Key padding adds -1e9 to the
scores and the softmax runs in fp32.  Plain PyTorch: the reference leaves
this block to XLA as plain jnp (a kernel for it is queued).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from avsr_tpu.configs import FusionConfig
from avsr_tpu_torch.utils.numerics import dot_f32
from avsr_tpu_torch.utils.params import Params, glorot_uniform, zeros


class FusionOutput(NamedTuple):
    fused: torch.Tensor           # [T_a, B, H_a + H_v] fused decoder memory
    alignments: torch.Tensor      # [T_a, B, T_v] head-averaged attention weights
    au_predictions: Optional[torch.Tensor]  # [T_a, B, au_dim] or None


def cross_attention_fusion_init(gen: torch.Generator, cfg: FusionConfig, audio_dim: int,
                                video_dim: int, device="cpu") -> Params:
    ctx_dim = cfg.memory_value_dim or video_dim
    if ctx_dim % cfg.num_heads != 0:
        raise ValueError(
            f"fusion context dim {ctx_dim} not divisible by num_heads {cfg.num_heads}")
    qk = cfg.attention_units * cfg.num_heads
    params: Params = {
        "wq": glorot_uniform(gen, (audio_dim, qk), device),
        "wk": glorot_uniform(gen, (video_dim, qk), device),
        "wv": glorot_uniform(gen, (video_dim, ctx_dim), device),
        "wo": glorot_uniform(gen, (ctx_dim, ctx_dim), device),
    }
    if cfg.au_loss_weight > 0.0:
        params["au_w"] = glorot_uniform(gen, (ctx_dim, cfg.au_dim), device)
        params["au_b"] = zeros((cfg.au_dim,), device)
    return params


def cross_attention_fusion_apply(params: Params, cfg: FusionConfig, audio_tbd: torch.Tensor,
                                 audio_lengths: torch.Tensor, video_memory: torch.Tensor,
                                 video_lengths: torch.Tensor, cdt: torch.dtype) -> FusionOutput:
    """audio_tbd [T_a, B, D_a] time-major, video_memory [B, T_v, D_v]."""
    T_a, B, _ = audio_tbd.shape
    T_v = video_memory.shape[1]
    nh, A = cfg.num_heads, cfg.attention_units
    ctx_dim = params["wv"].shape[-1]
    dv = ctx_dim // nh
    dev = audio_tbd.device

    a_bm = audio_tbd.transpose(0, 1).to(cdt)
    vm = video_memory.to(cdt)
    q = (a_bm @ params["wq"].to(cdt)).reshape(B, T_a, nh, A)
    k = (vm @ params["wk"].to(cdt)).reshape(B, T_v, nh, A)
    v = (vm @ params["wv"].to(cdt)).reshape(B, T_v, nh, dv)
    scores = torch.einsum("bqha,bkha->bhqk", q, k).float() / math.sqrt(A)
    key_valid = (torch.arange(T_v, device=dev)[None, :] < video_lengths[:, None]).float()
    scores = scores + (1.0 - key_valid)[:, None, None, :] * -1e9
    w = torch.softmax(scores, dim=-1)  # [B, nh, T_a, T_v] fp32
    ctx = torch.einsum("bhqk,bkhd->bqhd", w.to(cdt), v).reshape(B, T_a, ctx_dim)
    ctx = (ctx @ params["wo"].to(cdt)).float()

    a_mask = (torch.arange(T_a, device=dev)[:, None] < audio_lengths[None, :]).float()
    ctx_tm = ctx.transpose(0, 1) * a_mask[:, :, None]
    fused = torch.cat([audio_tbd * a_mask[:, :, None], ctx_tm], dim=-1)
    aligns = w.mean(dim=1).transpose(0, 1) * a_mask[:, :, None]

    au_pred = None
    if "au_w" in params:
        au = dot_f32(ctx_tm, params["au_w"], cdt) + params["au_b"]
        au_pred = au * a_mask[:, :, None]
    return FusionOutput(fused=fused, alignments=aligns, au_predictions=au_pred)
