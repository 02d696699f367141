"""Cross-attention fusion (counterpart of ``avsr_tpu/models/fusion.py``,
``cross_attention_fusion_init`` / ``cross_attention_fusion_apply`` /
``au_regression_loss``).

Multi-head cross-attention with audio queries over video keys/values; the
fused memory is [audio encoder output ; attended visual context],
time-major, with padded steps exactly zero.  Key padding adds -1e9 to the
scores and the softmax runs in fp32.

The attention core (scores, mask, softmax, P.V; ``fusion.py:226-235``) is
kernel K4: ``FusionAttention`` is its ``torch.autograd.Function``, and
``fusion_attention_fwd`` / ``fusion_attention_bwd`` launch the CUDA kernels
(``csrc/cross_attention.cu``) for tensors on a GPU and run the plain
versions for tensors on the CPU.  The projections, the audio mask, the
head mean for the alignments and the AU head stay torch code, as the
reference leaves them to XLA as plain matmuls.  The alignments feed no
loss, so the weights output of the core carries no gradient.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from avsr_tpu.configs import FusionConfig
from avsr_tpu_torch import kernels
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


def fusion_attention_fwd_plain(q, k, v, video_lengths):
    """Plain-PyTorch K4 forward.  q [B,T_a,nh,A], k [B,T_v,nh,A],
    v [B,T_v,nh,dv] in the compute dtype, video_lengths [B] ->
    (ctx [B,T_a,nh,dv] in the compute dtype, weights [B,nh,T_a,T_v] fp32)."""
    T_v, A = k.shape[1], k.shape[-1]
    scores = torch.einsum("bqha,bkha->bhqk", q, k).float() / math.sqrt(A)
    key_valid = (torch.arange(T_v, device=q.device)[None, :] < video_lengths[:, None]).float()
    scores = scores + (1.0 - key_valid)[:, None, None, :] * -1e9
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype), v)
    return ctx, w


def fusion_attention_bwd_plain(q, k, v, weights, dctx):
    """Plain-PyTorch K4 backward: the gradient JAX's autodiff takes through
    the reference core, with its rounding points (the P.V and dctx.V^T
    products return the compute dtype; the scores' cotangent is rounded to
    it before the q/k products).  -> (dq, dk, dv) in q/k/v's dtypes."""
    cdt = q.dtype
    A = q.shape[-1]
    dv = torch.einsum("bhqk,bqhd->bkhd", weights.to(cdt), dctx.to(cdt))
    dw = torch.einsum("bqhd,bkhd->bhqk", dctx.to(cdt), v).float()
    ds = weights * (dw - (dw * weights).sum(dim=-1, keepdim=True))
    dsc = (ds / math.sqrt(A)).to(cdt)
    dq = torch.einsum("bhqk,bkha->bqha", dsc, k)
    dk = torch.einsum("bhqk,bqha->bkha", dsc, q)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_policy(q):
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the fusion attention kernels run the bf16 policy only, got {q.dtype}")


def fusion_attention_fwd(q, k, v, video_lengths):
    """K4 forward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``fusion_attention_fwd_plain``."""
    if q.device.type == "cpu":
        return fusion_attention_fwd_plain(q, k, v, video_lengths)
    _check_policy(q)
    return kernels.fusion_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                        video_lengths.to(torch.int32).contiguous())


def fusion_attention_bwd(q, k, v, weights, dctx):
    """K4 backward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``fusion_attention_bwd_plain``."""
    if q.device.type == "cpu":
        return fusion_attention_bwd_plain(q, k, v, weights, dctx)
    _check_policy(q)
    return kernels.fusion_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                        weights.contiguous(),
                                        dctx.to(torch.bfloat16).contiguous())


class FusionAttention(torch.autograd.Function):
    """K4 with its gradient: (ctx, weights) from q, k, v and the video
    lengths.  The weights only feed the alignments, which no loss reads:
    they are marked non-differentiable, and a gradient arriving for them
    raises."""

    @staticmethod
    def forward(ctx, q, k, v, video_lengths):
        out, w = fusion_attention_fwd(q, k, v, video_lengths)
        ctx.save_for_backward(q, k, v, w)
        ctx.mark_non_differentiable(w)
        ctx.set_materialize_grads(False)
        return out, w

    @staticmethod
    def backward(ctx, dctx, dw):
        if dw is not None:
            raise RuntimeError("the fusion attention weights take no gradient")
        q, k, v, w = ctx.saved_tensors
        if dctx is None:
            return None, None, None, None
        dq, dk, dv = fusion_attention_bwd(q, k, v, w, dctx)
        return dq, dk, dv, None


def fusion_attention(q, k, v, video_lengths):
    """K4 as the fusion calls it: through ``FusionAttention`` when autograd
    records a gradient for q, k or v, else straight to the forward wrapper."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FusionAttention.apply(q, k, v, video_lengths)
    return fusion_attention_fwd(q, k, v, video_lengths)


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
    ctx, w = fusion_attention(q, k, v, video_lengths)  # w [B, nh, T_a, T_v] fp32
    ctx = (ctx.reshape(B, T_a, ctx_dim) @ params["wo"].to(cdt)).float()

    a_mask = (torch.arange(T_a, device=dev)[:, None] < audio_lengths[None, :]).float()
    ctx_tm = ctx.transpose(0, 1) * a_mask[:, :, None]
    fused = torch.cat([audio_tbd * a_mask[:, :, None], ctx_tm], dim=-1)
    aligns = w.mean(dim=1).transpose(0, 1) * a_mask[:, :, None]

    au_pred = None
    if "au_w" in params:
        au = dot_f32(ctx_tm, params["au_w"], cdt) + params["au_b"]
        au_pred = au * a_mask[:, :, None]
    return FusionOutput(fused=fused, alignments=aligns, au_predictions=au_pred)


def au_regression_loss(au_pred: torch.Tensor, au_target: torch.Tensor,
                       audio_lengths: torch.Tensor,
                       row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked MSE between predicted and target action units (reference
    ``au_regression_loss``): [T_a, B, au_dim] each; ``row_weights`` [B]
    drops rows with no real AU stream."""
    T_a = au_pred.shape[0]
    mask = (torch.arange(T_a, device=au_pred.device)[:, None]
            < audio_lengths[None, :]).float()
    if row_weights is not None:
        mask = mask * row_weights[None, :].float()
    sq = (au_pred - au_target).square().sum(dim=-1)
    return (sq * mask).sum() / torch.clamp(mask.sum(), min=1.0)
