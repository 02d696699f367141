"""Fusion encoders (counterpart of ``avsr_tpu/models/fusion.py``): the
AV-Align recurrent fusion (``av_align_init`` / ``av_align_apply``) and the
cross-attention fusion (``cross_attention_fusion_init`` /
``cross_attention_fusion_apply``), with the AU head and
``au_regression_loss``.  Both return the fused decoder memory
[audio ; attended visual context], time-major, with padded steps exactly
zero.

AV-Align (the reference-dims model): a unidirectional LSTM over the audio
encoder's output with input feeding; at every audio step one Bahdanau read
of the video memory with the new h as the query; the memory is [h ; ctx].
The scan body (``fusion.py:118-141``) is kernel K8: ``av_align_scan``
launches ``csrc/av_align_scan.cu`` for tensors on a GPU and runs
``av_align_scan_plain`` (a loop of ``lstm_step`` and ``attend_plain``) for
tensors on the CPU.  The hoisted fp32 input product, the memory
preparation, the AU head and the concat stay torch code.  K8 has no
backward yet: asking it for a gradient raises.

Cross-attention: multi-head attention with audio queries over video
keys/values.  Key padding adds -1e9 to the scores and the softmax runs in
fp32.  Its core (scores, mask, softmax, P.V; ``fusion.py:226-235``) is
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

from avsr_tpu_torch.configs import FusionConfig
from avsr_tpu_torch import kernels
from avsr_tpu_torch.ops import attention as attn
from avsr_tpu_torch.ops import rnn
from avsr_tpu_torch.utils.numerics import dot_f32
from avsr_tpu_torch.utils.params import Params, glorot_uniform, zeros


class FusionOutput(NamedTuple):
    fused: torch.Tensor           # [T_a, B, H_a + H_v] fused decoder memory
    alignments: torch.Tensor      # [T_a, B, T_v] (head-averaged) attention weights
    au_predictions: Optional[torch.Tensor]  # [T_a, B, au_dim] or None


def av_align_init(gen: torch.Generator, cfg: FusionConfig, audio_input_dim: int,
                  audio_hidden: int, video_dim: int, device) -> Params:
    """The fusion LSTM cell (its ``wx`` covers the acoustic input only), the
    Bahdanau attention over the video memory, the context-input projection
    (input feeding) and the AU head, with the reference's keys and shapes."""
    params: Params = {
        "cell": rnn.lstm_init(gen, audio_input_dim, audio_hidden, device),
        "att": attn.attention_init(cfg.attention_type, gen, audio_hidden, video_dim,
                                   cfg.attention_units, device, value_dim=cfg.memory_value_dim),
    }
    ctx_dim = cfg.memory_value_dim or video_dim
    if cfg.input_feeding:
        params["ctx_proj"] = glorot_uniform(gen, (ctx_dim, 4 * audio_hidden), device)
    if cfg.au_loss_weight > 0.0:
        params["au_w"] = glorot_uniform(gen, (ctx_dim, cfg.au_dim), device)
        params["au_b"] = zeros((cfg.au_dim,), device)
    return params


def av_align_scan_plain(cell: Params, att: Params, ctx_proj: Optional[torch.Tensor],
                        xw: torch.Tensor, mask: torch.Tensor, mem: attn.AttentionMemory,
                        cdt: torch.dtype):
    """Plain-PyTorch K8: the reference's scan body, step by step.

    xw [T,B,4H] fp32 (the hoisted input product), mask [T,B] fp32, the
    prepared video memory -> (hs [T,B,H], ctxs [T,B,Dv], aligns [T,B,T_v],
    (hT, cT, ctxT)), all fp32, from zero initial carries.
    """
    T, B, _ = xw.shape
    H = cell["wh"].shape[0]
    dev = xw.device
    h = torch.zeros((B, H), dtype=torch.float32, device=dev)
    c = torch.zeros((B, H), dtype=torch.float32, device=dev)
    ctx = torch.zeros((B, mem.values.shape[-1]), dtype=torch.float32, device=dev)
    hs, ctxs, aligns = [], [], []
    for t in range(T):
        gate_in = xw[t]
        if ctx_proj is not None:
            gate_in = gate_in + dot_f32(ctx, ctx_proj, cdt)
        (h_new, c_new), _ = rnn.lstm_step(cell, gate_in, (h, c), cdt, preprojected=True)
        ctx_new, align = attn.attend_plain("bahdanau", att, h_new, mem, cdt)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ctx = m * ctx_new + (1.0 - m) * ctx
        hs.append(h_new * m)
        ctxs.append(ctx_new * m)
        aligns.append(align * m)
    return torch.stack(hs), torch.stack(ctxs), torch.stack(aligns), (h, c, ctx)


def av_align_scan(cell: Params, att: Params, ctx_proj: Optional[torch.Tensor],
                  xw: torch.Tensor, mask: torch.Tensor, mem: attn.AttentionMemory,
                  cdt: torch.dtype):
    """K8 wrapper: the CUDA kernel for GPU tensors, the plain version on the
    CPU; same contract as ``av_align_scan_plain``.  The kernel runs the bf16
    policy only and has no backward yet: a gradient asked of either raises
    rather than being lost or half computed."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (cell["wh"], cell["b"], ctx_proj, att["wq"], att["v"], xw, mem.keys,
                      mem.values)):
        raise ValueError("the AV-Align fusion scan (K8) has no backward yet: training of "
                         "the AV-Align model is not ported")
    if xw.device.type == "cpu":
        return av_align_scan_plain(cell, att, ctx_proj, xw, mask, mem, cdt)
    if cdt != torch.bfloat16:
        raise ValueError(f"the AV-Align fusion kernel runs the bf16 policy only, got {cdt}")
    bf = torch.bfloat16
    hs, ctxs, aligns, hT, cT, ctxT = kernels.av_align_scan(
        cell["wh"].to(bf).contiguous(), cell["b"].float().contiguous(),
        None if ctx_proj is None else ctx_proj.to(bf).contiguous(),
        att["wq"].to(bf).contiguous(), att["v"].to(bf).contiguous(),
        xw.float().contiguous(), mask.float().contiguous(), mem.keys.float().contiguous(),
        mem.values.to(bf).contiguous(), mem.bias.float().contiguous(),
        mem.mask.float().contiguous())
    return hs, ctxs, aligns, (hT, cT, ctxT)


def av_align_apply(params: Params, cfg: FusionConfig, audio_tbd: torch.Tensor,
                   audio_lengths: torch.Tensor, video_memory: torch.Tensor,
                   video_lengths: torch.Tensor, cdt: torch.dtype) -> FusionOutput:
    """audio_tbd [T_a, B, D] time-major (the lower audio layers' output),
    video_memory [B, T_v, H_v] -> fused [T_a, B, H + Dv], alignments
    [T_a, B, T_v] and the AU predictions."""
    T_a = audio_tbd.shape[0]
    mem = attn.prepare_memory(cfg.attention_type, params["att"], video_memory, video_lengths,
                              cdt)
    xw = dot_f32(audio_tbd, params["cell"]["wx"], cdt)  # hoisted, fp32 [T_a, B, 4H]
    mask = (torch.arange(T_a, device=audio_tbd.device)[:, None]
            < audio_lengths[None, :]).float()
    hs, ctxs, aligns, _ = av_align_scan(params["cell"], params["att"], params.get("ctx_proj"),
                                        xw, mask, mem, cdt)
    fused = torch.cat([hs, ctxs], dim=-1)
    au_pred = None
    if "au_w" in params:
        au_pred = (dot_f32(ctxs, params["au_w"], cdt) + params["au_b"]) * mask[:, :, None]
    return FusionOutput(fused=fused, alignments=aligns, au_predictions=au_pred)


def cross_attention_fusion_init(gen: torch.Generator, cfg: FusionConfig, audio_dim: int,
                                video_dim: int, device) -> Params:
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
