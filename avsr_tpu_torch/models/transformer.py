"""Transformer encoder stack (counterpart of ``avsr_tpu/models/transformer.py``:
``validate_transformer_config``, ``transformer_encoder_init``,
``transformer_encoder_apply``), the encoders of the scan-free
``lrs2_av_v2`` preset.

Same contract as the BiLSTM stack: time-major [T, B, D] in, fp32
[T_out, B, d] out with padded steps exactly zero, valid outputs invariant
to the pad horizon.  Per layer, pre-LN: multi-head self attention over the
valid steps, the conformer conv module (when ``conv_kernel`` is set), a
tanh-GELU FFN; sinusoidal position encodings (interleaved sin/cos) after
the input projection scaled by sqrt(d); a final LayerNorm and the mask.
A pyramidal ``time_reduction`` folds frames between layers and
re-projects them to d with a layer's ``fold`` weight.

Numerics of the reference kept here: the input is masked before the
projection and again after the position encodings; the padded steps of the
residual stream carry garbage between layers (attention never reads them:
padded keys are masked), so the conv module masks its input and again
after the GLU; LayerNorm eps 1e-6 (``transformer_common.layer_norm``).

Two cores are kernels, forward and backward; the products, LayerNorms,
FFN and residuals stay torch code, as the reference leaves them to XLA:

* K11, the self-attention core (``transformer.py:204-224``):
  ``encoder_self_attention`` launches ``csrc/encoder_attention.cu`` on the
  one [d, 3d] product, read in place, for GPU tensors and runs
  ``encoder_self_attention_plain`` for CPU tensors.  When a gradient is
  asked it goes through ``EncoderSelfAttention``: the forward saves the
  softmax's row statistics, and the backward kernel recomputes the weights
  from them and writes the cotangent of the [d, 3d] product
  (``encoder_self_attention_bwd_plain`` on the CPU);
* K9, the conformer conv module between its two pointwise products
  (``transformer.py:231-266``: bias, GLU, mask, depthwise conv, LayerNorm,
  swish): ``conformer_conv`` launches ``csrc/conformer_conv.cu`` for GPU
  tensors and runs ``conformer_conv_plain`` for CPU tensors; with a
  gradient, through ``ConformerConv``, whose backward kernel recomputes the
  forward from its inputs (``conformer_conv_bwd_plain`` on the CPU).

Both backward twins are hand-written with the rounding points of JAX's
autodiff of the reference under the bf16 policy.  In train mode each
layer's three residual branches (attention after ``wo``, the conv module
after ``conv_w_out``, the FFN after ``ff_w2``) get the reference's inverted
dropout, drawn in that order from the step's generator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from avsr_tpu_torch import kernels
from avsr_tpu_torch.configs import EncoderConfig
from avsr_tpu_torch.models.fusion import attention_bwd_from_weights
from avsr_tpu_torch.models.transformer_common import layer_norm, sinusoidal_pe
from avsr_tpu_torch.utils.numerics import check_policy
from avsr_tpu_torch.utils.params import Params, glorot_uniform, zeros
from avsr_tpu_torch.utils.rng import dropout_mask


def validate_transformer_config(cfg: EncoderConfig) -> int:
    """Check transformer-specific invariants; returns d_model."""
    dims = set(cfg.hidden_units)
    if len(dims) != 1:
        raise ValueError(
            "encoder_type='transformer' needs one model dim: all hidden_units equal (got "
            f"{cfg.hidden_units}); depth = len(hidden_units)")
    d = cfg.hidden_units[0]
    if d % cfg.num_heads != 0:
        raise ValueError(f"hidden dim {d} not divisible by num_heads {cfg.num_heads}")
    if d % 2:
        raise ValueError(
            f"hidden dim {d} must be even (sinusoidal position encodings interleave sin/cos "
            "pairs)")
    for knob in ("residual", "highway", "layer_norm"):
        if getattr(cfg, knob):
            raise ValueError(
                f"EncoderConfig.{knob} is an RNN-stack knob; the transformer encoder has its "
                "own residuals/LayerNorm")
    if cfg.recurrent_dropout_rate > 0.0:
        raise ValueError(
            "recurrent_dropout_rate is RNN-only; use dropout_rate for the transformer's "
            "residual-branch dropout")
    if cfg.conv_kernel is not None:
        k = cfg.conv_kernel
        if k < 3 or k % 2 == 0:
            raise ValueError(
                f"conv_kernel must be an odd width >= 3 (got {k}): the depthwise conv is "
                "centered so valid positions stay pad-horizon-invariant")
    return d


def transformer_encoder_init(gen: torch.Generator, cfg: EncoderConfig, input_dim: int,
                             device) -> Params:
    """The reference tree's keys and shapes: ``in_proj`` [r0*D, d] (r0 the
    first layer's time reduction), per layer the attention, FFN and (with
    ``conv_kernel``) conv weights, the depthwise kernel ``conv_dw`` in the
    reference's [k, 1, d] layout, and ``fold`` [r*d, d] on layers > 0 with
    a reduction r > 1."""
    from avsr_tpu_torch.models.encoder import time_reductions

    d = validate_transformer_config(cfg)
    reductions = time_reductions(cfg)
    params: Params = {
        "in_proj": glorot_uniform(gen, (input_dim * reductions[0], d), device),
        "in_bias": zeros((d,), device),
        "layers": [],
        "ln_f_scale": torch.ones((d,), device=device),
        "ln_f_bias": zeros((d,), device),
    }
    ff = cfg.ff_multiplier * d
    for i in range(len(cfg.hidden_units)):
        layer: Params = {
            "ln1_scale": torch.ones((d,), device=device), "ln1_bias": zeros((d,), device),
            "wq": glorot_uniform(gen, (d, d), device), "wk": glorot_uniform(gen, (d, d), device),
            "wv": glorot_uniform(gen, (d, d), device), "wo": glorot_uniform(gen, (d, d), device),
            "ln2_scale": torch.ones((d,), device=device), "ln2_bias": zeros((d,), device),
            "ff_w1": glorot_uniform(gen, (d, ff), device), "ff_b1": zeros((ff,), device),
            "ff_w2": glorot_uniform(gen, (ff, d), device), "ff_b2": zeros((d,), device),
        }
        if cfg.conv_kernel is not None:
            k = cfg.conv_kernel
            layer.update({
                "conv_ln_scale": torch.ones((d,), device=device),
                "conv_ln_bias": zeros((d,), device),
                "conv_w_in": glorot_uniform(gen, (d, 2 * d), device),
                "conv_b_in": zeros((2 * d,), device),
                "conv_dw": glorot_uniform(gen, (k, 1, d), device),
                "conv_dw_ln_scale": torch.ones((d,), device=device),
                "conv_dw_ln_bias": zeros((d,), device),
                "conv_w_out": glorot_uniform(gen, (d, d), device),
                "conv_b_out": zeros((d,), device),
            })
        if i > 0 and reductions[i] > 1:
            layer["fold"] = glorot_uniform(gen, (reductions[i] * d, d), device)
        params["layers"].append(layer)
    return params


def _attention_scores(qkv: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """fp32 [B,nh,T,T] scores of the [B,T,3,nh,dh] product: float(q.k in the
    compute dtype) / sqrt(dh) + (1 - valid_key) * -1e9."""
    q, k = qkv[:, :, 0], qkv[:, :, 1]
    T, dh = qkv.shape[1], qkv.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dh)
    key_valid = (torch.arange(T, device=qkv.device)[None, :] < lengths[:, None]).float()
    return scores + (1.0 - key_valid)[:, None, None, :] * -1e9


def encoder_self_attention_weights(qkv: torch.Tensor, lengths: torch.Tensor,
                                   row_max: torch.Tensor, row_sum: torch.Tensor) -> torch.Tensor:
    """The fp32 weights [B,nh,T,T] from the operands and the softmax's saved
    row statistics [B,nh,T]: exp(s - row_max) / row_sum, the forward's own
    expression, so the same bits as the forward's weights."""
    s = _attention_scores(qkv, lengths)
    return torch.exp(s - row_max[..., None]) / row_sum[..., None]


def encoder_self_attention_fwd_plain(qkv: torch.Tensor, lengths: torch.Tensor, *,
                                     save: bool = False):
    """Plain-PyTorch K11 forward: qkv [B,T,3,nh,dh] in the compute dtype (the
    [d, 3d] product), lengths [B] -> (ctx [B,T,nh,dh] in the compute dtype,
    the softmax's row statistics (row_max, row_sum), fp32 [B,nh,T] each,
    when ``save``, else None).  The softmax written out as the kernel takes
    it: the row max, exp(s - max), the row sum, a division."""
    s = _attention_scores(qkv, lengths)
    row_max = s.amax(dim=-1)
    e = torch.exp(s - row_max[..., None])
    row_sum = e.sum(dim=-1)
    w = e / row_sum[..., None]
    ctx = torch.einsum("bhqk,bkhd->bqhd", w.to(qkv.dtype), qkv[:, :, 2])
    return ctx, ((row_max, row_sum) if save else None)


def encoder_self_attention_plain(qkv: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch K11, the context alone."""
    return encoder_self_attention_fwd_plain(qkv, lengths)[0]


def encoder_self_attention_bwd_plain(qkv: torch.Tensor, lengths: torch.Tensor,
                                     row_max: torch.Tensor, row_sum: torch.Tensor,
                                     dctx: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch K11 backward: the forward's qkv and lengths, its row
    statistics and the context cotangent -> dqkv [B,T,3,nh,dh], the
    cotangent of the [d, 3d] product.  The weights are recomputed from the
    statistics; then the rounding points of JAX's autodiff: the P.V and
    dctx.V^T products return the compute dtype, the scores' cotangent is
    rounded to it before the q/k products."""
    cdt = qkv.dtype
    q, k, v = qkv.unbind(2)
    w = encoder_self_attention_weights(qkv, lengths, row_max, row_sum)
    dctx = dctx.to(cdt)
    dv = torch.einsum("bhqk,bqhd->bkhd", w.to(cdt), dctx)
    dw = torch.einsum("bqhd,bkhd->bhqk", dctx, v).float()
    ds = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    dsc = (ds / math.sqrt(qkv.shape[-1])).to(cdt)
    dq = torch.einsum("bhqk,bkha->bqha", dsc, k)
    dk = torch.einsum("bhqk,bqha->bkha", dsc, q)
    return torch.stack((dq, dk, dv), dim=2)


def encoder_self_attention_fwd(qkv: torch.Tensor, lengths: torch.Tensor, *, save: bool):
    """K11 forward: (ctx, the backward's residual when ``save``, else None);
    the CUDA kernels for GPU tensors (bf16 policy), the plain version on the
    CPU.  The residual is the row statistics (row_max, row_sum) from the
    plain version and the tensor-core kernels, the fp32 weights (a
    one-tuple) from the CUDA-core ones (``kernels.attention_family``)."""
    if qkv.device.type == "cpu":
        return encoder_self_attention_fwd_plain(qkv, lengths, save=save)
    check_policy(qkv.dtype, "K11")
    return kernels.encoder_attention_fwd(qkv.contiguous(), lengths.to(torch.int32).contiguous(),
                                         save=save)


def encoder_self_attention_bwd(qkv: torch.Tensor, lengths: torch.Tensor, row_max: torch.Tensor,
                               row_sum: torch.Tensor, dctx: torch.Tensor) -> torch.Tensor:
    """K11 backward: the tensor-core kernels for GPU tensors, the plain twin
    on the CPU; same contract as ``encoder_self_attention_bwd_plain``."""
    if qkv.device.type == "cpu":
        return encoder_self_attention_bwd_plain(qkv, lengths, row_max, row_sum, dctx)
    check_policy(qkv.dtype, "K11")
    return kernels.encoder_attention_bwd(qkv.contiguous(), lengths.to(torch.int32).contiguous(),
                                         row_max.contiguous(), row_sum.contiguous(),
                                         dctx.to(torch.bfloat16).contiguous())


def encoder_self_attention_bwd_from_weights(qkv: torch.Tensor, lengths: torch.Tensor,
                                            weights: torch.Tensor,
                                            dctx: torch.Tensor) -> torch.Tensor:
    """K11 backward from the fp32 weights [B,nh,T,T], the residual of the
    CUDA-core route (head widths with no tensor-core instance): its kernels
    for GPU tensors, the weights-based backward on the CPU -> dqkv."""
    if qkv.device.type == "cpu":
        return torch.stack(attention_bwd_from_weights(*qkv.unbind(2), weights, dctx), dim=2)
    check_policy(qkv.dtype, "K11")
    return kernels.encoder_attention_bwd_core(qkv.contiguous(),
                                              lengths.to(torch.int32).contiguous(),
                                              weights.contiguous(),
                                              dctx.to(torch.bfloat16).contiguous())


class EncoderSelfAttention(torch.autograd.Function):
    """K11 with its gradient: ctx from the [d, 3d] product and the lengths.
    The forward saves the operands, the lengths and the softmax's row
    statistics ([B, nh, T] each); the backward recomputes the weights (the
    CUDA-core route, at head widths with no tensor-core instance, saves the
    weights)."""

    @staticmethod
    def forward(ctx, qkv, lengths):
        out, res = encoder_self_attention_fwd(qkv, lengths, save=True)
        ctx.save_for_backward(qkv, lengths, *res)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, lengths, *res = ctx.saved_tensors
        if len(res) == 1:
            return encoder_self_attention_bwd_from_weights(qkv, lengths, *res, dout), None
        return encoder_self_attention_bwd(qkv, lengths, *res, dout), None


def encoder_self_attention(qkv: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """K11 as the stack calls it: through ``EncoderSelfAttention`` when
    autograd records a gradient for qkv, else straight to the forward,
    saving nothing; same contract as ``encoder_self_attention_plain``."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return EncoderSelfAttention.apply(qkv, lengths)
    return encoder_self_attention_fwd(qkv, lengths, save=False)[0]


def _conv_mask(u: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return (torch.arange(u.shape[0], device=u.device)[:, None] < lengths[None, :]).to(u.dtype)


def conformer_conv_plain(u: torch.Tensor, b_in: torch.Tensor, dw: torch.Tensor,
                         ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch K9: u [T,B,2d] in the compute dtype (the first
    pointwise product), b_in [2d], dw [k,1,d] (the reference's layout), the
    depthwise LayerNorm's scale / bias [d], lengths [B] -> [T,B,d] in the
    compute dtype, the operand of the second pointwise product."""
    cdt = u.dtype
    d, k = u.shape[-1] // 2, dw.shape[0]
    mask = _conv_mask(u, lengths)
    a, gate = (u + b_in.to(cdt)).split(d, dim=-1)
    y = a * torch.sigmoid(gate) * mask[:, :, None]               # GLU, padded steps zeroed
    x = F.conv1d(y.float().permute(1, 2, 0), dw.float()[:, 0, :].t()[:, None, :],
                 padding=k // 2, groups=d)                       # [B, d, T], SAME
    z = layer_norm(x.permute(2, 0, 1), ln_scale, ln_bias)
    return (z * torch.sigmoid(z)).to(cdt)                        # swish


def conformer_conv_bwd_plain(u: torch.Tensor, b_in: torch.Tensor, dw: torch.Tensor,
                             ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                             lengths: torch.Tensor, dout: torch.Tensor):
    """Plain-PyTorch K9 backward, recomputing the forward: the forward's
    operands and the output's cotangent dout [T,B,d] -> (du [T,B,2d] in the
    compute dtype, db_in, ddw [k,1,d], dln_scale, dln_bias in their
    parameters' dtypes).  The rounding points of JAX's autodiff of the
    reference: the swish, LayerNorm and conv backward in fp32; the conv
    input's cotangent rounded to the compute dtype (the transpose of its
    cast to fp32), the mask, then the GLU backward in the compute dtype with
    the logistic JVP ``t * (s * sigmoid(-gate))``; db_in the fp32 sum of du
    rounded once to the compute dtype (the transpose of the bias's cast)."""
    cdt = u.dtype
    T = u.shape[0]
    d, k = u.shape[-1] // 2, dw.shape[0]
    half = k // 2
    mask = _conv_mask(u, lengths)[:, :, None]
    a, gate = (u + b_in.to(cdt)).split(d, dim=-1)
    s = torch.sigmoid(gate)
    y = (a * s * mask).float()
    w = dw.float()[:, 0, :]                                      # [k, d]
    yp = F.pad(y, (0, 0, 0, 0, half, half))                      # [T + k - 1, B, d]
    x = sum(yp[j:j + T] * w[j] for j in range(k))
    mu = x.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((x - mu).square().mean(dim=-1, keepdim=True) + 1e-6)
    xh = (x - mu) * rstd
    z = xh * ln_scale.float() + ln_bias.float()
    sz = torch.sigmoid(z)
    g = dout.float()
    dz = g * sz + (z * g) * (sz * torch.sigmoid(-z))             # swish
    dln_scale = (dz * xh).sum(dim=(0, 1))
    dln_bias = dz.sum(dim=(0, 1))
    dxh = dz * ln_scale.float()
    dx = rstd * (dxh - dxh.mean(dim=-1, keepdim=True)
                 - xh * (dxh * xh).mean(dim=-1, keepdim=True))   # LayerNorm
    ddw = torch.stack([(yp[j:j + T] * dx).sum(dim=(0, 1)) for j in range(k)])
    dxp = F.pad(dx, (0, 0, 0, 0, half, half))
    dy = sum(dxp[k - 1 - j:k - 1 - j + T] * w[j] for j in range(k))  # taps reversed
    dy = dy.to(cdt) * mask
    da = dy * s
    dgate = (dy * a) * (s * torch.sigmoid(-gate))                # GLU
    du = torch.cat([da, dgate], dim=-1)
    db_in = du.float().sum(dim=(0, 1)).to(cdt)
    return (du, db_in.to(b_in.dtype), ddw[:, None, :].to(dw.dtype), dln_scale.to(ln_scale.dtype),
            dln_bias.to(ln_bias.dtype))


def conformer_conv_fwd(u: torch.Tensor, b_in: torch.Tensor, dw: torch.Tensor,
                       ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """K9 forward: the CUDA kernel for GPU tensors (bf16 policy), the plain
    version on the CPU; same contract as ``conformer_conv_plain``."""
    if u.device.type == "cpu":
        return conformer_conv_plain(u, b_in, dw, ln_scale, ln_bias, lengths)
    check_policy(u.dtype, "K9")
    return kernels.conformer_conv_fwd(
        u.contiguous(), b_in.to(torch.bfloat16).contiguous(),
        dw.float().reshape(dw.shape[0], -1).contiguous(), ln_scale.float().contiguous(),
        ln_bias.float().contiguous(), lengths.to(torch.int32).contiguous())


def conformer_conv_bwd(u: torch.Tensor, b_in: torch.Tensor, dw: torch.Tensor,
                       ln_scale: torch.Tensor, ln_bias: torch.Tensor, lengths: torch.Tensor,
                       dout: torch.Tensor):
    """K9 backward: the CUDA kernel for GPU tensors, the plain twin on the
    CPU; same contract as ``conformer_conv_bwd_plain``."""
    if u.device.type == "cpu":
        return conformer_conv_bwd_plain(u, b_in, dw, ln_scale, ln_bias, lengths, dout)
    check_policy(u.dtype, "K9")
    du, db_in, ddw, dln_scale, dln_bias = kernels.conformer_conv_bwd(
        u.contiguous(), b_in.to(torch.bfloat16).contiguous(),
        dw.float().reshape(dw.shape[0], -1).contiguous(), ln_scale.float().contiguous(),
        ln_bias.float().contiguous(), lengths.to(torch.int32).contiguous(),
        dout.to(torch.bfloat16).contiguous())
    return (du, db_in.to(b_in.dtype), ddw.reshape(dw.shape).to(dw.dtype),
            dln_scale.to(ln_scale.dtype), dln_bias.to(ln_bias.dtype))


class ConformerConv(torch.autograd.Function):
    """K9 with its gradient; the backward recomputes the forward from the
    saved inputs."""

    @staticmethod
    def forward(ctx, u, b_in, dw, ln_scale, ln_bias, lengths):
        ctx.save_for_backward(u, b_in, dw, ln_scale, ln_bias, lengths)
        return conformer_conv_fwd(u, b_in, dw, ln_scale, ln_bias, lengths)

    @staticmethod
    def backward(ctx, dout):
        return (*conformer_conv_bwd(*ctx.saved_tensors, dout), None)


def conformer_conv(u: torch.Tensor, b_in: torch.Tensor, dw: torch.Tensor,
                   ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """K9 as the stack calls it: through ``ConformerConv`` when autograd
    records a gradient for any operand, else straight to the forward; same
    contract as ``conformer_conv_plain``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (u, b_in, dw, ln_scale, ln_bias)):
        return ConformerConv.apply(u, b_in, dw, ln_scale, ln_bias, lengths)
    return conformer_conv_fwd(u, b_in, dw, ln_scale, ln_bias, lengths)


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """The reference's ``inverted_dropout``: ``where(keep, x / keep_prob, 0)``,
    the keep mask drawn through ``rng.dropout_mask``."""
    keep = 1.0 - rate
    return torch.where(dropout_mask(generator, keep, x.shape) > 0, x / keep, 0.0)


def transformer_encoder_apply(params: Params, cfg: EncoderConfig, x_tbd: torch.Tensor,
                              lengths: torch.Tensor, cdt: torch.dtype, *, train: bool = False,
                              generator: Optional[torch.Generator] = None):
    """[T, B, D] features -> ([T_out, B, d] fp32, zeros at padded steps;
    (summary,)), the summary being the masked mean over valid output steps
    (no caller reads it).  Train mode with ``dropout_rate > 0`` drops out
    each layer's attention, conv and FFN branches, drawing from
    ``generator``."""
    from avsr_tpu_torch.models.encoder import _step_mask, _time_reduce, time_reductions

    d = validate_transformer_config(cfg)
    drop = cfg.dropout_rate if train else 0.0
    if drop > 0.0 and generator is None:
        raise ValueError("train mode with encoder dropout needs a generator")
    reductions = time_reductions(cfg)
    nh = cfg.num_heads
    dev = x_tbd.device

    mask = _step_mask(x_tbd.shape[0], lengths)
    h = x_tbd * mask[:, :, None]
    if reductions[0] > 1:
        h = _time_reduce(h, reductions[0])
        lengths = -(-lengths // reductions[0])
        mask = _step_mask(h.shape[0], lengths)
    h = h.to(cdt) @ params["in_proj"].to(cdt) + params["in_bias"].to(cdt)
    h = h.float() * math.sqrt(d) + sinusoidal_pe(h.shape[0], d, dev)[:, None, :]
    h = h * mask[:, :, None]

    for i, layer in enumerate(params["layers"]):
        if i > 0 and reductions[i] > 1:
            h = _time_reduce(h * mask[:, :, None], reductions[i])
            lengths = -(-lengths // reductions[i])
            mask = _step_mask(h.shape[0], lengths)
            h = (h.to(cdt) @ layer["fold"].to(cdt)).float()
        Tl, B = h.shape[0], h.shape[1]

        # self attention (pre-LN): one [d, 3d] product, K11, wo
        y = layer_norm(h, layer["ln1_scale"], layer["ln1_bias"]).to(cdt).transpose(0, 1)
        wqkv = torch.cat([layer["wq"].to(cdt), layer["wk"].to(cdt), layer["wv"].to(cdt)], dim=1)
        qkv = (y @ wqkv).reshape(B, Tl, 3, nh, d // nh)
        ctx = encoder_self_attention(qkv, lengths).reshape(B, Tl, d)
        att = (ctx @ layer["wo"].to(cdt)).transpose(0, 1).float()
        h = h + (_dropout(att, drop, generator) if drop > 0.0 else att)

        # conformer conv module (pre-LN): pointwise, K9, pointwise
        if cfg.conv_kernel is not None:
            y = layer_norm(h, layer["conv_ln_scale"], layer["conv_ln_bias"])
            u = (y * mask[:, :, None]).to(cdt) @ layer["conv_w_in"].to(cdt)
            y = conformer_conv(u, layer["conv_b_in"], layer["conv_dw"],
                               layer["conv_dw_ln_scale"], layer["conv_dw_ln_bias"], lengths)
            y = (y @ layer["conv_w_out"].to(cdt) + layer["conv_b_out"].to(cdt)).float()
            h = h + (_dropout(y, drop, generator) if drop > 0.0 else y)

        # feed-forward (pre-LN), tanh-form GELU
        y = layer_norm(h, layer["ln2_scale"], layer["ln2_bias"]).to(cdt)
        y = F.gelu(y @ layer["ff_w1"].to(cdt) + layer["ff_b1"].to(cdt), approximate="tanh")
        y = (y @ layer["ff_w2"].to(cdt) + layer["ff_b2"].to(cdt)).float()
        h = h + (_dropout(y, drop, generator) if drop > 0.0 else y)

    out = layer_norm(h, params["ln_f_scale"], params["ln_f_bias"]) * mask[:, :, None]
    summary = out.sum(dim=0) / torch.clamp(mask.sum(dim=0), min=1.0)[:, None]
    return out, (summary,)
