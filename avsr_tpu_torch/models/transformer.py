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

Two cores are kernels; the products, LayerNorms, FFN and residuals stay
torch code, as the reference leaves them to XLA:

* K11, the self-attention core (``transformer.py:204-224``):
  ``encoder_self_attention`` launches ``csrc/encoder_attention.cu`` on the
  one [d, 3d] product, read in place, for GPU tensors and runs
  ``encoder_self_attention_plain`` for CPU tensors;
* K9, the conformer conv module between its two pointwise products
  (``transformer.py:231-266``: bias, GLU, mask, depthwise conv, LayerNorm,
  swish): ``conformer_conv`` launches ``csrc/conformer_conv.cu`` for GPU
  tensors and runs ``conformer_conv_plain`` for CPU tensors.

Only the forward is ported: both kernels have no backward yet, so a
wrapper asked for a gradient on the card raises, and so does train mode
with encoder dropout (``dropout_rate > 0``) anywhere.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from avsr_tpu_torch import kernels
from avsr_tpu_torch.configs import EncoderConfig
from avsr_tpu_torch.models.fusion import fusion_attention_fwd_plain
from avsr_tpu_torch.models.transformer_common import layer_norm, sinusoidal_pe
from avsr_tpu_torch.utils.params import Params, glorot_uniform, zeros


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


def _no_gradient_on_the_card(what: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: the kernel's backward is not ported; run the encoder under "
            "torch.inference_mode() or torch.no_grad() on the card")


def encoder_self_attention_plain(qkv: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch K11: qkv [B,T,3,nh,dh] in the compute dtype (the [d, 3d]
    product), lengths [B] -> ctx [B,T,nh,dh] in the compute dtype.  K4's
    plain core with T_q = T_k and the stack's own lengths as the key mask."""
    q, k, v = qkv.unbind(2)
    return fusion_attention_fwd_plain(q, k, v, lengths)[0]


def encoder_self_attention(qkv: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """K11 wrapper: the CUDA kernel for GPU tensors (bf16 policy, no
    gradient), the plain version on the CPU; same contract as
    ``encoder_self_attention_plain``."""
    if qkv.device.type == "cpu":
        return encoder_self_attention_plain(qkv, lengths)
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"the encoder attention kernel runs the bf16 policy only, got {qkv.dtype}")
    _no_gradient_on_the_card("encoder self attention", qkv)
    return kernels.encoder_attention_fwd(qkv.contiguous(), lengths.to(torch.int32).contiguous())


def conformer_conv_plain(u: torch.Tensor, b_in: torch.Tensor, dw: torch.Tensor,
                         ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch K9: u [T,B,2d] in the compute dtype (the first
    pointwise product), b_in [2d], dw [k,1,d] (the reference's layout), the
    depthwise LayerNorm's scale / bias [d], lengths [B] -> [T,B,d] in the
    compute dtype, the operand of the second pointwise product."""
    cdt = u.dtype
    T, _, d2 = u.shape
    d, k = d2 // 2, dw.shape[0]
    mask = (torch.arange(T, device=u.device)[:, None] < lengths[None, :]).to(cdt)
    a, gate = (u + b_in.to(cdt)).split(d2 // 2, dim=-1)
    y = a * torch.sigmoid(gate) * mask[:, :, None]               # GLU, padded steps zeroed
    x = F.conv1d(y.float().permute(1, 2, 0), dw.float()[:, 0, :].t()[:, None, :],
                 padding=k // 2, groups=d)                       # [B, d, T], SAME
    z = layer_norm(x.permute(2, 0, 1), ln_scale, ln_bias)
    return (z * torch.sigmoid(z)).to(cdt)                        # swish


def conformer_conv(u: torch.Tensor, b_in: torch.Tensor, dw: torch.Tensor,
                   ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """K9 wrapper: the CUDA kernel for GPU tensors (bf16 policy, no
    gradient), the plain version on the CPU; same contract as
    ``conformer_conv_plain``."""
    if u.device.type == "cpu":
        return conformer_conv_plain(u, b_in, dw, ln_scale, ln_bias, lengths)
    if u.dtype != torch.bfloat16:
        raise ValueError(f"the conformer conv kernel runs the bf16 policy only, got {u.dtype}")
    _no_gradient_on_the_card("conformer conv", u, b_in, dw, ln_scale, ln_bias)
    return kernels.conformer_conv_fwd(
        u.contiguous(), b_in.to(torch.bfloat16).contiguous(),
        dw.float().reshape(dw.shape[0], -1).contiguous(), ln_scale.float().contiguous(),
        ln_bias.float().contiguous(), lengths.to(torch.int32).contiguous())


def transformer_encoder_apply(params: Params, cfg: EncoderConfig, x_tbd: torch.Tensor,
                              lengths: torch.Tensor, cdt: torch.dtype, *, train: bool = False):
    """[T, B, D] features -> ([T_out, B, d] fp32, zeros at padded steps;
    (summary,)), the summary being the masked mean over valid output steps
    (no caller reads it).  Train mode with ``dropout_rate > 0`` raises."""
    from avsr_tpu_torch.models.encoder import _step_mask, _time_reduce, time_reductions

    d = validate_transformer_config(cfg)
    if train and cfg.dropout_rate > 0.0:
        raise NotImplementedError(
            "train mode with dropout in the transformer encoder is not ported")
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
        h = h + (ctx @ layer["wo"].to(cdt)).transpose(0, 1).float()

        # conformer conv module (pre-LN): pointwise, K9, pointwise
        if cfg.conv_kernel is not None:
            y = layer_norm(h, layer["conv_ln_scale"], layer["conv_ln_bias"])
            u = (y * mask[:, :, None]).to(cdt) @ layer["conv_w_in"].to(cdt)
            y = conformer_conv(u, layer["conv_b_in"], layer["conv_dw"],
                               layer["conv_dw_ln_scale"], layer["conv_dw_ln_bias"], lengths)
            h = h + (y @ layer["conv_w_out"].to(cdt) + layer["conv_b_out"].to(cdt)).float()

        # feed-forward (pre-LN), tanh-form GELU
        y = layer_norm(h, layer["ln2_scale"], layer["ln2_bias"]).to(cdt)
        y = F.gelu(y @ layer["ff_w1"].to(cdt) + layer["ff_b1"].to(cdt), approximate="tanh")
        h = h + (y @ layer["ff_w2"].to(cdt) + layer["ff_b2"].to(cdt)).float()

    out = layer_norm(h, params["ln_f_scale"], params["ln_f_bias"]) * mask[:, :, None]
    summary = out.sum(dim=0) / torch.clamp(mask.sum(dim=0), min=1.0)[:, None]
    return out, (summary,)
