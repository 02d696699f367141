"""Encoder stacks (counterpart of ``avsr_tpu/models/encoder.py``): the
stacked BiLSTM (one direction-fused K1 scan per layer) or, with
``bidirectional=False``, the stacked one-direction LSTM (one K2 scan per
layer); with ``layer_norm`` the same stacks of LN-LSTM layers (one K13
scan per layer, either way); with ``cell_type="gru"`` the same stacks of
GRU layers (one K12 scan per layer; GRU cells ignore ``layer_norm``, as the
reference's do); and ``encoder_type="transformer"`` dispatched to
``models/transformer.py`` (the ``lrs2_av_v2`` preset's encoders).

Time-major [T, B, D] throughout.  Pyramidal time reduction folds r
consecutive frames into the feature dim before a layer (padded steps are
zeroed first, so a partly valid last group carries zeros).  After each RNN
layer's scan come the reference's wrappers (``_post_layer``): a residual
sum where the layer keeps its width (``residual``, checked on shapes at
apply time, and winning over highway), else a highway gate where init gave
the layer one (``highway``, where d * r == d_out), then in train mode
inverted dropout on the output; each transformer layer gets its
residual-branch dropout instead.  In train mode an LSTM layer also draws
variational recurrent dropout masks (``recurrent_dropout_rate``, two [B, H]
masks a layer, one a direction, as the reference draws them; GRU layers
ignore the rate, as the reference's do; LN-LSTM layers take the masks on
K13).  All draws come from the step's generator.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from avsr_tpu_torch.configs import EncoderConfig
from avsr_tpu_torch.models import transformer as tfm
from avsr_tpu_torch.ops import rnn
from avsr_tpu_torch.utils.numerics import dot_f32
from avsr_tpu_torch.utils.params import Params, glorot_uniform
from avsr_tpu_torch.utils.rng import dropout_mask


def time_reductions(cfg: EncoderConfig) -> Tuple[int, ...]:
    """Per-layer input time-reduction factors, validated (all-1 if unset)."""
    if cfg.time_reduction is None:
        return (1,) * len(cfg.hidden_units)
    r = tuple(int(x) for x in cfg.time_reduction)
    if len(r) != len(cfg.hidden_units) or any(x < 1 for x in r):
        raise ValueError(
            f"time_reduction {cfg.time_reduction} must list one factor >= 1 "
            f"per layer ({len(cfg.hidden_units)} layers)")
    return r


def total_time_reduction(cfg: EncoderConfig) -> int:
    return math.prod(time_reductions(cfg))


def encoder_output_lengths(cfg: EncoderConfig, lengths):
    """Valid-step counts of the encoder output (successive ceil-division)."""
    for r in time_reductions(cfg):
        if r > 1:
            lengths = -(-lengths // r)
    return lengths


def _check_supported(cfg: EncoderConfig) -> None:
    if cfg.encoder_type not in ("rnn", "transformer"):
        raise ValueError(f"unknown encoder_type {cfg.encoder_type!r}")
    if cfg.encoder_type == "transformer":
        return  # tfm.validate_transformer_config checks the stack's own knobs
    if cfg.conv_kernel is not None:
        raise ValueError(
            "EncoderConfig.conv_kernel is transformer-only (the conformer conv module); the "
            "RNN stack is already local")
    if cfg.cell_type not in ("lstm", "gru"):
        raise ValueError(f"unknown cell type {cfg.cell_type}")


def encoder_init(gen: torch.Generator, cfg: EncoderConfig, input_dim: int,
                 device) -> Params:
    _check_supported(cfg)
    if cfg.encoder_type == "transformer":
        return tfm.transformer_encoder_init(gen, cfg, input_dim, device)
    layers = []
    d = input_dim
    for h, r in zip(cfg.hidden_units, time_reductions(cfg)):
        d *= r
        layer = {"fwd": rnn.cell_init(cfg.cell_type, gen, d, h, device,
                                      layer_norm=cfg.layer_norm)}
        if cfg.bidirectional:
            layer["bwd"] = rnn.cell_init(cfg.cell_type, gen, d, h, device,
                                         layer_norm=cfg.layer_norm)
        d_out = 2 * h if cfg.bidirectional else h
        if cfg.highway and d == d_out:
            # transform-gate bias -1: the layer starts close to carrying its input
            layer["hw_w"] = glorot_uniform(gen, (d, d_out), device)
            layer["hw_b"] = torch.full((d_out,), -1.0, dtype=torch.float32, device=device)
        layers.append(layer)
        d = d_out
    return {"layers": layers}


def encoder_output_dim(cfg: EncoderConfig) -> int:
    h = cfg.hidden_units[-1]
    if cfg.encoder_type == "transformer":
        return h  # d_model; self attention is bidirectional
    return 2 * h if cfg.bidirectional else h


def _time_reduce(h: torch.Tensor, r: int) -> torch.Tensor:
    """[T, B, D] -> [ceil(T/r), B, r*D]: concat r consecutive frames."""
    T, B, D = h.shape
    Tp = -(-T // r) * r
    if Tp != T:
        h = torch.nn.functional.pad(h, (0, 0, 0, 0, 0, Tp - T))
    return h.reshape(Tp // r, r, B, D).permute(0, 2, 1, 3).reshape(Tp // r, B, r * D)


def _step_mask(T: int, lengths: torch.Tensor) -> torch.Tensor:
    return (torch.arange(T, device=lengths.device)[:, None] < lengths[None, :]).float()


def _rd_masks(layer: Params, cfg: EncoderConfig, B: int, train: bool,
              generator: Optional[torch.Generator]):
    """Variational recurrent dropout masks (the reference's ``_rd_masks``):
    two fixed [B, H] fp32 masks a layer, one a direction (two for a
    one-direction layer too, which uses the first), or None: only in train
    mode with a generator, a positive rate and LSTM cells."""
    if not (train and cfg.recurrent_dropout_rate > 0.0 and generator is not None
            and cfg.cell_type == "lstm"):
        return None
    keep = 1.0 - cfg.recurrent_dropout_rate
    H = layer["fwd"]["wh"].shape[0]
    return dropout_mask(generator, keep, (B, H)), dropout_mask(generator, keep, (B, H))


def _layer_scan(layer: Params, cfg: EncoderConfig, h, mask, rd_masks, cdt):
    if cfg.bidirectional:
        return rnn.bidirectional_scan(cfg.cell_type, layer["fwd"], layer["bwd"], h, mask, cdt,
                                      recurrent_dropout_masks=rd_masks)
    return rnn.rnn_scan(cfg.cell_type, layer["fwd"], h, mask, cdt=cdt,
                        recurrent_dropout_mask=None if rd_masks is None else rd_masks[0])


def _post_layer(layer: Params, cfg: EncoderConfig, prev, h, train: bool,
                generator: Optional[torch.Generator], cdt):
    """The reference's ``_post_layer``: a residual sum where the layer keeps
    its width, else the highway gate where init gave the layer one (t =
    sigmoid(bf16(prev) @ bf16(hw_w) + hw_b), fp32; t * h + (1 - t) * prev),
    then the output dropout in train mode.  The dtypes promote as JAX's do:
    bf16 + bf16 stays bf16, bf16 with fp32 becomes fp32."""
    if cfg.residual and prev.shape[-1] == h.shape[-1]:
        h = h + prev
    elif "hw_w" in layer:
        t = torch.sigmoid(dot_f32(prev, layer["hw_w"], cdt) + layer["hw_b"])
        h = t * h + (1.0 - t) * prev
    if train and cfg.dropout_rate > 0.0 and generator is not None:
        keep = 1.0 - cfg.dropout_rate
        h = h * dropout_mask(generator, keep, h.shape, h.dtype)
    return h


def encoder_apply(params: Params, cfg: EncoderConfig, x_tbd: torch.Tensor,
                  lengths: torch.Tensor, cdt: torch.dtype, *, train: bool = False,
                  generator: Optional[torch.Generator] = None):
    """[T, B, D] features -> ([T_out, B, 2H] fp32 (H unidirectional, d for
    the transformer), zeros at padded steps; final state of the last layer:
    ((hT_f, cT_f), (hT_b, cT_b)) bidirectional LSTM, (hT, cT)
    unidirectional, (hT_f, hT_b) / hT for GRU layers, or the transformer's
    summary).  ``train`` with a generator draws the LSTM layers' recurrent
    dropout masks and applies the RNN layers' output dropout or the
    transformer layers' branch dropout."""
    _check_supported(cfg)
    if cfg.encoder_type == "transformer":
        return tfm.transformer_encoder_apply(params, cfg, x_tbd, lengths, cdt, train=train,
                                             generator=generator)
    mask = _step_mask(x_tbd.shape[0], lengths)
    h = x_tbd
    final_state = None
    for layer, r in zip(params["layers"], time_reductions(cfg)):
        if r > 1:
            h = _time_reduce(h * mask[:, :, None], r)
            lengths = -(-lengths // r)
            mask = _step_mask(h.shape[0], lengths)
        prev = h
        rd_masks = _rd_masks(layer, cfg, h.shape[1], train, generator)
        h, final_state = _layer_scan(layer, cfg, h, mask, rd_masks, cdt)
        h = _post_layer(layer, cfg, prev, h, train, generator, cdt)
    return h * mask[:, :, None], final_state
