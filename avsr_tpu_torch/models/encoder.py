"""Stacked BiLSTM encoder (counterpart of ``avsr_tpu/models/encoder.py``).

Time-major [T, B, D] throughout.  Pyramidal time reduction folds r
consecutive frames into the feature dim before a layer (padded steps are
zeroed first, so a partly valid last group carries zeros).  In train mode
each layer's output gets inverted dropout (the reference's
``_post_layer``), drawn from the step's generator; recurrent dropout and
the residual / highway / LN variants are not ported and raise.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from avsr_tpu.configs import EncoderConfig
from avsr_tpu_torch.ops import rnn
from avsr_tpu_torch.utils.params import Params
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
    if (cfg.encoder_type != "rnn" or cfg.cell_type != "lstm" or not cfg.bidirectional
            or cfg.layer_norm or cfg.residual or cfg.highway):
        raise ValueError(
            "the port's encoder is the plain bidirectional LSTM stack "
            "(no transformer, GRU, LN, residual or highway layers)")


def encoder_init(gen: torch.Generator, cfg: EncoderConfig, input_dim: int,
                 device="cpu") -> Params:
    _check_supported(cfg)
    layers = []
    d = input_dim
    for h, r in zip(cfg.hidden_units, time_reductions(cfg)):
        d *= r
        layers.append({"fwd": rnn.lstm_init(gen, d, h, device),
                       "bwd": rnn.lstm_init(gen, d, h, device)})
        d = 2 * h
    return {"layers": layers}


def encoder_output_dim(cfg: EncoderConfig) -> int:
    return 2 * cfg.hidden_units[-1]


def _time_reduce(h: torch.Tensor, r: int) -> torch.Tensor:
    """[T, B, D] -> [ceil(T/r), B, r*D]: concat r consecutive frames."""
    T, B, D = h.shape
    Tp = -(-T // r) * r
    if Tp != T:
        h = torch.nn.functional.pad(h, (0, 0, 0, 0, 0, Tp - T))
    return h.reshape(Tp // r, r, B, D).permute(0, 2, 1, 3).reshape(Tp // r, B, r * D)


def _step_mask(T: int, lengths: torch.Tensor) -> torch.Tensor:
    return (torch.arange(T, device=lengths.device)[:, None] < lengths[None, :]).float()


def encoder_apply(params: Params, cfg: EncoderConfig, x_tbd: torch.Tensor,
                  lengths: torch.Tensor, cdt: torch.dtype, *, train: bool = False,
                  generator: Optional[torch.Generator] = None):
    """[T, B, D] features -> ([T_out, B, 2H] fp32, zeros at padded steps;
    final state of the last layer).  ``train`` with a generator applies
    the per-layer output dropout."""
    _check_supported(cfg)
    if train and cfg.recurrent_dropout_rate > 0.0:
        raise ValueError("recurrent dropout is not ported")
    mask = _step_mask(x_tbd.shape[0], lengths)
    h = x_tbd
    final_state = None
    for layer, r in zip(params["layers"], time_reductions(cfg)):
        if r > 1:
            h = _time_reduce(h * mask[:, :, None], r)
            lengths = -(-lengths // r)
            mask = _step_mask(h.shape[0], lengths)
        h, final_state = rnn.bidirectional_scan(
            cfg.cell_type, layer["fwd"], layer["bwd"], h, mask, cdt)
        if train and cfg.dropout_rate > 0.0 and generator is not None:
            keep = 1.0 - cfg.dropout_rate
            h = h * dropout_mask(generator, keep, h.shape, h.dtype)
    return h * mask[:, :, None], final_state
