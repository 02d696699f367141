"""Decoder dispatch and the sequence loss (counterpart of
``avsr_tpu/models/decoder.py``).

The port carries the transformer decoder only; the attention-LSTM decoder
of the reference-dims model (and with it scheduled sampling) is later
work, and asking for it raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from avsr_tpu.configs import DecoderConfig
from avsr_tpu_torch.models import transformer_decoder as tdec
from avsr_tpu_torch.ops import attention as attn
from avsr_tpu_torch.utils.params import Params


def _check(cfg: DecoderConfig) -> None:
    if cfg.decoder_type != "transformer":
        raise ValueError(f"the port's decoder is the transformer decoder, got {cfg.decoder_type!r}")


def decoder_init(gen: torch.Generator, cfg: DecoderConfig, memory_dims: Sequence[int],
                 vocab_size: int, device="cpu") -> Params:
    _check(cfg)
    return tdec.transformer_decoder_init(gen, cfg, memory_dims, vocab_size, device)


def initial_state(cfg: DecoderConfig, batch: int, max_length: int, cdt: torch.dtype,
                  device) -> tdec.TransformerDecoderState:
    _check(cfg)
    return tdec.initial_cache(cfg, batch, max_length, cdt, device)


def prepare_cross(params: Params, cfg: DecoderConfig,
                  memories: Sequence[attn.AttentionMemory], cdt: torch.dtype):
    _check(cfg)
    return tdec.prepare_cross(params, cfg, memories, cdt)


def decoder_step(params: Params, cfg: DecoderConfig, tokens: torch.Tensor, state,
                 memories: Sequence[attn.AttentionMemory], cross_kv, cdt: torch.dtype):
    _check(cfg)
    return tdec.decode_step(params, cfg, tokens, state, memories, cross_kv, cdt)


def teacher_forced_logits(params: Params, cfg: DecoderConfig, targets: torch.Tensor,
                          target_lengths: torch.Tensor,
                          memories: Sequence[attn.AttentionMemory], cdt: torch.dtype, *,
                          generator: Optional[torch.Generator] = None,
                          dropout: bool = False) -> torch.Tensor:
    """Training-time decode over gold targets [B, K] (incl. EOS): fp32
    logits [B, K, V]; the transformer's parallel pass is teacher forcing."""
    _check(cfg)
    return tdec.teacher_forced_logits(params, cfg, targets, target_lengths, memories, cdt,
                                      generator=generator, dropout=dropout)


def sequence_loss(logits: torch.Tensor, targets: torch.Tensor, target_lengths: torch.Tensor,
                  *, label_smoothing: float = 0.0) -> torch.Tensor:
    """Masked mean cross-entropy over valid label positions:
    sum(ce * mask) / sum(mask), with optional uniform label smoothing."""
    B, K, V = logits.shape
    mask = (torch.arange(K, device=logits.device)[None, :] < target_lengths[:, None]).float()
    logp = torch.log_softmax(logits, dim=-1)
    gold = torch.gather(logp, -1, targets[..., None].long()).squeeze(-1)
    if label_smoothing > 0.0:
        gold = (1.0 - label_smoothing) * gold + label_smoothing * logp.mean(dim=-1)
    return (-gold * mask).sum() / torch.clamp(mask.sum(), min=1.0)
