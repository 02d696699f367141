"""Decoder dispatch (counterpart of ``avsr_tpu/models/decoder.py``).

The port carries the transformer decoder only; the attention-LSTM decoder
of the reference-dims model is later work, and asking for it raises.
"""

from __future__ import annotations

from typing import Sequence

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
