"""Decoder dispatch, the attention-LSTM decoder step and the sequence loss
(counterpart of ``avsr_tpu/models/decoder.py``).

Two families, picked by ``DecoderConfig.decoder_type``:

* ``"transformer"``: ``models/transformer_decoder.py`` (KV-cache decode
  step, parallel teacher forcing);
* ``"rnn"``: the reference's attention LSTM.  One decode step embeds the
  previous token, runs the LSTM stack on ``[embedding ; previous
  contexts]`` (input feeding), reads each memory with Bahdanau or Luong
  attention (kernel K10 on a GPU, ``ops/attention.py``) queried by the top
  layer's h, and projects ``[h ; contexts]`` to the vocabulary.  The gate and
  output products stay matrix products, as the reference leaves them to
  XLA.  Teacher forcing is a host loop over the label positions through
  the same ``decoder_step``, with the reference's scheduled sampling (a
  Bernoulli(p) coin per row per step after step 0 feeds the model's own
  Gumbel-max sample of the previous step's logits) and variational dropout
  (one mask per layer per sequence on each layer's output; the state keeps
  the undropped h).  Every draw comes from the caller's generator on the
  batch's device, so the loop never waits on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from avsr_tpu_torch.configs import DecoderConfig
from avsr_tpu_torch.data.units import GO_ID
from avsr_tpu_torch.models import transformer_decoder as tdec
from avsr_tpu_torch.ops import attention as attn
from avsr_tpu_torch.ops import rnn
from avsr_tpu_torch.utils import rng
from avsr_tpu_torch.utils.numerics import dot_f32
from avsr_tpu_torch.utils.params import Params, glorot_uniform, normal_init, zeros


class DecoderState(NamedTuple):
    """Per-step state of the RNN decoder (carried through beam search)."""

    lstm: Tuple      # per layer (h, c), each [N, H] fp32
    contexts: Tuple  # per memory, [N, Dv] fp32


def _is_transformer(cfg: DecoderConfig) -> bool:
    if cfg.decoder_type == "transformer":
        return True
    if cfg.decoder_type != "rnn":
        raise ValueError(f"unknown decoder_type {cfg.decoder_type!r}")
    return False


def decoder_init(gen: torch.Generator, cfg: DecoderConfig, memory_dims: Sequence[int],
                 vocab_size: int, device) -> Params:
    if _is_transformer(cfg):
        return tdec.transformer_decoder_init(gen, cfg, memory_dims, vocab_size, device)
    ctx_dims = [cfg.memory_value_dim or m for m in memory_dims]
    total_ctx = sum(ctx_dims)
    params: Params = {
        "embedding": normal_init(gen, (vocab_size, cfg.embedding_dim), device),
        "cells": [],
        "atts": [],
    }
    d = cfg.embedding_dim + total_ctx  # input feeding: [embedding ; contexts]
    for h in cfg.hidden_units:
        params["cells"].append(rnn.lstm_init(gen, d, h, device))
        d = h
    top = cfg.hidden_units[-1]
    for m in memory_dims:
        params["atts"].append(attn.attention_init(cfg.attention_type, gen, top, m,
                                                  cfg.attention_units, device,
                                                  value_dim=cfg.memory_value_dim))
    params["out_w"] = glorot_uniform(gen, (top + total_ctx, vocab_size), device)
    params["out_b"] = zeros((vocab_size,), device)
    return params


def initial_state(cfg: DecoderConfig, batch: int, max_length: int, cdt: torch.dtype, device,
                  memory_dims: Optional[Sequence[int]] = None):
    """The transformer's zeroed KV caches (horizon ``max_length``), or the
    RNN decoder's zero (h, c) per layer and zero context per memory, whose
    widths ``memory_dims`` gives (the prepared memories' value widths)."""
    if _is_transformer(cfg):
        return tdec.initial_cache(cfg, batch, max_length, cdt, device)
    if memory_dims is None:
        raise ValueError("the RNN decoder state needs memory_dims (its context widths)")

    def z(n):
        return torch.zeros((batch, n), dtype=torch.float32, device=device)

    return DecoderState(lstm=tuple((z(h), z(h)) for h in cfg.hidden_units),
                        contexts=tuple(z(m) for m in memory_dims))


def prepare_cross(params: Params, cfg: DecoderConfig,
                  memories: Sequence[attn.AttentionMemory], cdt: torch.dtype):
    """The transformer's loop-invariant cross-attention keys; None for the
    RNN family."""
    if _is_transformer(cfg):
        return tdec.prepare_cross(params, cfg, memories, cdt)
    return None


def decoder_step(params: Params, cfg: DecoderConfig, tokens: torch.Tensor, state,
                 memories: Sequence[attn.AttentionMemory], cross_kv, cdt: torch.dtype, *,
                 dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                 read_loops: Optional[Sequence[Optional[attn.ReadLoop]]] = None):
    """One decode step for every row: (new state, fp32 logits [N, V]).
    ``dropout_masks`` (RNN decoder, training): one [N, H] mask per layer,
    multiplied into that layer's output; the state keeps the undropped h.
    ``read_loops`` (RNN decoder, training): per memory the read loop this
    step's read belongs to (``attn.open_read_loop``), or None."""
    if _is_transformer(cfg):
        return tdec.decode_step(params, cfg, tokens, state, memories, cross_kv, cdt)
    x = torch.cat([params["embedding"][tokens], *state.contexts], dim=-1)
    new_lstm = []
    h = x
    for li, (cell, st) in enumerate(zip(params["cells"], state.lstm)):
        (h, c), _ = rnn.lstm_step(cell, h, st, cdt)
        new_lstm.append((h, c))
        if dropout_masks is not None:
            h = h * dropout_masks[li]
    loops = read_loops or (None,) * len(memories)
    contexts = tuple(attn.attend(cfg.attention_type, att, h, mem, cdt, loop=loop)[0]
                     for att, mem, loop in zip(params["atts"], memories, loops))
    logits = dot_f32(torch.cat([h, *contexts], dim=-1), params["out_w"], cdt) + params["out_b"]
    return DecoderState(lstm=tuple(new_lstm), contexts=contexts), logits


def gumbel_max(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row of ``logits`` [N, V] (int64 [N]), as
    ``jax.random.categorical`` draws it: the argmax of the logits plus
    Gumbel noise, the uniforms kept off 0 as ``jax.random.gumbel`` keeps
    them.  No gradient flows through the draw."""
    u = torch.rand(logits.shape, generator=generator, device=generator.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.detach().float() - torch.log(-torch.log(u)), dim=-1)


def teacher_forced_logits(params: Params, cfg: DecoderConfig, targets: torch.Tensor,
                          target_lengths: torch.Tensor,
                          memories: Sequence[attn.AttentionMemory], cdt: torch.dtype, *,
                          generator: Optional[torch.Generator] = None,
                          dropout: bool = False,
                          sampling_probability: float = 0.0) -> torch.Tensor:
    """Training-time decode over gold targets [B, K] (incl. EOS): fp32
    logits [B, K, V].  The transformer's parallel pass is teacher forcing
    (it takes no scheduled sampling).  The RNN decoder runs K steps, step
    k consuming token k-1 (GO at k = 0); with a generator and a sampling
    probability p > 0 (a host float: the train step's ramp), each row's
    input after step 0 is, with probability p, the model's own sample of
    the previous step's logits; with ``dropout`` and a generator, one
    variational-dropout mask [B, H] per layer for the whole sequence.  Under
    autograd each memory's K reads form one read loop."""
    if _is_transformer(cfg):
        return tdec.teacher_forced_logits(params, cfg, targets, target_lengths, memories, cdt,
                                          generator=generator, dropout=dropout)
    B, K = targets.shape
    dev = targets.device
    state = initial_state(cfg, B, K, cdt, dev,
                          memory_dims=[m.values.shape[-1] for m in memories])
    masks = None
    if cfg.dropout_rate > 0.0 and generator is not None and dropout:
        keep = 1.0 - cfg.dropout_rate
        masks = tuple(rng.dropout_mask(generator, keep, (B, h)) for h in cfg.hidden_units)
    sampling = generator is not None and sampling_probability > 0.0
    loops = tuple(attn.open_read_loop(cfg.attention_type, att, mem, cdt, K)
                  for att, mem in zip(params["atts"], memories))
    tok = torch.full((B,), GO_ID, dtype=torch.long, device=dev)
    logits = []
    for k in range(K):
        if k > 0:
            tok = targets[:, k - 1].long()
            if sampling:  # never at step 0: there is no previous prediction
                coin = torch.rand((B,), generator=generator, device=dev) < sampling_probability
                tok = torch.where(coin, sampled, tok)
        state, step_logits = decoder_step(params, cfg, tok, state, memories, None, cdt,
                                          dropout_masks=masks, read_loops=loops)
        logits.append(step_logits)
        if sampling:
            sampled = gumbel_max(generator, step_logits)
    return torch.stack(logits, dim=1)


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
