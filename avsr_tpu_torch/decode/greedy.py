"""Greedy decoding (counterpart of ``avsr_tpu/decode/greedy.py``).

The eval-time decode of the JAX package (``AVSR.evaluate(greedy=True)``):
every row feeds back its argmax, with PAD and GO masked to -1e30 first; a
row that has emitted EOS writes PAD from then on and is fed EOS; the loop
exits early, on the host, once every row is done.  Lengths count up to the
first EOS inclusive, or the horizon.  Each step is the decoder's
``decoder_step``, so on a GPU it runs the single-query attention kernel K6
(transformer decoder) or the attention read K10 (RNN decoder).  The decode
runs under ``torch.inference_mode()``: parameters that require a gradient
(a train state's) record no graph and take no kernel's save path.  Results
are returned as CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from avsr_tpu_torch.configs import DecoderConfig
from avsr_tpu_torch.data.units import EOS_ID, GO_ID, PAD_ID
from avsr_tpu_torch.models import decoder as dec
from avsr_tpu_torch.ops import attention as attn
from avsr_tpu_torch.utils.numerics import full_precision


class GreedyResult(NamedTuple):
    ids: torch.Tensor      # [B, L] int64, PAD after EOS
    lengths: torch.Tensor  # [B] int32, tokens up to and including the first EOS
    steps: int             # decode steps actually executed (early exit)


@torch.inference_mode()
def greedy_decode(params, cfg: DecoderConfig, memories: Sequence[attn.AttentionMemory],
                  max_length: int, *, cdt: torch.dtype = torch.bfloat16) -> GreedyResult:
    with full_precision(cdt):
        return _greedy_decode(params, cfg, memories, max_length, cdt)


def _greedy_decode(params, cfg: DecoderConfig, memories: Sequence[attn.AttentionMemory],
                   max_length: int, cdt: torch.dtype) -> GreedyResult:
    B = memories[0].values.shape[0]
    dev = memories[0].values.device
    # the values in the compute dtype and contiguous once, not at every step
    # (keys that are the values, a Luong memory's, stay one tensor)
    def prepared(m):
        values = m.values.to(cdt).contiguous()
        keys = values if m.keys is m.values else (
            None if m.keys is None else m.keys.contiguous())
        return attn.AttentionMemory(values=values, keys=keys, mask=m.mask.contiguous(),
                                    bias=m.bias.contiguous())

    memories = [prepared(m) for m in memories]
    state = dec.initial_state(cfg, B, max_length, cdt, dev,
                              memory_dims=[m.values.shape[-1] for m in memories])
    cross_kv = dec.prepare_cross(params, cfg, memories, cdt)
    tok = torch.full((B,), GO_ID, dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    ids_buf = torch.full((max_length, B), PAD_ID, dtype=torch.long, device=dev)

    t = 0
    while t < max_length and not bool(done.all()):
        state, logits = dec.decoder_step(params, cfg, tok, state, memories, cross_kv, cdt)
        logits[:, PAD_ID] = -1e30
        logits[:, GO_ID] = -1e30
        nxt = torch.argmax(logits, dim=-1)
        ids_buf[t] = torch.where(done, torch.full_like(nxt, PAD_ID), nxt)
        tok = torch.where(done, torch.full_like(nxt, EOS_ID), nxt)
        done = done | (nxt == EOS_ID)
        t += 1

    ids = ids_buf.T.cpu()
    is_eos = ids == EOS_ID
    lengths = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1,
                          torch.full((B,), max_length)).to(torch.int32)
    return GreedyResult(ids=ids, lengths=lengths, steps=t)
