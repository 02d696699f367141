"""Batched width-W beam search (counterpart of ``avsr_tpu/decode/beam.py``).

Same semantics as the reference, top-1 only:

* beams are folded into the batch axis, contiguous per row ([B*W]);
* PAD and GO are masked AFTER the log-softmax, so surviving scores are
  true model log probs; finished beams continue with an EOS-only,
  zero-score row;
* candidates are ranked by length-normalized score ((5+len)/6)^alpha and
  the top W of each row's W*V candidates are taken with a STABLE
  descending sort, so ties resolve to the lower flat index exactly like
  ``lax.top_k``;
* the decoder state is gathered by parent every step;
* the loop exits early, on the host, once every beam of every row is
  finished or dead (score still ~NEG_INF) — the remaining steps would only
  append zero-score EOS continuations;
* the (token, parent) trellis is backtracked from the best leaf, on the
  host, and everything after the first EOS becomes PAD.

Results are returned as CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from avsr_tpu.configs import DecoderConfig
from avsr_tpu.data.units import EOS_ID, GO_ID, PAD_ID
from avsr_tpu_torch.models import decoder as dec
from avsr_tpu_torch.ops import attention as attn

NEG_INF = -1.0e30


class BeamResult(NamedTuple):
    ids: torch.Tensor      # [B, L] best hypothesis, PAD after EOS
    lengths: torch.Tensor  # [B] tokens incl. EOS
    scores: torch.Tensor   # [B] length-normalized log prob of the winner
    steps: int             # decode steps actually executed (early exit)


def _length_penalty(lengths: torch.Tensor, alpha: float) -> torch.Tensor:
    if alpha == 0.0:
        return torch.ones_like(lengths, dtype=torch.float32)
    return torch.pow((5.0 + lengths.float()) / 6.0, alpha)


def _tile_memory(mem: attn.AttentionMemory, width: int) -> attn.AttentionMemory:
    """[B, ...] -> [B*W, ...] with beams contiguous per batch row."""
    return attn.AttentionMemory(*(x.repeat_interleave(width, dim=0) for x in mem))


def beam_search(params, cfg: DecoderConfig, memories: Sequence[attn.AttentionMemory],
                max_length: int, *, beam_width: int = 10, length_penalty: float = 0.0,
                cdt: torch.dtype = torch.bfloat16) -> BeamResult:
    B = memories[0].values.shape[0]
    W = beam_width
    dev = memories[0].values.device
    tiled = [_tile_memory(m, W) for m in memories]
    state = dec.initial_state(cfg, B * W, max_length, cdt, dev)
    cross_kv = dec.prepare_cross(params, cfg, tiled, cdt)

    tok = torch.full((B, W), GO_ID, dtype=torch.long, device=dev)
    logp = torch.full((B, W), NEG_INF, dtype=torch.float32, device=dev)
    logp[:, 0] = 0.0  # only beam 0 is live at step 0 (all beams start identical)
    finished = torch.zeros((B, W), dtype=torch.bool, device=dev)
    lens = torch.zeros((B, W), dtype=torch.long, device=dev)
    batch_offset = (torch.arange(B, device=dev) * W)[:, None]
    # Trellis pre-filled with the no-op continuation (token EOS, parent =
    # self): steps the early exit skips read as "every beam keeps feeding
    # EOS", which is what the full-horizon loop would have recorded.
    tokens_buf = torch.full((max_length, B, W), EOS_ID, dtype=torch.long, device=dev)
    parents_buf = torch.arange(W, device=dev).expand(max_length, B, W).clone()
    eos_only = None

    t = 0
    while t < max_length:
        settled = finished | (logp < NEG_INF / 2)
        if bool(settled.all()):
            break
        state, logits = dec.decoder_step(params, cfg, tok.reshape(B * W), state, tiled,
                                         cross_kv, cdt)
        V = logits.shape[-1]
        step_logp = torch.log_softmax(logits, dim=-1)
        step_logp[:, PAD_ID] = NEG_INF
        step_logp[:, GO_ID] = NEG_INF
        step_logp = step_logp.reshape(B, W, V)
        if eos_only is None:
            eos_only = torch.full((V,), NEG_INF, device=dev)
            eos_only[EOS_ID] = 0.0
        step_logp = torch.where(finished[:, :, None], eos_only, step_logp)

        cand_logp = logp[:, :, None] + step_logp                                  # [B, W, V]
        cand_lens = (lens + (~finished).long())[:, :, None].expand(B, W, V)
        cand_scores = cand_logp / _length_penalty(cand_lens, length_penalty)
        flat_idx = torch.sort(cand_scores.reshape(B, W * V), dim=1, descending=True,
                              stable=True).indices[:, :W]
        parent = flat_idx // V
        token = flat_idx % V

        logp = torch.gather(cand_logp.reshape(B, W * V), 1, flat_idx)
        lens = torch.gather(cand_lens.reshape(B, W * V), 1, flat_idx)
        was_finished = torch.gather(finished, 1, parent)
        finished = was_finished | (token == EOS_ID)
        flat_parent = (batch_offset + parent).reshape(B * W)
        state = state._replace(caches=tuple(
            (k.index_select(0, flat_parent), v.index_select(0, flat_parent))
            for k, v in state.caches))
        tok = torch.where(was_finished, torch.full_like(token, EOS_ID), token)
        tokens_buf[t] = token
        parents_buf[t] = parent
        t += 1

    # Final ranking: normalized score, strongly preferring finished beams
    # when any beam of the row finished.
    final_scores = logp / _length_penalty(lens, length_penalty)
    any_finished = finished.any(dim=1, keepdim=True)
    eff = torch.where(finished | ~any_finished, final_scores,
                      torch.full_like(final_scores, NEG_INF)).cpu()
    leaf = torch.argmax(eff, dim=1, keepdim=True)                     # [B, 1]
    score = torch.gather(eff, 1, leaf)[:, 0]
    length = torch.gather(lens.cpu(), 1, leaf)[:, 0]

    tokens_h, parents_h = tokens_buf.cpu(), parents_buf.cpu()
    ids = torch.empty((B, max_length), dtype=torch.long)
    beams = leaf
    for s in range(max_length - 1, -1, -1):
        ids[:, s] = torch.gather(tokens_h[s], 1, beams)[:, 0]
        beams = torch.gather(parents_h[s], 1, beams)
    # PAD everything after the first EOS (finished beams kept feeding EOS).
    is_eos = ids == EOS_ID
    first_eos = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1),
                            torch.full((B,), max_length - 1))
    ids = torch.where(torch.arange(max_length)[None, :] > first_eos[:, None],
                      torch.full_like(ids, PAD_ID), ids)
    return BeamResult(ids=ids, lengths=length, scores=score, steps=t)
