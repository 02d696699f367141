"""Batched width-W beam search (counterpart of ``avsr_tpu/decode/beam.py``).

Same semantics as the reference:

* beams are folded into the batch axis, contiguous per row ([B*W]);
* PAD and GO are masked AFTER the log-softmax, so surviving scores are
  true model log probs; finished beams continue with an EOS-only,
  zero-score row;
* candidates are ranked by length-normalized score ((5+len)/6)^alpha and
  the top W of each row's W*V candidates are taken with a STABLE
  descending sort, so ties resolve to the lower flat index exactly like
  ``lax.top_k``;
* the decoder state (the transformer's KV caches, or the RNN decoder's
  (h, c) and contexts) is gathered by parent every step, every tensor of
  it, as the reference's ``tree_map`` does;
* the memories are not tiled over the beams: the transformer's cross read
  (K6) and the RNN decoder's read (K10) take each utterance's memory row
  for all of its W beams, query row n reading memory row n // W, where the
  reference tiles the memories (the same values);
* the step after the decoder (log-softmax, masks, length penalty, top-W,
  gathers, trellis row) and the loop's condition on the new carry (every
  beam of a row finished or dead: score still ~NEG_INF) are kernel K7.
  ``beam_stepper`` gives the search its step: ``kernels.BeamStep``
  (``csrc/beam_step.cu``) for GPU tensors, which checks the tensors, looks
  up the stream and binds the kernel's arguments once per search, or
  ``beam_step_plain`` for CPU tensors.  The carry lives in two sets of
  buffers allocated once per search, each step reading one and writing the
  other, so a step allocates nothing.  The length penalty of every length
  is one table, computed once, so both paths divide by the same values;
* the loop exits early, on the host, once every row's settled flag is set:
  the remaining steps would only append zero-score EOS continuations;
* the (token, parent) trellis is backtracked from the best leaf, on the
  host, and everything after the first EOS becomes PAD; with ``n_best``
  N > 1 from the top N (<= W) leaves of the final ranking (a stable
  descending sort, ties to the lower beam index, so rank 0 is the best
  leaf), filling the ``nbest_*`` fields.

The search runs under ``torch.inference_mode()``: parameters that require
a gradient (a train state's) record no graph and take no kernel's save
path.  Results are returned as CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from avsr_tpu_torch import kernels
from avsr_tpu_torch.configs import DecoderConfig
from avsr_tpu_torch.data.units import EOS_ID, GO_ID, PAD_ID
from avsr_tpu_torch.models import decoder as dec
from avsr_tpu_torch.ops import attention as attn
from avsr_tpu_torch.utils.numerics import full_precision

NEG_INF = -1.0e30


class BeamResult(NamedTuple):
    ids: torch.Tensor      # [B, L] best hypothesis, PAD after EOS
    lengths: torch.Tensor  # [B] tokens incl. EOS
    scores: torch.Tensor   # [B] length-normalized log prob of the winner
    steps: int             # decode steps actually executed (early exit)
    # Only with beam_search(n_best > 1): the ranked alternatives, rank 0
    # equal to the fields above
    nbest_ids: "torch.Tensor | None" = None      # [B, N, L]
    nbest_lengths: "torch.Tensor | None" = None  # [B, N]
    nbest_scores: "torch.Tensor | None" = None   # [B, N]


class StepOut(NamedTuple):
    """One carry of the search and the step outputs written with it (K7
    reads logp, lens and finished, and writes every field)."""
    flat_parent: torch.Tensor  # [B*W] int64: b * W + parent, the state gather index
    feed: torch.Tensor         # [B, W] int64: next input, EOS where the parent had finished
    logp: torch.Tensor         # [B, W] f32
    lens: torch.Tensor         # [B, W] int32
    finished: torch.Tensor     # [B, W] bool
    settled: torch.Tensor      # [B] bool: every beam of the row finished or dead


def step_buffers(B: int, W: int, device) -> StepOut:
    """Uninitialized buffers of one carry and its step outputs."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    return StepOut(flat_parent=empty((B * W,), torch.long), feed=empty((B, W), torch.long),
                   logp=empty((B, W), torch.float32), lens=empty((B, W), torch.int32),
                   finished=empty((B, W), torch.bool), settled=empty((B,), torch.bool))


def length_penalty_table(max_length: int, alpha: float, device) -> torch.Tensor:
    """((5 + len) / 6)^alpha for len in [0, max_length], or ones for alpha 0."""
    lengths = torch.arange(max_length + 1, device=device)
    if alpha == 0.0:
        return torch.ones_like(lengths, dtype=torch.float32)
    return torch.pow((5.0 + lengths.float()) / 6.0, alpha)


def beam_step_plain(logits, logp, lens, finished, lp_table, tokens_row, parents_row,
                    out: StepOut) -> StepOut:
    """Plain-PyTorch K7: one beam step from the decoder's fp32 logits
    [B*W, V] and the beam state (logp [B,W] f32, lens [B,W] int32,
    finished [B,W] bool).  Writes the chosen tokens and parents into the
    trellis rows ``tokens_row`` / ``parents_row`` [B,W] int64 and the new
    carry, the state gather index, the feed and the settled flags into
    ``out``; returns ``out``."""
    B, W = logp.shape
    V = logits.shape[-1]
    step_logp = torch.log_softmax(logits, dim=-1)
    step_logp[:, PAD_ID] = NEG_INF
    step_logp[:, GO_ID] = NEG_INF
    eos_only = torch.full((V,), NEG_INF, device=logits.device)
    eos_only[EOS_ID] = 0.0
    step_logp = torch.where(finished[:, :, None], eos_only, step_logp.reshape(B, W, V))

    cand_logp = logp[:, :, None] + step_logp                                  # [B, W, V]
    cand_lens = (lens + (~finished).int())[:, :, None].expand(B, W, V)
    cand_scores = cand_logp / lp_table[cand_lens.long()]
    flat_idx = torch.sort(cand_scores.reshape(B, W * V), dim=1, descending=True,
                          stable=True).indices[:, :W]
    parent = flat_idx // V
    token = flat_idx % V
    was_finished = torch.gather(finished, 1, parent)
    new_logp = torch.gather(cand_logp.reshape(B, W * V), 1, flat_idx)
    new_finished = was_finished | (token == EOS_ID)
    tokens_row.copy_(token)
    parents_row.copy_(parent)
    out.flat_parent.copy_(
        (torch.arange(B, device=logits.device)[:, None] * W + parent).reshape(B * W))
    out.feed.copy_(torch.where(was_finished, torch.full_like(token, EOS_ID), token))
    out.logp.copy_(new_logp)
    out.lens.copy_(torch.gather(cand_lens.reshape(B, W * V), 1, flat_idx))
    out.finished.copy_(new_finished)
    out.settled.copy_((new_finished | (new_logp < NEG_INF / 2)).all(dim=1))
    return out


def beam_step(logits, logp, lens, finished, lp_table, tokens_row, parents_row,
              out: StepOut) -> StepOut:
    """K7 wrapper, one call: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``beam_step_plain``."""
    if logits.device.type == "cpu":
        return beam_step_plain(logits, logp, lens, finished, lp_table, tokens_row,
                               parents_row, out)
    return kernels.beam_step(logits, logp, lens, finished, lp_table, tokens_row,
                             parents_row, out)


def plain_stepper(lp_table, tokens, parents, carries, V: int):
    """``beam_stepper``'s contract on ``beam_step_plain``."""
    def step(logits, t: int, src: int) -> None:
        c = carries[src]
        beam_step_plain(logits, c.logp, c.lens, c.finished, lp_table, tokens[t], parents[t],
                        carries[1 - src])

    return step


def beam_stepper(lp_table, tokens, parents, carries, V: int):
    """K7 for one search: ``step(logits, t, src)`` reads carry ``src`` of the
    two ``carries`` (``StepOut``s), writes carry ``1 - src`` and row t of the
    [L, B, W] trellises.  ``kernels.BeamStep`` for GPU tensors (checked once
    here), ``plain_stepper`` for CPU tensors."""
    if lp_table.device.type == "cpu":
        return plain_stepper(lp_table, tokens, parents, carries, V)
    return kernels.BeamStep(lp_table, tokens, parents, carries, V)


def _cast_memory(mem: attn.AttentionMemory, cdt: torch.dtype) -> attn.AttentionMemory:
    """The memory as the decode steps read it, its B rows untiled: the values
    in the compute dtype, cast once here instead of at every step; the
    Bahdanau keys (if any) stay fp32; keys that are the values (a Luong
    memory without a value projection, read only in the compute dtype)
    stay one tensor."""
    values = mem.values.contiguous().to(cdt)
    keys = values if mem.keys is mem.values else (
        None if mem.keys is None else mem.keys.contiguous())
    return attn.AttentionMemory(values=values, keys=keys, mask=mem.mask.contiguous(),
                                bias=mem.bias.contiguous())


def _gather_rows(state, index: torch.Tensor):
    """Every tensor of a decoder state (nested tuples / NamedTuples) gathered
    along its leading row axis; other leaves (the shared position) kept."""
    if isinstance(state, torch.Tensor):
        return state.index_select(0, index)
    if isinstance(state, tuple):
        items = [_gather_rows(x, index) for x in state]
        return type(state)(*items) if hasattr(state, "_fields") else tuple(items)
    return state


@torch.inference_mode()
def beam_search(params, cfg: DecoderConfig, memories: Sequence[attn.AttentionMemory],
                max_length: int, *, beam_width: int = 10, length_penalty: float = 0.0,
                cdt: torch.dtype = torch.bfloat16, n_best: int = 1) -> BeamResult:
    with full_precision(cdt):
        return _beam_search(params, cfg, memories, max_length, beam_width=beam_width,
                            length_penalty=length_penalty, cdt=cdt, n_best=n_best)


def _beam_search(params, cfg: DecoderConfig, memories: Sequence[attn.AttentionMemory],
                 max_length: int, *, beam_width: int, length_penalty: float,
                 cdt: torch.dtype, n_best: int) -> BeamResult:
    B = memories[0].values.shape[0]
    W = beam_width
    dev = memories[0].values.device
    # the reads (K6's cross read, K10) take the untiled memories, each beam
    # reading its utterance's row
    mems = [_cast_memory(m, cdt) for m in memories]
    state = dec.initial_state(cfg, B * W, max_length, cdt, dev,
                              memory_dims=[m.values.shape[-1] for m in memories])
    cross_kv = dec.prepare_cross(params, cfg, mems, cdt)
    lp_table = length_penalty_table(max_length, length_penalty, dev)

    V = params["embedding"].shape[0]  # the vocabulary: the logits' width
    carries = (step_buffers(B, W, dev), step_buffers(B, W, dev))
    carry = carries[0]
    carry.logp.fill_(NEG_INF)
    carry.logp[:, 0] = 0.0  # only beam 0 is live at step 0 (all beams start identical)
    carry.finished.zero_()
    carry.lens.zero_()
    # Trellis pre-filled with the no-op continuation (token EOS, parent =
    # self): steps the early exit skips read as "every beam keeps feeding
    # EOS", which is what the full-horizon loop would have recorded.
    tokens_buf = torch.full((max_length, B, W), EOS_ID, dtype=torch.long, device=dev)
    parents_buf = torch.arange(W, device=dev).expand(max_length, B, W).clone()
    step = beam_stepper(lp_table, tokens_buf, parents_buf, carries, V) if B else None
    feeds = [c.feed.view(B * W) for c in carries]

    tok = torch.full((B * W,), GO_ID, dtype=torch.long, device=dev)
    t, src = 0, 0
    settled = B == 0  # the initial carry: beam 0 of every row live
    while t < max_length and not settled:
        state, logits = dec.decoder_step(params, cfg, tok, state, mems, cross_kv, cdt)
        step(logits, t, src)
        src = 1 - src
        carry = carries[src]
        state = _gather_rows(state, carry.flat_parent)
        tok = feeds[src]
        settled = bool(carry.settled.all())
        t += 1
    logp, lens, finished = carry.logp, carry.lens, carry.finished

    # Final ranking: normalized score, strongly preferring finished beams
    # when any beam of the row finished.
    final_scores = logp / lp_table[lens.long()]
    any_finished = finished.any(dim=1, keepdim=True)
    eff = torch.where(finished | ~any_finished, final_scores,
                      torch.full_like(final_scores, NEG_INF)).cpu()
    n = min(max(n_best, 1), W)
    # Stable: a tie goes to the lowest beam, as argmax's first maximum does.
    leaves = torch.sort(eff, dim=1, descending=True, stable=True).indices[:, :n]  # [B, n]
    scores = torch.gather(eff, 1, leaves)                             # [B, n]
    lengths = torch.gather(lens.cpu(), 1, leaves)

    tokens_h, parents_h = tokens_buf.cpu(), parents_buf.cpu()
    ids = torch.empty((B, n, max_length), dtype=torch.long)
    beams = leaves
    for s in range(max_length - 1, -1, -1):
        ids[:, :, s] = torch.gather(tokens_h[s], 1, beams)
        beams = torch.gather(parents_h[s], 1, beams)
    # PAD everything after the first EOS (finished beams kept feeding EOS).
    is_eos = ids == EOS_ID
    first_eos = torch.where(is_eos.any(dim=-1), is_eos.int().argmax(dim=-1),
                            torch.full((B, n), max_length - 1))
    ids = torch.where(torch.arange(max_length)[None, None, :] > first_eos[:, :, None],
                      torch.full_like(ids, PAD_ID), ids)
    nb = n_best > 1
    return BeamResult(ids=ids[:, 0], lengths=lengths[:, 0], scores=scores[:, 0], steps=t,
                      nbest_ids=ids if nb else None, nbest_lengths=lengths if nb else None,
                      nbest_scores=scores if nb else None)
