"""Transformer decoder (counterpart of
``avsr_tpu/models/transformer_decoder.py``: ``transformer_decoder_init``,
``prepare_cross``, ``initial_cache``, ``_cross_attend_rows``,
``decode_step``, ``teacher_forced_logits``).

Pre-LN causal self-attention over compute-dtype KV caches ([N, L, D],
batch-leading so the beam engine's parent gather works row-wise), then
multi-head cross-attention over the prepared memories' values, then a
tanh-form GELU FFN (``jax.nn.gelu``'s default), fp32 LayerNorms and fp32
logits.  Every row decodes the same position, so the decode state carries
one shared position as a host integer and the cache write is a single
slice at that position.  ``decode_step`` writes the new position's keys
and values into the caches IN PLACE (the caller's state is consumed); the
beam engine's parent gather makes a fresh copy every step anyway.

``teacher_forced_logits`` runs every label position in one causal pass
(training), with inverted dropout on the self-attention, cross-attention
and FFN outputs drawn from the step's generator.

The attention cores are kernels; the projections, LayerNorms, FFN and
logits stay matrix products, as the reference leaves them to XLA:

* K5, the teacher-forced attention (causal self attention, and cross
  attention under the memory's key bias): ``DecoderAttention`` is its
  ``torch.autograd.Function``, which saves the softmax's row statistics,
  not the weights; ``decoder_attention_fwd`` / ``_bwd`` launch the CUDA
  kernels (``csrc/decoder_attention.cu``, on the tensor cores) for GPU
  tensors and run ``decoder_attention_fwd_plain`` / ``_bwd_plain`` for CPU
  tensors.
* K6, the single-query attention of ``decode_step`` (self attention over
  the KV cache, cross attention over the prepared memory, which the beam
  search does not tile: a beam reads its utterance's memory row):
  ``decode_attention`` launches ``csrc/decode_attention.cu``'s kernels
  for GPU tensors (by shape: the W beams' cross read of a memory row as
  one tile, the self read a block per cache row, or the general kernel)
  and runs ``decode_attention_plain`` for CPU tensors.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from avsr_tpu_torch import kernels
from avsr_tpu_torch.configs import DecoderConfig
from avsr_tpu_torch.data.units import GO_ID
from avsr_tpu_torch.models.fusion import attention_bwd_from_weights, core_route_bwd
from avsr_tpu_torch.models.transformer_common import layer_norm, sinusoidal_pe
from avsr_tpu_torch.ops import attention as attn
from avsr_tpu_torch.utils.numerics import check_policy
from avsr_tpu_torch.utils.params import Params, glorot_uniform, normal_init, zeros


class TransformerDecoderState(NamedTuple):
    caches: Tuple  # per layer (k_cache, v_cache), each [N, L, D]
    step: int      # the position every row writes next


def validate_config(cfg: DecoderConfig, ctx_dims: Sequence[int]) -> int:
    if len(set(cfg.hidden_units)) != 1:
        raise ValueError(f"transformer decoder needs equal hidden_units, got {cfg.hidden_units}")
    d = cfg.hidden_units[0]
    if d % cfg.num_heads or d % 2:
        raise ValueError(f"decoder dim {d} must be even and divisible by num_heads")
    for m in ctx_dims:
        if m % cfg.num_heads:
            raise ValueError(f"memory dim {m} not divisible by num_heads {cfg.num_heads}")
    return d


def _decoder_scores(q, k, bias):
    """fp32 [B,nh,Q,S] scores: float(q.k in the compute dtype) / sqrt(dk)
    plus the causal mask (bias None: -1e9 where key > query, Q == S) or the
    memory's key bias [B,S]."""
    Q, S, dk = q.shape[1], k.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dk)
    if bias is None:
        causal = (torch.arange(S, device=q.device)[None, :]
                  <= torch.arange(Q, device=q.device)[:, None]).float()
        return scores + (1.0 - causal)[None, None] * -1e9
    return scores + bias[:, None, None, :]


def decoder_attention_weights(q, k, bias, row_max, row_sum):
    """The fp32 weights [B,nh,Q,S] from the operands and the softmax's saved
    row statistics [B,nh,Q]: exp(s - row_max) / row_sum, the forward's own
    expression, so the same bits as the forward's weights."""
    s = _decoder_scores(q, k, bias)
    return torch.exp(s - row_max[..., None]) / row_sum[..., None]


def decoder_attention_fwd_plain(q, k, v, bias, *, save: bool = False):
    """Plain-PyTorch K5 forward.  q [B,Q,nh,dk], k [B,S,nh,dk], v [B,S,nh,dv]
    in the compute dtype; ``bias`` [B,S] fp32 adds the memory's key bias,
    None applies the causal mask (Q == S) -> (ctx [B,Q,nh,dv] in the compute
    dtype, the softmax's row statistics (row_max, row_sum), fp32 [B,nh,Q]
    each, when ``save``, else None).  The softmax written out as the kernel
    takes it: the row max, exp(s - max), the row sum, a division."""
    s = _decoder_scores(q, k, bias)
    row_max = s.amax(dim=-1)
    e = torch.exp(s - row_max[..., None])
    row_sum = e.sum(dim=-1)
    w = e / row_sum[..., None]
    ctx = torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype), v)
    return ctx, ((row_max, row_sum) if save else None)


def decoder_attention_bwd_plain(q, k, v, bias, row_max, row_sum, dctx):
    """Plain-PyTorch K5 backward: the forward's q, k, v, bias and row
    statistics, and the context cotangent -> (dq, dk, dv).  The weights are
    recomputed from the statistics (the mask enters only through them),
    then ``attention_bwd_from_weights``: the gradient JAX's autodiff takes
    through the reference core, with its rounding points."""
    w = decoder_attention_weights(q, k, bias, row_max, row_sum)
    return attention_bwd_from_weights(q, k, v, w, dctx)


def decoder_attention_fwd(q, k, v, bias, *, save: bool = False):
    """K5 forward wrapper -> (ctx, the backward's residual when ``save``,
    else None): the plain version on the CPU and the tensor-core kernels
    give the row statistics (row_max, row_sum); at head widths with no
    tensor-core instance the CUDA-core kernels give the fp32 weights, a
    one-tuple (``kernels.attention_family``)."""
    if q.device.type == "cpu":
        return decoder_attention_fwd_plain(q, k, v, bias, save=save)
    check_policy(q.dtype, "K5")
    return kernels.decoder_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(),
        None if bias is None else bias.contiguous(), save=save)


def decoder_attention_bwd(q, k, v, bias, row_max, row_sum, dctx):
    """K5 backward wrapper: the tensor-core kernels for GPU tensors, the
    plain version on the CPU; same contract as
    ``decoder_attention_bwd_plain``."""
    if q.device.type == "cpu":
        return decoder_attention_bwd_plain(q, k, v, bias, row_max, row_sum, dctx)
    check_policy(q.dtype, "K5")
    return kernels.decoder_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                         None if bias is None else bias.contiguous(),
                                         row_max.contiguous(), row_sum.contiguous(),
                                         dctx.to(q.dtype).contiguous())


class DecoderAttention(torch.autograd.Function):
    """K5 with its gradient: ctx from q, k, v under the causal mask (bias
    None) or the memory's key bias, which takes no gradient.  The forward
    saves the operands, the bias and its residual: the softmax's row
    statistics ([B, nh, Q] each), not the weights, which the backward
    recomputes (the CUDA-core route, at widths with no tensor-core
    instance, saves the weights)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        out, res = decoder_attention_fwd(q, k, v, bias, save=True)
        ctx.save_for_backward(q, k, v, bias, *res)
        return out

    @staticmethod
    def backward(ctx, dctx):
        q, k, v, bias, *res = ctx.saved_tensors
        if len(res) == 1:
            dq, dk, dv = core_route_bwd("decoder_attention", q, k, v, *res, dctx)
        else:
            dq, dk, dv = decoder_attention_bwd(q, k, v, bias, *res, dctx)
        return dq, dk, dv, None


def decoder_attention(q, k, v, bias):
    """K5 as the decoder calls it: through ``DecoderAttention`` when autograd
    records a gradient for q, k or v, else straight to the forward wrapper,
    saving nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return DecoderAttention.apply(q, k, v, bias)
    return decoder_attention_fwd(q, k, v, bias)[0]


def decode_attention_plain(q, k, v, bias, n_keys: int):
    """Plain-PyTorch K6.  q [N,nh,dk] against k [B,L,nh,dk], v [B,L,nh,dv]
    in the compute dtype, query row n reading key row n // W (W = N / B:
    the beams of an utterance read its one memory).  ``bias`` [B,L] fp32
    adds the memory's key bias (cross attention); None is the self
    attention at position ``n_keys - 1`` (B == N): keys at or past
    ``n_keys`` get -1e9 -> ctx [N,nh,dv].  The key rows are gathered per
    query row, so the result is bit for bit the read of the beam-tiled
    memory."""
    N, B = q.shape[0], k.shape[0]
    if B < 1 or N % B:
        raise ValueError(f"decode attention: {N} query rows over {B} key rows; N must be a "
                         f"positive multiple of B")
    if N != B:
        rows = torch.arange(N, device=q.device) // (N // B)
        k, v = k.index_select(0, rows), v.index_select(0, rows)
        bias = None if bias is None else bias.index_select(0, rows)
    L, dk = k.shape[1], q.shape[-1]
    scores = torch.einsum("nhd,nlhd->nhl", q, k).float() / math.sqrt(dk)
    if bias is None:
        valid = (torch.arange(L, device=q.device) < n_keys).float()
        scores = scores + (1.0 - valid) * -1e9
    else:
        scores = scores + bias[:, None, :]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("nhl,nlhd->nhd", w, v)


def decode_attention(q, k, v, bias, n_keys: int):
    """K6 wrapper: the CUDA kernel for GPU tensors, the plain version on the
    CPU; same contract as ``decode_attention_plain``."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, bias, n_keys)
    check_policy(q.dtype, "K6")
    return kernels.decode_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                    None if bias is None else bias.contiguous(), n_keys)


def transformer_decoder_init(gen: torch.Generator, cfg: DecoderConfig,
                             memory_dims: Sequence[int], vocab_size: int,
                             device) -> Params:
    ctx_dims = [cfg.memory_value_dim or m for m in memory_dims]
    d = validate_config(cfg, ctx_dims)
    qk = cfg.attention_units * cfg.num_heads
    ff = cfg.ff_multiplier * d
    g = lambda shape: glorot_uniform(gen, shape, device)  # noqa: E731
    params: Params = {
        "embedding": normal_init(gen, (vocab_size, cfg.embedding_dim), device),
        "in_proj": g((cfg.embedding_dim, d)),
        "layers": [],
        "ln_f_scale": torch.ones(d, device=device),
        "ln_f_bias": zeros((d,), device),
        "out_w": g((d, vocab_size)),
        "out_b": zeros((vocab_size,), device),
        "atts": [attn.value_only_init(gen, m, cfg.memory_value_dim, device)
                 for m in memory_dims],
    }
    for _ in cfg.hidden_units:
        params["layers"].append({
            "ln1_scale": torch.ones(d, device=device), "ln1_bias": zeros((d,), device),
            "wq": g((d, d)), "wk": g((d, d)), "wv": g((d, d)), "wo": g((d, d)),
            "ln_c_scale": torch.ones(d, device=device), "ln_c_bias": zeros((d,), device),
            "cq": g((d, qk)),
            "ck": [g((c, qk)) for c in ctx_dims],
            "co": g((sum(ctx_dims), d)),
            "ln2_scale": torch.ones(d, device=device), "ln2_bias": zeros((d,), device),
            "ff_w1": g((d, ff)), "ff_b1": zeros((ff,), device),
            "ff_w2": g((ff, d)), "ff_b2": zeros((d,), device),
        })
    return params


def prepare_cross(params: Params, cfg: DecoderConfig,
                  memories: Sequence[attn.AttentionMemory], cdt: torch.dtype) -> Tuple:
    """Per layer, one [B, S, qk] cross-attention key tensor per memory of B
    rows (loop-invariant: computed once before the decode loop; the beam
    search passes the untiled memories, read by every beam of a row)."""
    return tuple(
        tuple(mem.values.to(cdt) @ ck.to(cdt) for ck, mem in zip(layer["ck"], memories))
        for layer in params["layers"]
    )


def initial_cache(cfg: DecoderConfig, batch: int, max_length: int,
                  dtype: torch.dtype, device) -> TransformerDecoderState:
    """Zeroed KV caches in the compute dtype (the cached k/v are outputs of
    compute-dtype matmuls, so this storage is exact)."""
    d = cfg.hidden_units[0]
    caches = tuple(
        (torch.zeros((batch, max_length, d), dtype=dtype, device=device),
         torch.zeros((batch, max_length, d), dtype=dtype, device=device))
        for _ in cfg.hidden_units)
    return TransformerDecoderState(caches=caches, step=0)


def _cross_attend_rows(layer, cfg: DecoderConfig, h, memories, cross_keys, cdt):
    """Single-position cross attention: h [N, D] -> context [N, sum_ctx];
    the memories hold B rows, N a multiple of B (row n reads memory row
    n // (N / B): the beams of an utterance share its memory)."""
    nh, A = cfg.num_heads, cfg.attention_units
    N = h.shape[0]
    y = layer_norm(h, layer["ln_c_scale"], layer["ln_c_bias"]).to(cdt)
    q = (y @ layer["cq"].to(cdt)).reshape(N, nh, A)
    ctxs = []
    for mem, k_proj in zip(memories, cross_keys):
        B, S, _ = k_proj.shape
        k = k_proj.reshape(B, S, nh, A)
        mv = mem.values.shape[-1]
        v = mem.values.to(cdt).reshape(B, S, nh, mv // nh)
        ctxs.append(decode_attention(q, k, v, mem.bias, S).reshape(N, mv))
    return torch.cat(ctxs, dim=-1)


def decode_step(params: Params, cfg: DecoderConfig, tokens: torch.Tensor,
                state: TransformerDecoderState, memories: Sequence[attn.AttentionMemory],
                cross_kv: Tuple, cdt: torch.dtype):
    """One position for every row: (new state, fp32 logits [N, V])."""
    d = cfg.hidden_units[0]
    nh = cfg.num_heads
    dh = d // nh
    N = tokens.shape[0]
    L = state.caches[0][0].shape[1]
    dev = tokens.device
    pos = min(max(state.step, 0), L - 1)

    emb = params["embedding"][tokens]
    h = (emb.to(cdt) @ params["in_proj"].to(cdt)).float()
    h = h * math.sqrt(d) + sinusoidal_pe(L, d, dev)[pos]

    new_caches: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for layer, (k_cache, v_cache), cross_keys in zip(params["layers"], state.caches, cross_kv):
        y = layer_norm(h, layer["ln1_scale"], layer["ln1_bias"]).to(cdt)
        q = (y @ layer["wq"].to(cdt)).reshape(N, nh, dh)
        k_cache[:, pos] = (y @ layer["wk"].to(cdt)).to(k_cache.dtype)
        v_cache[:, pos] = (y @ layer["wv"].to(cdt)).to(v_cache.dtype)
        new_caches.append((k_cache, v_cache))
        kh = k_cache.to(cdt).reshape(N, L, nh, dh)
        vh = v_cache.to(cdt).reshape(N, L, nh, dh)
        att = decode_attention(q, kh, vh, None, pos + 1).reshape(N, d)
        h = h + (att @ layer["wo"].to(cdt)).float()

        ctx = _cross_attend_rows(layer, cfg, h, memories, cross_keys, cdt)
        h = h + (ctx.to(cdt) @ layer["co"].to(cdt)).float()

        y = layer_norm(h, layer["ln2_scale"], layer["ln2_bias"]).to(cdt)
        y = F.gelu(y @ layer["ff_w1"].to(cdt) + layer["ff_b1"].to(cdt), approximate="tanh")
        h = h + (y @ layer["ff_w2"].to(cdt) + layer["ff_b2"].to(cdt)).float()

    out = layer_norm(h, params["ln_f_scale"], params["ln_f_bias"])
    logits = (out.to(cdt) @ params["out_w"].to(cdt)).float() + params["out_b"]
    return TransformerDecoderState(caches=tuple(new_caches), step=state.step + 1), logits


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout (the reference's ``inverted_dropout``)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def teacher_forced_logits(params: Params, cfg: DecoderConfig, targets: torch.Tensor,
                          target_lengths: torch.Tensor,
                          memories: Sequence[attn.AttentionMemory], cdt: torch.dtype, *,
                          generator: Optional[torch.Generator] = None,
                          dropout: bool = False) -> torch.Tensor:
    """Parallel teacher forcing: position k consumes token k-1 (GO at k=0)
    under a causal mask and predicts targets[:, k].  fp32 logits [B, K, V]."""
    d = cfg.hidden_units[0]
    nh = cfg.num_heads
    dh = d // nh
    A = cfg.attention_units
    B, K = targets.shape
    dev = targets.device
    drop = cfg.dropout_rate if (dropout and generator is not None) else 0.0

    go = torch.full((B, 1), GO_ID, dtype=targets.dtype, device=dev)
    shifted = torch.cat([go, targets[:, :-1]], dim=1)
    # F.embedding: its backward sums the rows of repeated ids by segments;
    # advanced indexing's backward serializes them (2 ms per step at B=128)
    emb = F.embedding(shifted.long(), params["embedding"])
    h = (emb.to(cdt) @ params["in_proj"].to(cdt)).float()
    h = h * math.sqrt(d) + sinusoidal_pe(K, d, dev)[None]

    for layer in params["layers"]:
        y = layer_norm(h, layer["ln1_scale"], layer["ln1_bias"]).to(cdt)
        q = (y @ layer["wq"].to(cdt)).reshape(B, K, nh, dh)
        k = (y @ layer["wk"].to(cdt)).reshape(B, K, nh, dh)
        v = (y @ layer["wv"].to(cdt)).reshape(B, K, nh, dh)
        att = decoder_attention(q, k, v, None).reshape(B, K, d)
        att = (att @ layer["wo"].to(cdt)).float()
        if drop > 0.0:
            att = _dropout(att, drop, generator)
        h = h + att

        y = layer_norm(h, layer["ln_c_scale"], layer["ln_c_bias"]).to(cdt)
        q = (y @ layer["cq"].to(cdt)).reshape(B, K, nh, A)
        ctxs = []
        for mem, ck in zip(memories, layer["ck"]):
            S = mem.values.shape[1]
            mk = (mem.values.to(cdt) @ ck.to(cdt)).reshape(B, S, nh, A)
            mv = mem.values.shape[-1]
            mvh = mem.values.to(cdt).reshape(B, S, nh, mv // nh)
            ctxs.append(decoder_attention(q, mk, mvh, mem.bias).reshape(B, K, mv))
        ctx = torch.cat(ctxs, dim=-1)
        ctx = (ctx.to(cdt) @ layer["co"].to(cdt)).float()
        if drop > 0.0:
            ctx = _dropout(ctx, drop, generator)
        h = h + ctx

        y = layer_norm(h, layer["ln2_scale"], layer["ln2_bias"]).to(cdt)
        y = F.gelu(y @ layer["ff_w1"].to(cdt) + layer["ff_b1"].to(cdt), approximate="tanh")
        y = (y @ layer["ff_w2"].to(cdt) + layer["ff_b2"].to(cdt)).float()
        if drop > 0.0:
            y = _dropout(y, drop, generator)
        h = h + y

    out = layer_norm(h, params["ln_f_scale"], params["ln_f_bias"])
    return (out.to(cdt) @ params["out_w"].to(cdt)).float() + params["out_b"]
