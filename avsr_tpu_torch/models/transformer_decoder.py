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
and FFN outputs drawn from the step's generator.  Plain PyTorch: its
attention (K5) is the next kernel to port.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from avsr_tpu.configs import DecoderConfig
from avsr_tpu.data.units import GO_ID
from avsr_tpu_torch.models.transformer_common import layer_norm, sinusoidal_pe
from avsr_tpu_torch.ops import attention as attn
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


def transformer_decoder_init(gen: torch.Generator, cfg: DecoderConfig,
                             memory_dims: Sequence[int], vocab_size: int,
                             device="cpu") -> Params:
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
    """Per layer, one [N, S, qk] cross-attention key tensor per memory
    (loop-invariant: computed once before the decode loop)."""
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
    """Single-position cross attention: h [N, D] -> context [N, sum_ctx]."""
    nh, A = cfg.num_heads, cfg.attention_units
    y = layer_norm(h, layer["ln_c_scale"], layer["ln_c_bias"]).to(cdt)
    q = (y @ layer["cq"].to(cdt)).reshape(-1, nh, A)
    ctxs = []
    for mem, k_proj in zip(memories, cross_keys):
        N, S, _ = k_proj.shape
        k = k_proj.reshape(N, S, nh, A)
        scores = torch.einsum("nha,nsha->nhs", q, k).float()
        scores = scores / math.sqrt(A) + mem.bias[:, None, :]
        w = torch.softmax(scores, dim=-1).to(cdt)
        mv = mem.values.shape[-1]
        v = mem.values.to(cdt).reshape(N, S, nh, mv // nh)
        ctxs.append(torch.einsum("nhs,nshd->nhd", w, v).reshape(N, mv))
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
    causal = (torch.arange(L, device=dev) <= pos).float()  # [L]

    new_caches: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for layer, (k_cache, v_cache), cross_keys in zip(params["layers"], state.caches, cross_kv):
        y = layer_norm(h, layer["ln1_scale"], layer["ln1_bias"]).to(cdt)
        q = (y @ layer["wq"].to(cdt)).reshape(N, nh, dh)
        k_cache[:, pos] = (y @ layer["wk"].to(cdt)).to(k_cache.dtype)
        v_cache[:, pos] = (y @ layer["wv"].to(cdt)).to(v_cache.dtype)
        new_caches.append((k_cache, v_cache))
        kh = k_cache.to(cdt).reshape(N, L, nh, dh)
        vh = v_cache.to(cdt).reshape(N, L, nh, dh)
        scores = torch.einsum("nhd,nlhd->nhl", q, kh).float() / math.sqrt(dh)
        scores = scores + (1.0 - causal) * -1e9
        w = torch.softmax(scores, dim=-1).to(cdt)
        att = torch.einsum("nhl,nlhd->nhd", w, vh).reshape(N, d)
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
    causal = (torch.arange(K, device=dev)[None, :] <= torch.arange(K, device=dev)[:, None]).float()

    for layer in params["layers"]:
        y = layer_norm(h, layer["ln1_scale"], layer["ln1_bias"]).to(cdt)
        q = (y @ layer["wq"].to(cdt)).reshape(B, K, nh, dh)
        k = (y @ layer["wk"].to(cdt)).reshape(B, K, nh, dh)
        v = (y @ layer["wv"].to(cdt)).reshape(B, K, nh, dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dh)
        scores = scores + (1.0 - causal)[None, None] * -1e9
        w = torch.softmax(scores, dim=-1).to(cdt)
        att = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, K, d)
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
            cs = torch.einsum("bqha,bsha->bhqs", q, mk).float()
            cs = cs / math.sqrt(A) + mem.bias[:, None, None, :]
            cw = torch.softmax(cs, dim=-1).to(cdt)
            mv = mem.values.shape[-1]
            mvh = mem.values.to(cdt).reshape(B, S, nh, mv // nh)
            ctxs.append(torch.einsum("bhqs,bshd->bqhd", cw, mvh).reshape(B, K, mv))
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
