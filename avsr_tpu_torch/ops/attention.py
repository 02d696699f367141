"""Masked attention memories and the Bahdanau and Luong reads
(counterpart of ``avsr_tpu/ops/attention.py``).

A memory is prepared once: the mask, the additive bias (0 where valid,
-1e30 where padded), the optional value down-projection and the keys: for
Bahdanau attention the key projection ``bf16(memory) @ bf16(wm)`` kept in
fp32, for Luong attention the raw memory itself.  The transformer decoder
computes its own multi-head scores and reads only a memory's VALUES (the
reference's ``value_only`` path): its memories carry ``keys=None``.

``attend`` is one read per query row, kernel K10: for tensors on a GPU
``attend_fwd`` launches ``csrc/bahdanau_attend.cu`` (the read body is
``csrc/bahdanau_core.cuh``, shared with the AV-Align fusion scan K8, and
templated on the score), for tensors on the CPU it runs ``attend_plain``.
Per row, under the bf16 policy:

    q       = bf16(query) @ bf16(wq)                       (fp32)
    scores  = bf16(tanh(keys + q)) . bf16(v) + bias        (fp32, Bahdanau)
    scores  = bf16(keys) . bf16(q) + bias                  (fp32, Luong "general")
    weights = softmax(scores) * mask, renormalized, times min(sum(mask), 1)
    context = bf16(weights) @ bf16(values)                 (fp32)

so a memory of length 0 gives zero weights and a zero context.  When
autograd records a gradient, ``attend`` goes through ``BahdanauAttend``,
whose backward is K10's backward kernel on a GPU and ``attend_bwd_plain``
(the hand-derived gradient JAX's autodiff takes through the read, with its
rounding points) on the CPU.  The backward recomputes q (and the Bahdanau
energies) from the query, as the reference's ``jax.checkpoint`` does: the
tanh tensor is never saved.  ``attend_batched_queries`` is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from avsr_tpu_torch import kernels
from avsr_tpu_torch.utils.numerics import dot_f32, rounded
from avsr_tpu_torch.utils.params import Params, glorot_uniform

NEG_INF = -1e30


class AttentionMemory(NamedTuple):
    """A prepared memory, in the reference's field order."""

    values: torch.Tensor            # [B, S, V] memory vectors (or their down-projection)
    keys: Optional[torch.Tensor]    # [B, S, A] fp32 projected keys (Bahdanau), the raw
                                    # memory [B, S, H] (Luong), or None (value only)
    mask: torch.Tensor              # [B, S] 1.0 = valid position
    bias: torch.Tensor              # [B, S] 0 where valid, NEG_INF where padded


def _check_type(attention_type: str) -> None:
    if attention_type not in ("bahdanau", "luong"):
        raise ValueError(f"unknown attention type {attention_type!r}")


def bahdanau_init(gen: torch.Generator, query_dim: int, memory_dim: int, attention_units: int,
                  device, value_dim: Optional[int] = None) -> Params:
    params = {
        "wq": glorot_uniform(gen, (query_dim, attention_units), device),
        "wm": glorot_uniform(gen, (memory_dim, attention_units), device),
        "v": glorot_uniform(gen, (attention_units, 1), device).squeeze(-1),
    }
    if value_dim is not None:
        params["wv"] = glorot_uniform(gen, (memory_dim, value_dim), device)
    return params


def luong_init(gen: torch.Generator, query_dim: int, memory_dim: int, device,
               value_dim: Optional[int] = None) -> Params:
    """Luong "general": score = q W m, ``wq`` maps the query to the memory
    width; no key projection, no ``v``."""
    params = {"wq": glorot_uniform(gen, (query_dim, memory_dim), device)}
    if value_dim is not None:
        params["wv"] = glorot_uniform(gen, (memory_dim, value_dim), device)
    return params


def attention_init(attention_type: str, gen: torch.Generator, query_dim: int, memory_dim: int,
                   attention_units: int, device, value_dim: Optional[int] = None) -> Params:
    _check_type(attention_type)
    if attention_type == "luong":
        return luong_init(gen, query_dim, memory_dim, device, value_dim=value_dim)
    return bahdanau_init(gen, query_dim, memory_dim, attention_units, device,
                         value_dim=value_dim)


def value_only_init(gen: torch.Generator, memory_dim: int, value_dim: Optional[int],
                    device) -> Params:
    params: Params = {}
    if value_dim is not None:
        params["wv"] = glorot_uniform(gen, (memory_dim, value_dim), device)
    return params


def prepare_memory(attention_type: str, params: Params, memory: torch.Tensor,
                   memory_lengths: torch.Tensor, cdt: torch.dtype) -> AttentionMemory:
    """Mask, bias, the keys (Bahdanau: projected, fp32; Luong: the raw
    memory) and the optional one-time value down-projection; ``value_only``
    memories carry no keys."""
    B, S, _ = memory.shape
    mask = (torch.arange(S, device=memory.device)[None, :]
            < memory_lengths[:, None]).float()
    bias = (1.0 - mask) * NEG_INF
    keys = None
    if attention_type != "value_only":
        _check_type(attention_type)
        keys = memory if attention_type == "luong" else dot_f32(memory, params["wm"], cdt)
    values = memory
    if "wv" in params:
        values = dot_f32(memory, params["wv"], cdt)
    return AttentionMemory(values=values, keys=keys, mask=mask, bias=bias)


def attend_plain(attention_type: str, params: Params, query: torch.Tensor,
                 mem: AttentionMemory, cdt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch K10: query [N, Q] -> (context [N, V] fp32, weights
    [N, S] fp32, padded positions exactly 0)."""
    _check_type(attention_type)
    q = dot_f32(query, params["wq"], cdt)                      # [N, A] (Luong: [N, H])
    if attention_type == "luong":
        scores = torch.einsum("nsh,nh->ns", mem.keys.to(cdt).float(), q.to(cdt).float())
    else:
        e = torch.tanh(mem.keys + q[:, None, :])               # [N, S, A] fp32
        scores = torch.einsum("nsa,a->ns", e.to(cdt).float(), params["v"].to(cdt).float())
    scores = scores + mem.bias
    weights = torch.softmax(scores, dim=-1) * mem.mask
    # renormalize, and zero a memory whose every position is masked
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-9)
    weights = weights * torch.clamp(mem.mask.sum(dim=-1, keepdim=True), max=1.0)
    context = torch.einsum("ns,nsh->nh", weights.to(cdt).float(), mem.values.to(cdt).float())
    return context, weights


def attend_fwd(attention_type: str, params: Params, query: torch.Tensor, mem: AttentionMemory,
               cdt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 forward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``attend_plain``.  The kernel runs
    the bf16 policy only; any other compute dtype on a GPU raises."""
    if query.device.type == "cpu":
        return attend_plain(attention_type, params, query, mem, cdt)
    _check_type(attention_type)
    _check_policy(cdt)
    return kernels.bahdanau_attend(
        query.float().contiguous(), *kernel_operands(attention_type, params, mem),
        mem.bias.float().contiguous(), mem.mask.float().contiguous())


def kernel_operands(attention_type: str, params: Params, mem: AttentionMemory):
    """(wq, v, keys, values) as the read kernels take them: bf16 wq and
    values; Bahdanau's bf16 v and fp32 keys, or Luong's bf16 keys and no v
    (one bf16 copy serves as both when the keys are the values)."""
    bf = torch.bfloat16
    values = mem.values.to(bf).contiguous()
    if attention_type == "luong":
        keys = values if mem.keys is mem.values else mem.keys.to(bf).contiguous()
        v = None
    else:
        keys, v = mem.keys.float().contiguous(), params["v"].to(bf).contiguous()
    return params["wq"].to(bf).contiguous(), v, keys, values


def attend_bwd_plain(attention_type: str, params: Params, query: torch.Tensor,
                     mem: AttentionMemory, weights: torch.Tensor, dctx: torch.Tensor,
                     cdt: torch.dtype):
    """Plain-PyTorch K10 backward: the gradient JAX's autodiff takes
    through ``attend`` (``avsr_tpu/ops/attention.py:140-163,167-177``) for
    the context cotangent ``dctx`` [N, Dv], given the forward's ``weights``
    [N, S].  q (and Bahdanau's energies) are recomputed from the query.
    The renormalised mask folds into the softmax backward: a valid row's
    weights are its softmax (padded positions exactly 0), an empty row's
    are all 0, so ``dscores = w * (dw - sum(w * dw))`` in both cases.

    Luong's score ``bf16(keys) . bf16(q)`` transposes to ``dq =
    bf16(dscores @ bf16(keys))`` and ``dkeys = bf16(dscores * bf16(q))``:
    the cotangents of its two casts, rounded where JAX's transposed bf16
    products return bf16.

    Returns (dquery [N, Hq], dq [N, A], dv_rows [N, A] (Bahdanau) or None
    (Luong), dkeys [N, S, A], dvalues [N, S, Dv]), all fp32: dq and dv_rows
    are the per-row factors of the weight gradients
    (``attention_weight_grads``)."""
    _check_type(attention_type)
    wq_c = params["wq"].to(cdt).float()
    q = dot_f32(query, params["wq"], cdt)
    dctx = dctx.float()
    dw = rounded(torch.einsum("nd,nsd->ns", dctx, mem.values.to(cdt).float()), cdt)
    dvalues = rounded(weights.to(cdt).float()[:, :, None] * dctx[:, None, :], cdt)
    dsc = weights * (dw - (weights * dw).sum(dim=-1, keepdim=True))
    if attention_type == "luong":
        dq = rounded(torch.einsum("ns,nsh->nh", dsc, mem.keys.to(cdt).float()), cdt)
        dkeys = rounded(dsc[:, :, None] * q.to(cdt).float()[:, None, :], cdt)
        dv_rows = None
    else:
        e = torch.tanh(mem.keys.float() + q[:, None, :])       # [N, S, A]
        deb = rounded(dsc[:, :, None] * params["v"].to(cdt).float(), cdt)
        dkeys = (deb + deb * e) * (1.0 - e)                    # tanh' as JAX takes it
        dq = dkeys.sum(dim=1)
        dv_rows = torch.einsum("nsa,ns->na", e.to(cdt).float(), dsc)
    dquery = rounded(dq @ wq_c.t(), cdt)
    return dquery, dq, dv_rows, dkeys, dvalues


def attention_weight_grads(query: torch.Tensor, dq: torch.Tensor,
                           dv_rows: Optional[torch.Tensor], cdt: torch.dtype):
    """(dwq, dv) from the per-row factors: ``bf16(query)^T @ dq`` and the
    row sum of ``dv_rows`` (None for Luong, which has no ``v``), fp32;
    ``query`` / ``dq`` may carry leading step axes (the fusion scan sums its
    steps in the same product)."""
    Hq, A = query.shape[-1], dq.shape[-1]
    dwq = query.to(cdt).float().reshape(-1, Hq).t() @ dq.reshape(-1, A)
    return dwq, None if dv_rows is None else dv_rows.reshape(-1, A).sum(dim=0)


def attend_bwd(attention_type: str, params: Params, query: torch.Tensor, mem: AttentionMemory,
               weights: torch.Tensor, dctx: torch.Tensor, cdt: torch.dtype):
    """K10 backward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``attend_bwd_plain``."""
    if query.device.type == "cpu":
        return attend_bwd_plain(attention_type, params, query, mem, weights, dctx, cdt)
    _check_type(attention_type)
    _check_policy(cdt)
    return kernels.bahdanau_attend_bwd(
        query.float().contiguous(), *kernel_operands(attention_type, params, mem),
        weights.float().contiguous(), dctx.float().contiguous())


def _check_policy(cdt: torch.dtype) -> None:
    if cdt != torch.bfloat16:
        raise ValueError(f"the attention read kernels run the bf16 policy only, got {cdt}")


class BahdanauAttend(torch.autograd.Function):
    """K10 with its gradient: (context, weights) from the query, wq, v
    (None for Luong) and the memory's keys and values, for either score
    (``attention_type``, a non-tensor argument).  The weights feed no loss:
    they are marked non-differentiable, and a gradient arriving for them
    raises.  A Luong memory without ``wv`` passes one tensor as keys and
    values: its gradient is dkeys + dvalues, which autograd adds."""

    @staticmethod
    def forward(ctx, attention_type, query, wq, v, keys, values, bias, mask, cdt):
        mem = AttentionMemory(values=values, keys=keys, mask=mask, bias=bias)
        out, w = attend_fwd(attention_type, {"wq": wq, "v": v}, query, mem, cdt)
        ctx.save_for_backward(query, wq, v, keys, values, bias, mask, w)
        ctx.mark_non_differentiable(w)
        ctx.set_materialize_grads(False)
        ctx.cdt, ctx.attention_type = cdt, attention_type
        return out, w

    @staticmethod
    def backward(ctx, dctx, dw):
        if dw is not None:
            raise RuntimeError("the attention weights take no gradient")
        if dctx is None:
            return (None,) * 9
        query, wq, v, keys, values, bias, mask, w = ctx.saved_tensors
        mem = AttentionMemory(values=values, keys=keys, mask=mask, bias=bias)
        dquery, dq, dv_rows, dkeys, dvalues = attend_bwd(
            ctx.attention_type, {"wq": wq, "v": v}, query, mem, w, dctx, ctx.cdt)
        dwq, dv = attention_weight_grads(query, dq, dv_rows, ctx.cdt)
        # the cotangents of the reference's casts to the compute dtype
        dwq = rounded(dwq, ctx.cdt).to(wq.dtype)
        dv = None if dv is None else rounded(dv, ctx.cdt).to(v.dtype)
        return (None, dquery.to(query.dtype), dwq, dv, dkeys.to(keys.dtype),
                dvalues.to(values.dtype), None, None, None)


def attend(attention_type: str, params: Params, query: torch.Tensor, mem: AttentionMemory,
           cdt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 as the decoder calls it: through ``BahdanauAttend`` when autograd
    records a gradient for the query, the parameters or the memory, else
    straight to the forward wrapper; same contract as ``attend_plain``."""
    _check_type(attention_type)
    v = params.get("v")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (query, params["wq"], v, mem.keys, mem.values)):
        return BahdanauAttend.apply(attention_type, query, params["wq"], v, mem.keys,
                                    mem.values, mem.bias, mem.mask, cdt)
    return attend_fwd(attention_type, params, query, mem, cdt)
