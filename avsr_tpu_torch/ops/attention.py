"""Masked attention memories and the Bahdanau and Luong reads
(counterpart of ``avsr_tpu/ops/attention.py``).

A memory is prepared once: the mask, the additive bias (0 where valid,
-1e30 where padded), the optional value down-projection and the keys: for
Bahdanau attention the key projection ``bf16(memory) @ bf16(wm)`` kept in
fp32, for Luong attention the raw memory itself.  The transformer decoder
computes its own multi-head scores and reads only a memory's VALUES (the
reference's ``value_only`` path): its memories carry ``keys=None``.

``attend`` is one read per query row, kernel K10: for tensors on a GPU
``attend_fwd`` launches ``csrc/bahdanau_attend.cu`` (the row kernel's body is
``csrc/bahdanau_core.cuh``, shared with the AV-Align fusion scan K8, and
templated on the score; a beam step's read runs ``csrc/attend_grouped.cuh``,
``kernels.attend_route``), for tensors on the CPU it runs ``attend_plain``.
The memory may have fewer rows than the query: N = B W query rows over B
memory rows, query row n reading memory row n // W (the beam search's W
beams of an utterance read its one memory row, as the reference reads its
beam-tiled copy).  Per row, under the bf16 policy:

    q       = bf16(query) @ bf16(wq)                       (fp32)
    scores  = bf16(tanh(keys + q)) . bf16(v) + bias        (fp32, Bahdanau)
    scores  = bf16(keys) . bf16(q) + bias                  (fp32, Luong "general")
    weights = softmax(scores) * mask, renormalized, times min(sum(mask), 1)
    context = bf16(weights) @ bf16(values)                 (fp32)

so a memory of length 0 gives zero weights and a zero context.

When autograd records a gradient, the reads of one memory form a read loop
(``open_read_loop``; the teacher-forced decoder opens one per memory over
its K label positions, and a read outside a loop is a loop of one step),
as the reference differentiates ``attend`` inside its scan with the memory
closed over.  The loop casts the kernels' operands once.  Each read is a
``BahdanauAttend`` step; its backward (``read_step_bwd``: K10's per-step
kernel on a GPU, the plain mirror on the CPU) recomputes q (and the
Bahdanau energies) from the query, as the reference's ``jax.checkpoint``
does, returns dquery and saves the step's rows (the scores' cotangent, the
context's cotangent, q and the weight factors).  Once the last step's
backward has run, the loop's entry node forms the memory's gradients from
the rows (``read_loop_sums``: the sums kernels, or the mirror) and the
weight gradients as one product over the steps, so no step forms a
memory-sized gradient.  ``attend_bwd_plain`` is the per-step twin (the
hand-derived gradient JAX's autodiff takes through one read, with its
rounding points) against which the tests hold the loop.
``attend_batched_queries`` (every query of a known sequence at once) is
plain PyTorch, as the reference leaves it to XLA; no module calls it.

Under the fp32 policy (``train.compute_dtype="float32"``) every rounding
point above is the identity: the wrappers hand the kernels fp32 wq, v and
values (``kernel_operands`` casts to the compute dtype), which
``kernels.attend_route`` and ``kernels.attend_sums_family`` route to K10's
fp32 instances by dtype (the general kernel, the per-step backward and the
CUDA-core sums).  The Bahdanau read only: the Luong read's fp32 instance
(family "K10 Luong") is still to be ported and raises on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from avsr_tpu_torch import kernels
from avsr_tpu_torch.utils.numerics import check_policy, dot_f32, rounded
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


def memory_rows(mem: AttentionMemory, N: int) -> AttentionMemory:
    """The memory row of each of N query rows: row n reads memory row n // W
    of a memory of B rows, N = B W (the rows as they are when N == B); the
    same values as the memory tiled W times, beams contiguous per row."""
    B = mem.mask.shape[0]
    if N < 1 or B < 1 or N % B:
        raise ValueError(f"attend: {N} query rows over {B} memory rows; N must be a positive "
                         f"multiple of B")
    if N == B:
        return mem
    idx = torch.arange(N, device=mem.mask.device) // (N // B)
    keys = None if mem.keys is None else mem.keys.index_select(0, idx)
    return AttentionMemory(values=mem.values.index_select(0, idx), keys=keys,
                           mask=mem.mask.index_select(0, idx), bias=mem.bias.index_select(0, idx))


def attend_plain(attention_type: str, params: Params, query: torch.Tensor,
                 mem: AttentionMemory, cdt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch K10: query [N, Q] over a memory of B rows, N = B W, row
    n reading memory row n // W -> (context [N, V] fp32, weights [N, S]
    fp32, padded positions exactly 0)."""
    _check_type(attention_type)
    mem = memory_rows(mem, query.shape[0])
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


def attend_batched_queries(attention_type: str, params: Params, queries: torch.Tensor,
                           mem: AttentionMemory, cdt: torch.dtype
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-timesteps attention (the reference's ``attend_batched_queries``):
    queries [B, T, Q] over the memory [B, S, .] -> (contexts [B, T, V] fp32,
    weights [B, T, S] fp32), the weights renormalised over the valid
    positions with the reference's 1e-9 floor (an empty memory's rows are
    0); compute-dtype operands, fp32 products."""
    _check_type(attention_type)
    q = dot_f32(queries, params["wq"], cdt)                      # [B, T, A] (Luong: [B, T, H])
    if attention_type == "bahdanau":
        e = torch.tanh(mem.keys[:, None, :, :] + q[:, :, None, :])  # [B, T, S, A] fp32
        scores = torch.einsum("btsa,a->bts", e.to(cdt).float(), params["v"].to(cdt).float())
    else:
        scores = torch.einsum("bth,bsh->bts", q.to(cdt).float(), mem.keys.to(cdt).float())
    scores = scores + mem.bias[:, None, :]
    weights = torch.softmax(scores, dim=-1) * mem.mask[:, None, :]
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-9)
    contexts = torch.einsum("bts,bsh->bth", weights.to(cdt).float(), mem.values.to(cdt).float())
    return contexts, weights


def attend_fwd(attention_type: str, params: Params, query: torch.Tensor, mem: AttentionMemory,
               cdt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 forward wrapper: the CUDA kernel for GPU tensors (the grouped
    read or the row kernel, ``kernels.attend_route``), the plain version on
    the CPU; same contract as ``attend_plain``.  The kernels run the bf16
    policy, and the Bahdanau read the fp32 one too; any other family or
    compute dtype on a GPU raises rather than falling back."""
    if query.device.type == "cpu":
        return attend_plain(attention_type, params, query, mem, cdt)
    _check_type(attention_type)
    check_policy(cdt, policy_family(attention_type))
    return kernels.bahdanau_attend(
        query.float().contiguous(), *kernel_operands(attention_type, params, mem, cdt),
        mem.bias.float().contiguous(), mem.mask.float().contiguous())


def policy_family(attention_type: str) -> str:
    """K10's kernel family for ``numerics.check_policy``: "K10", or "K10
    Luong" (its Luong read, whose fp32 instance is still to be ported)."""
    return "K10 Luong" if attention_type == "luong" else "K10"


def kernel_operands(attention_type: str, params: Params, mem: AttentionMemory,
                    cdt: torch.dtype):
    """(wq, v, keys, values) as the read kernels take them: wq and values
    in the compute dtype; Bahdanau's v in the compute dtype and fp32 keys,
    or Luong's keys in the compute dtype and no v (one copy serves as both
    when the keys are the values)."""
    values = mem.values.to(cdt).contiguous()
    if attention_type == "luong":
        keys = values if mem.keys is mem.values else mem.keys.to(cdt).contiguous()
        v = None
    else:
        keys, v = mem.keys.float().contiguous(), params["v"].to(cdt).contiguous()
    return params["wq"].to(cdt).contiguous(), v, keys, values


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


class LoopState:
    """What the steps of one memory's read loop share (``open_read_loop``):
    the kernels' operands, cast once (``kernel_operands``), the steps'
    queries and weights, and the saved buffers, each [steps, N, *] fp32, of
    which a step's backward writes slot k: the scores' cotangent ``dsc``,
    the context's cotangent ``dctx``, ``q`` (Luong: bf16(q)), the weight
    factors ``dq`` and, for Bahdanau, ``dv_rows``.  It holds no tensor that
    carries a grad_fn (so no reference cycle through the graph)."""

    def __init__(self, attention_type: str, mem: AttentionMemory, cdt: torch.dtype, steps: int):
        _check_type(attention_type)
        self.attention_type, self.cdt, self.steps = attention_type, cdt, steps
        self.mask, self.bias = mem.mask.detach(), mem.bias.detach()
        # one memory tensor as keys and values (a Luong memory without wv)
        self.shared = mem.keys is mem.values
        self.n = 0  # steps read so far
        self.queries = [None] * steps
        self.weights = [None] * steps
        self.done = [False] * steps
        N, S = mem.mask.shape
        A, Dv = mem.keys.shape[-1], mem.values.shape[-1]
        dev = mem.values.device

        def empty(*shape):
            return torch.empty((steps, *shape), dtype=torch.float32, device=dev)

        self.dsc, self.dctx, self.q, self.dq = empty(N, S), empty(N, Dv), empty(N, A), empty(N, A)
        self.dv_rows = None if attention_type == "luong" else empty(N, A)
        self.params = self.mem = self.operands = None  # set by bind

    def bind(self, keys: torch.Tensor, values: torch.Tensor, wq: torch.Tensor,
             v: Optional[torch.Tensor]) -> None:
        """The reads' operands (detached), and the kernels' cast once."""
        values_d = values.detach()
        keys_d = values_d if keys is values else keys.detach()  # one cast serves both
        self.mem = AttentionMemory(values=values_d, keys=keys_d, mask=self.mask, bias=self.bias)
        self.params = {"wq": wq.detach(), "v": None if v is None else v.detach()}
        if values.device.type != "cpu":
            check_policy(self.cdt, policy_family(self.attention_type))
            self.operands = kernel_operands(self.attention_type, self.params, self.mem, self.cdt)

    def next_step(self) -> int:
        if self.n == self.steps:
            raise RuntimeError(f"the read loop was opened for {self.steps} steps")
        self.n += 1
        return self.n - 1


class ReadLoop(NamedTuple):
    """One memory's reads over a loop of up to ``steps`` steps under autograd
    (the teacher-forced decoder's K label positions; a read outside a loop
    is a loop of one step).  Opening it enters the memory and the read's
    weights into the graph through one ``_ReadLoopEnter`` node, whose
    output ``token`` every step's ``BahdanauAttend`` takes.  A step's
    backward writes its rows of the state's buffers and returns only
    dquery; autograd calls the entry node's backward once, after the last
    step's, and it forms the memory's and the weights' gradients from the
    rows (``loop_gradients``)."""

    state: LoopState
    token: torch.Tensor


class _ReadLoopEnter(torch.autograd.Function):
    """The memory (keys, values) and the read's weights (wq, v) entering a
    ``ReadLoop``: forward casts the operands once and returns an empty
    token; backward, called once after every step's, returns the loop's
    summed gradients (the steps return none for these inputs)."""

    @staticmethod
    def forward(ctx, loop, keys, values, wq, v):
        keys = values if keys is None else keys
        loop.bind(keys, values, wq, v)
        ctx.loop = loop
        ctx.dtypes = (keys.dtype, values.dtype, wq.dtype, None if v is None else v.dtype)
        ctx.set_materialize_grads(False)
        return values.new_empty((0,))

    @staticmethod
    def backward(ctx, _):
        dkeys, dvalues, dwq, dv = loop_gradients(ctx.loop)
        kd, vd, wd, dvd = ctx.dtypes
        if ctx.loop.shared:
            return None, None, (dkeys + dvalues).to(vd), dwq.to(wd), None
        return (None, dkeys.to(kd), dvalues.to(vd), dwq.to(wd),
                None if dv is None else dv.to(dvd))


def loop_gradients(loop: LoopState):
    """(dkeys, dvalues, dwq, dv) of a loop's steps so far, fp32: a step
    whose backward did not run (its context reached no loss) adds nothing.
    The memory's are the sums after the loop (``read_loop_sums``); the
    weights' are one product over the steps, each step's rounded to the
    compute dtype before the steps are summed, as the reference's
    transposed casts round them inside its scan."""
    n, cdt = loop.n, loop.cdt
    for k in range(n):
        if not loop.done[k]:
            for buf in (loop.dsc, loop.dctx, loop.q, loop.dq, loop.dv_rows):
                if buf is not None:
                    buf[k].zero_()
    loop.done = [False] * loop.steps  # a second backward through the graph rewrites every row
    dkeys, dvalues = read_loop_sums(loop)
    queries = torch.stack(loop.queries[:n]).to(cdt).float()          # [n, N, Hq]
    dwq = rounded(torch.bmm(queries.transpose(1, 2), loop.dq[:n]), cdt).sum(dim=0)
    dv = None
    if loop.dv_rows is not None:
        dv = rounded(loop.dv_rows[:n].sum(dim=1), cdt).sum(dim=0)
    return dkeys, dvalues, dwq, dv


def read_fwd_plain(loop: LoopState, query: torch.Tensor):
    """A loop step's read, plain: ``attend_plain`` on the loop's memory."""
    return attend_plain(loop.attention_type, loop.params, query, loop.mem, loop.cdt)


def read_fwd(loop: LoopState, query: torch.Tensor):
    """A loop step's read: K10's forward kernel on the loop's operands (cast
    once) for GPU tensors, ``read_fwd_plain`` on the CPU."""
    if query.device.type == "cpu":
        return read_fwd_plain(loop, query)
    return kernels.bahdanau_attend(query.float().contiguous(), *loop.operands,
                                   loop.bias.float().contiguous(),
                                   loop.mask.float().contiguous())


def read_step_bwd_plain(loop: LoopState, k: int, query: torch.Tensor, weights: torch.Tensor,
                        dctx: torch.Tensor) -> torch.Tensor:
    """Plain mirror of K10's per-step backward kernel: ``attend_bwd_plain``
    without the memory's gradients.  Writes step k's rows of the loop's
    buffers (dsc, dctx, q (Luong: bf16(q)), dq, dv_rows) and returns
    dquery [N, Hq] fp32."""
    typ, cdt, params, mem = loop.attention_type, loop.cdt, loop.params, loop.mem
    dctx = dctx.float()
    q = dot_f32(query, params["wq"], cdt)
    dw = rounded(torch.einsum("nd,nsd->ns", dctx, mem.values.to(cdt).float()), cdt)
    dsc = weights * (dw - (weights * dw).sum(dim=-1, keepdim=True))
    if typ == "luong":
        q = rounded(q, cdt)
        dq = rounded(torch.einsum("ns,nsh->nh", dsc, mem.keys.to(cdt).float()), cdt)
    else:
        e = torch.tanh(mem.keys.float() + q[:, None, :])
        deb = rounded(dsc[:, :, None] * params["v"].to(cdt).float(), cdt)
        dq = ((deb + deb * e) * (1.0 - e)).sum(dim=1)
        loop.dv_rows[k] = torch.einsum("nsa,ns->na", e.to(cdt).float(), dsc)
    loop.dsc[k], loop.dctx[k], loop.q[k], loop.dq[k] = dsc, dctx, q, dq
    return rounded(dq @ params["wq"].to(cdt).float().t(), cdt)


def read_step_bwd(loop: LoopState, k: int, query: torch.Tensor, weights: torch.Tensor,
                  dctx: torch.Tensor) -> torch.Tensor:
    """K10's per-step backward: the CUDA kernel for GPU tensors, the plain
    mirror on the CPU; same contract as ``read_step_bwd_plain``."""
    if query.device.type == "cpu":
        return read_step_bwd_plain(loop, k, query, weights, dctx)
    return kernels.attend_step_bwd(
        query.float().contiguous(), *loop.operands, weights.float().contiguous(),
        dctx.float().contiguous(), loop.dsc[k], loop.dctx[k], loop.q[k], loop.dq[k],
        None if loop.dv_rows is None else loop.dv_rows[k])


def read_loop_sums_plain(loop: LoopState):
    """Plain mirror of the sums after the loop: (dkeys [N,S,A], dvalues
    [N,S,Dv]) fp32 over the loop's n steps so far, each term formed exactly
    and summed in fp32 (the reference rounds each step's dvalues, and
    Luong's dkeys, term to the compute dtype):

        dvalues = sum_k bf16(w[k])^T (x) dctx[k]
        Luong dkeys = sum_k dsc[k]^T (x) bf16(q[k])
        Bahdanau dkeys = sum_k (deb + deb * e) * (1 - e),  e = tanh(keys + q[k]),
            deb = bf16(dsc[k] * bf16(v))
    """
    n, cdt = loop.n, loop.cdt
    w = torch.stack(loop.weights[:n]).to(cdt).float()
    dvalues = torch.einsum("kns,knd->nsd", w, loop.dctx[:n])
    if loop.attention_type == "luong":
        return torch.einsum("kns,kna->nsa", loop.dsc[:n], loop.q[:n]), dvalues
    keys = loop.mem.keys.float()
    v_c = loop.params["v"].to(cdt).float()
    dkeys = torch.zeros_like(keys)
    for k in range(n):
        e = torch.tanh(keys + loop.q[k][:, None, :])
        deb = rounded(loop.dsc[k][:, :, None] * v_c, cdt)
        dkeys += (deb + deb * e) * (1.0 - e)
    return dkeys, dvalues


def read_loop_sums(loop: LoopState):
    """The memory's gradients of a loop, once after its last step: the sums
    kernels (``kernels.attend_loop_sums``) for GPU tensors, the plain
    mirror on the CPU; same contract as ``read_loop_sums_plain``."""
    if loop.dsc.device.type == "cpu":
        return read_loop_sums_plain(loop)
    n = loop.n
    wq, v, keys, values = loop.operands
    return kernels.attend_loop_sums(
        keys, v, torch.stack(loop.weights[:n]), loop.q[:n], loop.dsc[:n], loop.dctx[:n])


class BahdanauAttend(torch.autograd.Function):
    """One step of a ``ReadLoop`` (either score): (context, weights) from the
    loop's state, the query and the loop's token.  Its backward runs the per-step backward
    (``read_step_bwd``), which writes the step's rows of the loop's buffers,
    and returns dquery only: the memory's and the weights' gradients come
    from the loop's entry node, once.  The weights feed no loss: they are
    marked non-differentiable, and a gradient arriving for them raises."""

    @staticmethod
    def forward(ctx, loop, query, token):
        if query.shape[0] != loop.mask.shape[0]:
            raise ValueError(f"a read loop takes a query row per memory row, got "
                             f"{query.shape[0]} over {loop.mask.shape[0]}")
        k = loop.next_step()
        out, w = read_fwd(loop, query)
        loop.queries[k], loop.weights[k] = query.detach(), w
        ctx.loop, ctx.k = loop, k
        ctx.mark_non_differentiable(w)
        ctx.set_materialize_grads(False)
        return out, w

    @staticmethod
    def backward(ctx, dctx, dw):
        if dw is not None:
            raise RuntimeError("the attention weights take no gradient")
        if dctx is None:
            return None, None, None
        loop, k = ctx.loop, ctx.k
        query = loop.queries[k]
        dquery = read_step_bwd(loop, k, query, loop.weights[k], dctx)
        loop.done[k] = True
        return None, dquery.to(query.dtype), None


def open_read_loop(attention_type: str, params: Params, mem: AttentionMemory, cdt: torch.dtype,
                   steps: int, query: Optional[torch.Tensor] = None) -> Optional[ReadLoop]:
    """A ``ReadLoop`` of up to ``steps`` reads of ``mem`` when autograd
    records a gradient for the memory, the read's weights or ``query``, else
    None (the reads then need none of it).  When only the query takes one,
    the token carries no graph and the steps return dquery alone."""
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (params["wq"], params.get("v"), mem.keys, mem.values, query))):
        return None
    state = LoopState(attention_type, mem, cdt, steps)
    token = _ReadLoopEnter.apply(state, None if state.shared else mem.keys, mem.values,
                                 params["wq"], params.get("v"))
    return ReadLoop(state, token)


def attend(attention_type: str, params: Params, query: torch.Tensor, mem: AttentionMemory,
           cdt: torch.dtype, *, loop: Optional[ReadLoop] = None) -> Tuple[torch.Tensor,
                                                                           torch.Tensor]:
    """K10 as the decoder calls it: a step of ``loop`` (opened on the same
    params and memory) when one is given; through a loop of one step when
    autograd records a gradient for the query, the parameters or the
    memory; else straight to the forward wrapper.  Same contract as
    ``attend_plain``."""
    _check_type(attention_type)
    if loop is None:
        loop = open_read_loop(attention_type, params, mem, cdt, 1, query)
    if loop is not None:
        return BahdanauAttend.apply(loop.state, query, loop.token)
    return attend_fwd(attention_type, params, query, mem, cdt)
