"""Fusion encoders (counterpart of ``avsr_tpu/models/fusion.py``): the
AV-Align recurrent fusion (``av_align_init`` / ``av_align_apply``) and the
cross-attention fusion (``cross_attention_fusion_init`` /
``cross_attention_fusion_apply``), with the AU head and
``au_regression_loss``.  Both return the fused decoder memory
[audio ; attended visual context], time-major, with padded steps exactly
zero.

AV-Align (the reference-dims model): a unidirectional LSTM over the audio
encoder's output with input feeding; at every audio step one attention read
(Bahdanau or Luong, ``FusionConfig.attention_type``) of the video memory
with the new h as the query; the memory is [h ; ctx].
The scan body (``fusion.py:118-141``) is kernel K8: ``av_align_scan_fwd``
launches ``csrc/av_align_scan.cu`` for tensors on a GPU (at the presets'
widths one launch of thread-block clusters a call, ``csrc/av_align_fwd.cuh``;
``kernels.av_align_family`` routes by shape) and runs
``av_align_scan_fwd_plain`` (a loop of ``lstm_step`` and ``attend_plain``)
for tensors on the CPU.  When a gradient is wanted, ``av_align_scan`` goes
through ``AVAlignScan``: its forward saves the fp32 carries entering each
step (h, c, ctx: what the reference's ``jax.checkpoint`` keeps), its
backward is the reverse scan with the gates and the read recomputed from
them (``av_align_scan_bwd``: the CUDA kernels on a GPU,
``av_align_scan_bwd_plain`` on the CPU).  The kernels' decomposition, a
reverse scan that saves the scores' and the context's cotangents, then the
memory's gradients summed over the steps after it, is mirrored in plain
PyTorch by ``av_align_scan_bwd_split_plain``.  The weight gradients of Wh,
ctx_proj, wq and v are single products over all steps after the scan.
The attention type is a non-tensor argument of every function of the scan
(``attention_type``), and the kernels take either score under the bf16
policy; under the fp32 policy (``train.compute_dtype="float32"``) the
wrappers hand the kernels fp32 operands and ``kernels.av_align_family``
routes them to the per-step kernels' fp32 instance (the Bahdanau read:
the Luong read's fp32 instance, family "K8 Luong", is still to be ported
and raises on the card).  The hoisted fp32
input product, the memory preparation, the AU head and the concat stay
torch code.

Cross-attention: multi-head attention with audio queries over video
keys/values.  Key padding adds -1e9 to the scores and the softmax runs in
fp32.  Its core (scores, mask, softmax, P.V; ``fusion.py:226-235``) is
kernel K4: ``FusionAttention`` is its ``torch.autograd.Function``, and
``fusion_attention_fwd`` / ``fusion_attention_bwd`` launch the CUDA kernels
(``csrc/cross_attention.cu`` on the tensor cores) for tensors on a GPU and
run the plain versions for tensors on the CPU.  The backward's residual is
the softmax's row statistics, from which it recomputes the weights.  The projections, the audio mask, the
head mean for the alignments and the AU head stay torch code, as the
reference leaves them to XLA as plain matmuls.  The alignments feed no
loss, so the weights output of the core carries no gradient.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from avsr_tpu_torch.configs import FusionConfig
from avsr_tpu_torch import kernels
from avsr_tpu_torch.ops import attention as attn
from avsr_tpu_torch.ops import rnn
from avsr_tpu_torch.utils.numerics import check_policy, dot_f32, rounded
from avsr_tpu_torch.utils.params import Params, glorot_uniform, zeros


class FusionOutput(NamedTuple):
    fused: torch.Tensor           # [T_a, B, H_a + H_v] fused decoder memory
    alignments: torch.Tensor      # [T_a, B, T_v] (head-averaged) attention weights
    au_predictions: Optional[torch.Tensor]  # [T_a, B, au_dim] or None


def av_align_init(gen: torch.Generator, cfg: FusionConfig, audio_input_dim: int,
                  audio_hidden: int, video_dim: int, device) -> Params:
    """The fusion LSTM cell (its ``wx`` covers the acoustic input only), the
    attention over the video memory, the context-input projection
    (input feeding) and the AU head, with the reference's keys and shapes."""
    params: Params = {
        "cell": rnn.lstm_init(gen, audio_input_dim, audio_hidden, device),
        "att": attn.attention_init(cfg.attention_type, gen, audio_hidden, video_dim,
                                   cfg.attention_units, device, value_dim=cfg.memory_value_dim),
    }
    ctx_dim = cfg.memory_value_dim or video_dim
    if cfg.input_feeding:
        params["ctx_proj"] = glorot_uniform(gen, (ctx_dim, 4 * audio_hidden), device)
    if cfg.au_loss_weight > 0.0:
        params["au_w"] = glorot_uniform(gen, (ctx_dim, cfg.au_dim), device)
        params["au_b"] = zeros((cfg.au_dim,), device)
    return params


def av_align_scan_fwd_plain(cell: Params, att: Params, ctx_proj: Optional[torch.Tensor],
                            xw: torch.Tensor, mask: torch.Tensor, mem: attn.AttentionMemory,
                            cdt: torch.dtype, save: bool = False, *,
                            attention_type: str = "bahdanau"):
    """Plain-PyTorch K8 forward: the reference's scan body, step by step.

    xw [T,B,4H] fp32 (the hoisted input product), mask [T,B] fp32, the
    prepared video memory -> ((hs [T,B,H], ctxs [T,B,Dv], aligns [T,B,T_v],
    hT, cT, ctxT), res), all fp32, from zero initial carries; res is
    (h_res, c_res, ctx_res), the carries entering each step, when ``save``,
    else None.
    """
    T, B, _ = xw.shape
    H = cell["wh"].shape[0]
    dev = xw.device
    h = torch.zeros((B, H), dtype=torch.float32, device=dev)
    c = torch.zeros((B, H), dtype=torch.float32, device=dev)
    ctx = torch.zeros((B, mem.values.shape[-1]), dtype=torch.float32, device=dev)
    hs, ctxs, aligns, res = [], [], [], ([], [], [])
    for t in range(T):
        if save:
            for r, x in zip(res, (h, c, ctx)):
                r.append(x)
        gate_in = xw[t]
        if ctx_proj is not None:
            gate_in = gate_in + dot_f32(ctx, ctx_proj, cdt)
        (h_new, c_new), _ = rnn.lstm_step(cell, gate_in, (h, c), cdt, preprojected=True)
        ctx_new, align = attn.attend_plain(attention_type, att, h_new, mem, cdt)
        m = mask[t][:, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ctx = m * ctx_new + (1.0 - m) * ctx
        hs.append(h_new * m)
        ctxs.append(ctx_new * m)
        aligns.append(align * m)
    out = (torch.stack(hs), torch.stack(ctxs), torch.stack(aligns), h, c, ctx)
    return out, (tuple(torch.stack(r) for r in res) if save else None)


def av_align_scan_plain(cell: Params, att: Params, ctx_proj: Optional[torch.Tensor],
                        xw: torch.Tensor, mask: torch.Tensor, mem: attn.AttentionMemory,
                        cdt: torch.dtype, *, attention_type: str = "bahdanau"):
    """Plain-PyTorch K8 forward, outputs only: (hs, ctxs, aligns, (hT, cT,
    ctxT))."""
    (hs, ctxs, aligns, hT, cT, ctxT), _ = av_align_scan_fwd_plain(
        cell, att, ctx_proj, xw, mask, mem, cdt, attention_type=attention_type)
    return hs, ctxs, aligns, (hT, cT, ctxT)


def _cell_operands(cell: Params, ctx_proj: Optional[torch.Tensor], cdt: torch.dtype):
    """(wh, b, ctx_proj) as K8's kernels take them: the weights in the
    compute dtype, the bias fp32."""
    return (cell["wh"].to(cdt).contiguous(), cell["b"].float().contiguous(),
            None if ctx_proj is None else ctx_proj.to(cdt).contiguous())


def _family(attention_type: str) -> str:
    """K8's kernel family for ``numerics.check_policy``: "K8", or "K8 Luong"
    (its Luong read, whose fp32 instance is still to be ported)."""
    return "K8 Luong" if attention_type == "luong" else "K8"


def av_align_scan_fwd(cell: Params, att: Params, ctx_proj: Optional[torch.Tensor],
                      xw: torch.Tensor, mask: torch.Tensor, mem: attn.AttentionMemory,
                      cdt: torch.dtype, save: bool = False, *,
                      attention_type: str = "bahdanau"):
    """K8 forward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``av_align_scan_fwd_plain``.  The
    kernels run the bf16 policy, and the Bahdanau read the fp32 one too (its
    operands in ``cdt``); any other family or compute dtype on a GPU
    raises rather than falling back."""
    if xw.device.type == "cpu":
        return av_align_scan_fwd_plain(cell, att, ctx_proj, xw, mask, mem, cdt, save,
                                       attention_type=attention_type)
    check_policy(cdt, _family(attention_type))
    wq, v, keys, values = attn.kernel_operands(attention_type, att, mem, cdt)
    hs, ctxs, aligns, hT, cT, ctxT, res = kernels.av_align_scan(
        *_cell_operands(cell, ctx_proj, cdt), wq, v, xw.float().contiguous(),
        mask.float().contiguous(), keys, values, mem.bias.float().contiguous(),
        mem.mask.float().contiguous(), save=save)
    return (hs, ctxs, aligns, hT, cT, ctxT), res


def av_align_scan_bwd_plain(cell: Params, att: Params, ctx_proj: Optional[torch.Tensor],
                            xw: torch.Tensor, mask: torch.Tensor, mem: attn.AttentionMemory,
                            aligns: torch.Tensor, res, dhs: torch.Tensor, dctxs: torch.Tensor,
                            dhT: torch.Tensor, dcT: torch.Tensor, dctxT: torch.Tensor,
                            cdt: torch.dtype, *, attention_type: str = "bahdanau"):
    """Plain-PyTorch K8 backward: the reverse scan of the gradient JAX's
    autodiff takes through the rematerialized body (``fusion.py:118-141``).

    Per step t, from T-1 down to 0: the gates, h' and the read recomputed
    from the saved carries ``res`` = (h_res, c_res, ctx_res) [T,B,*] fp32;
    the transpose of the masked carry update; the read's backward
    (``attend_bwd_plain``) with the forward's weights ``aligns[t]`` (a
    masked row's read gets a zero cotangent); the LSTM cell backward; and
    the carries' cotangents through ``Wh`` and ``ctx_proj`` (rounded to the
    compute dtype, as the transposes of the reference's casts are).

    Returns (dxw [T,B,4H], db [4H], dq [T,B,A], dv_rows [B,A] (None for
    Luong), dkeys [B,S,A], dvalues [B,S,Dv], hnew [T,B,H]), all fp32: dxw
    is dgates, and dq, dv_rows and hnew (the read's queries) are the factors
    of the weight gradients (``av_align_weight_grads``); A is the key width
    (Luong: the memory's).
    """
    h_res, c_res, ctx_res = res
    T, B, H4 = xw.shape
    wh_c = cell["wh"].to(cdt).float()
    cp_c = None if ctx_proj is None else ctx_proj.to(cdt).float()
    dh, dc, dctx = dhT.float(), dcT.float(), dctxT.float()
    db = torch.zeros((H4,), dtype=torch.float32, device=xw.device)
    dkeys = torch.zeros(mem.keys.shape, dtype=torch.float32, device=xw.device)
    dvalues = torch.zeros(mem.values.shape, dtype=torch.float32, device=xw.device)
    dv_rows = None
    if attention_type != "luong":
        dv_rows = torch.zeros((B, mem.keys.shape[-1]), dtype=torch.float32, device=xw.device)
    dxw, dq, hnew = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        m = mask[t][:, None]
        h_prev, c_prev, ctx_prev = h_res[t], c_res[t], ctx_res[t]
        gates = xw[t].float()
        if cp_c is not None:
            gates = gates + ctx_prev.to(cdt).float() @ cp_c
        gates = gates + h_prev.to(cdt).float() @ wh_c
        gates = gates + cell["b"]
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        g = torch.tanh(gg)
        tc = torch.tanh(f * c_prev + i * g)
        h_new = o * tc
        dctx_new = m * (dctx + dctxs[t])
        dquery, dq[t], dv_t, dk_t, dval_t = attn.attend_bwd_plain(
            attention_type, att, h_new, mem, aligns[t], dctx_new, cdt)
        dkeys += dk_t
        dvalues += dval_t
        if dv_rows is not None:
            dv_rows += dv_t
        hnew[t] = h_new
        dh_new = m * (dh + dhs[t]) + dquery
        dc_new = m * dc + dh_new * o * (1.0 - tc * tc)
        dgates = torch.cat([dc_new * g * i * (1.0 - i), dc_new * c_prev * f * (1.0 - f),
                            dc_new * i * (1.0 - g * g), dh_new * tc * o * (1.0 - o)], dim=-1)
        dc = dc_new * f + (1.0 - m) * dc
        dh = rounded(dgates @ wh_c.t(), cdt) + (1.0 - m) * dh
        dctx = (1.0 - m) * dctx
        if cp_c is not None:
            dctx = rounded(dgates @ cp_c.t(), cdt) + dctx
        db += dgates.sum(dim=0)
        dxw[t] = dgates
    return (torch.stack(dxw), db, torch.stack(dq), dv_rows, dkeys, dvalues, torch.stack(hnew))


def av_align_scan_bwd_split_plain(cell: Params, att: Params, ctx_proj: Optional[torch.Tensor],
                                  xw: torch.Tensor, mask: torch.Tensor, mem: attn.AttentionMemory,
                                  aligns: torch.Tensor, res, dhs: torch.Tensor,
                                  dctxs: torch.Tensor, dhT: torch.Tensor, dcT: torch.Tensor,
                                  dctxT: torch.Tensor, cdt: torch.dtype, *,
                                  attention_type: str = "bahdanau"):
    """Plain-PyTorch mirror of the K8 backward kernel's decomposition
    (``csrc/av_align_bwd.cuh``), same contract as ``av_align_scan_bwd_plain``.

    The reverse scan saves, per step, the scores' cotangent dsc [T,B,S],
    the read's cotangent dctx' [T,B,Dv] and q [T,B,A] (Luong: bf16(q)), and
    never touches the memory's gradients; the carries' products take
    bf16(dgates), as the kernel's tensor-core product does.  After the
    scan the memory's gradients are sums over t of the per-step terms, each
    formed exactly and summed in fp32 (the twin rounds each step's term to
    the compute dtype, as the reference's transposed casts do):

        dvalues = sum_t bf16(w[t])^T (x) dctx'[t]
        Luong dkeys = sum_t dsc[t]^T (x) bf16(q[t])
        Bahdanau dkeys = sum_t (deb + deb * e) * (1 - e),  e = tanh(keys + q[t]),
            deb = bf16(dsc[t] * bf16(v));  dv_rows = sum_t sum_s dsc * bf16(e)
    """
    h_res, c_res, ctx_res = res
    T, B, H4 = xw.shape
    luong = attention_type == "luong"
    wh_c = cell["wh"].to(cdt).float()
    cp_c = None if ctx_proj is None else ctx_proj.to(cdt).float()
    wq_c = att["wq"].to(cdt).float()
    values_c = mem.values.to(cdt).float()
    keys_c = mem.keys.to(cdt).float() if luong else mem.keys.float()
    v_c = None if luong else att["v"].to(cdt).float()
    dh, dc, dctx = dhT.float(), dcT.float(), dctxT.float()
    db = torch.zeros((H4,), dtype=torch.float32, device=xw.device)
    dxw, dq, hnew, dsc_all, dctxp, q_all = ([None] * T for _ in range(6))
    for t in reversed(range(T)):
        m = mask[t][:, None]
        h_prev, c_prev, ctx_prev = h_res[t], c_res[t], ctx_res[t]
        gates = xw[t].float()
        if cp_c is not None:
            gates = gates + ctx_prev.to(cdt).float() @ cp_c
        gates = gates + h_prev.to(cdt).float() @ wh_c + cell["b"]
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        g = torch.tanh(gg)
        tc = torch.tanh(f * c_prev + i * g)
        h_new = o * tc
        # the read backward without the memory's gradients: dsc, dq, dquery
        q = dot_f32(h_new, att["wq"], cdt)
        w = aligns[t]
        dctx_new = m * (dctx + dctxs[t])
        dw = rounded(torch.einsum("bd,bsd->bs", dctx_new, values_c), cdt)
        dsc = w * (dw - (w * dw).sum(dim=-1, keepdim=True))
        if luong:
            q = rounded(q, cdt)
            dq[t] = rounded(torch.einsum("bs,bsa->ba", dsc, keys_c), cdt)
        else:
            e = torch.tanh(keys_c + q[:, None, :])
            deb = rounded(dsc[:, :, None] * v_c, cdt)
            dq[t] = ((deb + deb * e) * (1.0 - e)).sum(dim=1)
        dquery = rounded(dq[t] @ wq_c.t(), cdt)
        dsc_all[t], dctxp[t], q_all[t], hnew[t] = dsc, dctx_new, q, h_new
        # the cell backward and the carries' products
        dh_new = m * (dh + dhs[t]) + dquery
        dc_new = m * dc + dh_new * o * (1.0 - tc * tc)
        dgates = torch.cat([dc_new * g * i * (1.0 - i), dc_new * c_prev * f * (1.0 - f),
                            dc_new * i * (1.0 - g * g), dh_new * tc * o * (1.0 - o)], dim=-1)
        dc = dc_new * f + (1.0 - m) * dc
        dg_c = rounded(dgates, cdt)
        dh = rounded(dg_c @ wh_c.t(), cdt) + (1.0 - m) * dh
        dctx = (1.0 - m) * dctx
        if cp_c is not None:
            dctx = rounded(dg_c @ cp_c.t(), cdt) + dctx
        db += dgates.sum(dim=0)
        dxw[t] = dgates
    # the memory's gradients, summed over the steps after the scan
    dsc_all, dctxp, q_all = torch.stack(dsc_all), torch.stack(dctxp), torch.stack(q_all)
    dvalues = torch.einsum("tbs,tbd->bsd", aligns.to(cdt).float(), dctxp)
    dv_rows = None
    if luong:
        dkeys = torch.einsum("tbs,tba->bsa", dsc_all, q_all)
    else:
        dkeys = torch.zeros_like(keys_c)
        dv_rows = torch.zeros((B, keys_c.shape[-1]), dtype=torch.float32, device=xw.device)
        for t in range(T):
            e = torch.tanh(keys_c + q_all[t][:, None, :])
            deb = rounded(dsc_all[t][:, :, None] * v_c, cdt)
            dkeys += (deb + deb * e) * (1.0 - e)
            dv_rows += torch.einsum("bsa,bs->ba", e.to(cdt).float(), dsc_all[t])
    return (torch.stack(dxw), db, torch.stack(dq), dv_rows, dkeys, dvalues, torch.stack(hnew))


def av_align_scan_bwd(cell: Params, att: Params, ctx_proj: Optional[torch.Tensor],
                      xw: torch.Tensor, mask: torch.Tensor, mem: attn.AttentionMemory,
                      aligns: torch.Tensor, res, dhs: torch.Tensor, dctxs: torch.Tensor,
                      dhT: torch.Tensor, dcT: torch.Tensor, dctxT: torch.Tensor,
                      cdt: torch.dtype, *, attention_type: str = "bahdanau"):
    """K8 backward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``av_align_scan_bwd_plain``."""
    if xw.device.type == "cpu":
        return av_align_scan_bwd_plain(cell, att, ctx_proj, xw, mask, mem, aligns, res, dhs,
                                       dctxs, dhT, dcT, dctxT, cdt,
                                       attention_type=attention_type)
    check_policy(cdt, _family(attention_type))
    wq, v, keys, values = attn.kernel_operands(attention_type, att, mem, cdt)
    return kernels.av_align_scan_bwd(
        *_cell_operands(cell, ctx_proj, cdt), wq, v, xw.float().contiguous(),
        mask.float().contiguous(), keys, values, aligns.float().contiguous(),
        *(r.float().contiguous() for r in res), dhs.float().contiguous(),
        dctxs.float().contiguous(), dhT.float().contiguous(), dcT.float().contiguous(),
        dctxT.float().contiguous())


def av_align_weight_grads(res, ctx_proj: Optional[torch.Tensor], dxw: torch.Tensor,
                          dq: torch.Tensor, dv_rows: torch.Tensor, hnew: torch.Tensor,
                          cdt: torch.dtype):
    """dWh, dctx_proj (None without input feeding), dwq and dv (None for
    Luong), each one fp32 product over all steps (the reference sums the same per-step
    products inside its scan)."""
    h_res, _, ctx_res = res
    H4 = dxw.shape[-1]
    flat = dxw.reshape(-1, H4)
    dwh = h_res.to(cdt).float().reshape(-1, h_res.shape[-1]).t() @ flat
    dcp = None
    if ctx_proj is not None:
        dcp = ctx_res.to(cdt).float().reshape(-1, ctx_res.shape[-1]).t() @ flat
    dwq, dv = attn.attention_weight_grads(hnew, dq, dv_rows, cdt)
    return dwh, dcp, dwq, dv


class AVAlignScan(torch.autograd.Function):
    """K8 with its gradient: (hs, ctxs, aligns, hT, cT, ctxT) from the cell
    (wh, b), ctx_proj (or None), the attention (wq, v; v None for Luong,
    ``attention_type`` a non-tensor argument), the input product xw and the
    video memory's keys and values (one tensor for a Luong memory without
    ``wv``: autograd adds its dkeys and dvalues).  The alignments feed no
    loss: they are marked non-differentiable, and a gradient arriving for
    them raises.  The masks and the memory bias take no gradient."""

    @staticmethod
    def forward(ctx, attention_type, wh, b, ctx_proj, wq, v, xw, mask, keys, values, mbias,
                mmask, cdt):
        cell, att = {"wh": wh, "b": b}, {"wq": wq, "v": v}
        mem = attn.AttentionMemory(values=values, keys=keys, mask=mmask, bias=mbias)
        out, res = av_align_scan_fwd(cell, att, ctx_proj, xw, mask, mem, cdt, save=True,
                                     attention_type=attention_type)
        ctx.save_for_backward(wh, b, ctx_proj, wq, v, xw, mask, keys, values, mbias, mmask,
                              out[2], *res)
        ctx.mark_non_differentiable(out[2])
        ctx.set_materialize_grads(False)
        ctx.cdt, ctx.attention_type = cdt, attention_type
        return out

    @staticmethod
    def backward(ctx, dhs, dctxs, daligns, dhT, dcT, dctxT):
        if daligns is not None:
            raise RuntimeError("the AV-Align alignments take no gradient")
        wh, b, ctx_proj, wq, v, xw, mask, keys, values, mbias, mmask, aligns, *res = \
            ctx.saved_tensors
        cdt = ctx.cdt
        cell, att = {"wh": wh, "b": b}, {"wq": wq, "v": v}
        mem = attn.AttentionMemory(values=values, keys=keys, mask=mmask, bias=mbias)
        T, B, H4 = xw.shape
        H, Dv = H4 // 4, values.shape[-1]

        def z(x, *shape):
            return torch.zeros(shape, dtype=torch.float32, device=xw.device) if x is None else x

        dxw, db, dq, dv_rows, dkeys, dvalues, hnew = av_align_scan_bwd(
            cell, att, ctx_proj, xw, mask, mem, aligns, res, z(dhs, T, B, H),
            z(dctxs, T, B, Dv), z(dhT, B, H), z(dcT, B, H), z(dctxT, B, Dv), cdt,
            attention_type=ctx.attention_type)
        dwh, dcp, dwq, dv = av_align_weight_grads(res, ctx_proj, dxw, dq, dv_rows, hnew, cdt)
        return (None, dwh.to(wh.dtype), db.to(b.dtype),
                None if dcp is None else dcp.to(ctx_proj.dtype), dwq.to(wq.dtype),
                None if dv is None else dv.to(v.dtype), dxw.to(xw.dtype), None,
                dkeys.to(keys.dtype), dvalues.to(values.dtype), None, None, None)


def av_align_scan(cell: Params, att: Params, ctx_proj: Optional[torch.Tensor],
                  xw: torch.Tensor, mask: torch.Tensor, mem: attn.AttentionMemory,
                  cdt: torch.dtype, *, attention_type: str = "bahdanau"):
    """K8 as the fusion calls it: (hs, ctxs, aligns, (hT, cT, ctxT)).  With
    autograd recording and an input that needs a gradient it goes through
    ``AVAlignScan``; otherwise (serving) straight to the forward wrapper,
    saving nothing."""
    v = att.get("v")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (cell["wh"], cell["b"], ctx_proj, att["wq"], v, xw, mem.keys,
                      mem.values)):
        hs, ctxs, aligns, hT, cT, ctxT = AVAlignScan.apply(
            attention_type, cell["wh"], cell["b"], ctx_proj, att["wq"], v, xw, mask, mem.keys,
            mem.values, mem.bias, mem.mask, cdt)
    else:
        (hs, ctxs, aligns, hT, cT, ctxT), _ = av_align_scan_fwd(
            cell, att, ctx_proj, xw, mask, mem, cdt, attention_type=attention_type)
    return hs, ctxs, aligns, (hT, cT, ctxT)


def av_align_apply(params: Params, cfg: FusionConfig, audio_tbd: torch.Tensor,
                   audio_lengths: torch.Tensor, video_memory: torch.Tensor,
                   video_lengths: torch.Tensor, cdt: torch.dtype) -> FusionOutput:
    """audio_tbd [T_a, B, D] time-major (the lower audio layers' output),
    video_memory [B, T_v, H_v] -> fused [T_a, B, H + Dv], alignments
    [T_a, B, T_v] and the AU predictions."""
    T_a = audio_tbd.shape[0]
    mem = attn.prepare_memory(cfg.attention_type, params["att"], video_memory, video_lengths,
                              cdt)
    xw = dot_f32(audio_tbd, params["cell"]["wx"], cdt)  # hoisted, fp32 [T_a, B, 4H]
    mask = (torch.arange(T_a, device=audio_tbd.device)[:, None]
            < audio_lengths[None, :]).float()
    hs, ctxs, aligns, _ = av_align_scan(params["cell"], params["att"], params.get("ctx_proj"),
                                        xw, mask, mem, cdt, attention_type=cfg.attention_type)
    fused = torch.cat([hs, ctxs], dim=-1)
    au_pred = None
    if "au_w" in params:
        au_pred = (dot_f32(ctxs, params["au_w"], cdt) + params["au_b"]) * mask[:, :, None]
    return FusionOutput(fused=fused, alignments=aligns, au_predictions=au_pred)


def cross_attention_fusion_init(gen: torch.Generator, cfg: FusionConfig, audio_dim: int,
                                video_dim: int, device) -> Params:
    ctx_dim = cfg.memory_value_dim or video_dim
    if ctx_dim % cfg.num_heads != 0:
        raise ValueError(
            f"fusion context dim {ctx_dim} not divisible by num_heads {cfg.num_heads}")
    qk = cfg.attention_units * cfg.num_heads
    params: Params = {
        "wq": glorot_uniform(gen, (audio_dim, qk), device),
        "wk": glorot_uniform(gen, (video_dim, qk), device),
        "wv": glorot_uniform(gen, (video_dim, ctx_dim), device),
        "wo": glorot_uniform(gen, (ctx_dim, ctx_dim), device),
    }
    if cfg.au_loss_weight > 0.0:
        params["au_w"] = glorot_uniform(gen, (ctx_dim, cfg.au_dim), device)
        params["au_b"] = zeros((cfg.au_dim,), device)
    return params


def _fusion_scores(q, k, video_lengths):
    """fp32 [B,nh,T_a,T_v] scores: float(q.k in the compute dtype) /
    sqrt(A) + (1 - valid_key) * -1e9."""
    T_v, A = k.shape[1], k.shape[-1]
    scores = torch.einsum("bqha,bkha->bhqk", q, k).float() / math.sqrt(A)
    key_valid = (torch.arange(T_v, device=q.device)[None, :] < video_lengths[:, None]).float()
    return scores + (1.0 - key_valid)[:, None, None, :] * -1e9


def fusion_attention_weights(q, k, video_lengths, row_max, row_sum):
    """The fp32 weights [B,nh,T_a,T_v] from the operands and the softmax's
    saved row statistics [B,nh,T_a]: exp(s - row_max) / row_sum, the
    forward's own expression, so the same bits as the forward's weights."""
    s = _fusion_scores(q, k, video_lengths)
    return torch.exp(s - row_max[..., None]) / row_sum[..., None]


def fusion_attention_fwd_plain(q, k, v, video_lengths, *, save: bool = False):
    """Plain-PyTorch K4 forward.  q [B,T_a,nh,A], k [B,T_v,nh,A],
    v [B,T_v,nh,dv] in the compute dtype, video_lengths [B] -> (ctx
    [B,T_a,nh,dv] in the compute dtype, weights [B,nh,T_a,T_v] fp32, the
    softmax's row statistics (row_max, row_sum), fp32 [B,nh,T_a] each, when
    ``save``, else None).  The softmax written out as the kernel takes it:
    the row max, exp(s - max), the row sum, a division."""
    s = _fusion_scores(q, k, video_lengths)
    row_max = s.amax(dim=-1)
    e = torch.exp(s - row_max[..., None])
    row_sum = e.sum(dim=-1)
    w = e / row_sum[..., None]
    ctx = torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype), v)
    return ctx, w, ((row_max, row_sum) if save else None)


def attention_bwd_from_weights(q, k, v, weights, dctx):
    """The softmax-attention backward from the fp32 weights: the gradient
    JAX's autodiff takes through the reference cores, with their rounding
    points (the P.V and dctx.V^T products return the compute dtype; the
    scores' cotangent is rounded to it before the q/k products).  -> (dq,
    dk, dv) in q/k/v's dtypes."""
    cdt = q.dtype
    A = q.shape[-1]
    dv = torch.einsum("bhqk,bqhd->bkhd", weights.to(cdt), dctx.to(cdt))
    dw = torch.einsum("bqhd,bkhd->bhqk", dctx.to(cdt), v).float()
    ds = weights * (dw - (dw * weights).sum(dim=-1, keepdim=True))
    dsc = (ds / math.sqrt(A)).to(cdt)
    dq = torch.einsum("bhqk,bkha->bqha", dsc, k)
    dk = torch.einsum("bhqk,bqha->bkha", dsc, q)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fusion_attention_bwd_plain(q, k, v, video_lengths, row_max, row_sum, dctx):
    """Plain-PyTorch K4 backward: the forward's q, k, v, video lengths and
    row statistics, and the context cotangent -> (dq, dk, dv).  The weights
    are recomputed from the statistics, then ``attention_bwd_from_weights``."""
    w = fusion_attention_weights(q, k, video_lengths, row_max, row_sum)
    return attention_bwd_from_weights(q, k, v, w, dctx)


def fusion_attention_fwd(q, k, v, video_lengths, *, save: bool = False):
    """K4 forward wrapper: the CUDA kernels for GPU tensors, the plain
    version on the CPU; same contract as ``fusion_attention_fwd_plain``,
    but for the residual of the CUDA-core route (head widths with no
    tensor-core instance, ``kernels.attention_family``): the weights, a
    one-tuple, in place of the row statistics."""
    if q.device.type == "cpu":
        return fusion_attention_fwd_plain(q, k, v, video_lengths, save=save)
    check_policy(q.dtype, "K4")
    return kernels.fusion_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                        video_lengths.to(torch.int32).contiguous(), save=save)


def fusion_attention_bwd(q, k, v, video_lengths, row_max, row_sum, dctx):
    """K4 backward wrapper: the tensor-core kernels for GPU tensors, the
    plain version on the CPU; same contract as ``fusion_attention_bwd_plain``."""
    if q.device.type == "cpu":
        return fusion_attention_bwd_plain(q, k, v, video_lengths, row_max, row_sum, dctx)
    check_policy(q.dtype, "K4")
    return kernels.fusion_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                        video_lengths.to(torch.int32).contiguous(),
                                        row_max.contiguous(), row_sum.contiguous(),
                                        dctx.to(q.dtype).contiguous())


def core_route_bwd(kernel, q, k, v, weights, dctx):
    """The backward of K4 (``kernel`` "fusion_attention") or K5
    ("decoder_attention") from the fp32 weights, the residual of the
    CUDA-core route (head widths with no tensor-core instance): its kernels
    for GPU tensors, ``attention_bwd_from_weights`` on the CPU."""
    if q.device.type == "cpu":
        return attention_bwd_from_weights(q, k, v, weights, dctx)
    check_policy(q.dtype, "K4" if kernel == "fusion_attention" else "K5")
    return kernels.attention_bwd_core(kernel, q.contiguous(), k.contiguous(), v.contiguous(),
                                      weights.contiguous(), dctx.to(q.dtype).contiguous())


class FusionAttention(torch.autograd.Function):
    """K4 with its gradient: (ctx, weights) from q, k, v and the video
    lengths.  The forward saves the operands, the lengths and the softmax's
    row statistics ([B, nh, T_a] each), not the weights; the backward
    recomputes them (the CUDA-core route, at widths with no tensor-core
    instance, saves the weights).  The weights only feed the alignments,
    which no loss reads: they are marked non-differentiable, and a gradient
    arriving for them raises."""

    @staticmethod
    def forward(ctx, q, k, v, video_lengths):
        out, w, res = fusion_attention_fwd(q, k, v, video_lengths, save=True)
        ctx.save_for_backward(q, k, v, video_lengths, *res)
        ctx.mark_non_differentiable(w)
        ctx.set_materialize_grads(False)
        return out, w

    @staticmethod
    def backward(ctx, dctx, dw):
        if dw is not None:
            raise RuntimeError("the fusion attention weights take no gradient")
        if dctx is None:
            return None, None, None, None
        q, k, v, video_lengths, *res = ctx.saved_tensors
        if len(res) == 1:
            dq, dk, dv = core_route_bwd("fusion_attention", q, k, v, *res, dctx)
        else:
            dq, dk, dv = fusion_attention_bwd(q, k, v, video_lengths, *res, dctx)
        return dq, dk, dv, None


def fusion_attention(q, k, v, video_lengths):
    """K4 as the fusion calls it -> (ctx, weights): through
    ``FusionAttention`` when autograd records a gradient for q, k or v, else
    straight to the forward wrapper, saving nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FusionAttention.apply(q, k, v, video_lengths)
    return fusion_attention_fwd(q, k, v, video_lengths)[:2]


def cross_attention_fusion_apply(params: Params, cfg: FusionConfig, audio_tbd: torch.Tensor,
                                 audio_lengths: torch.Tensor, video_memory: torch.Tensor,
                                 video_lengths: torch.Tensor, cdt: torch.dtype) -> FusionOutput:
    """audio_tbd [T_a, B, D_a] time-major, video_memory [B, T_v, D_v]."""
    T_a, B, _ = audio_tbd.shape
    T_v = video_memory.shape[1]
    nh, A = cfg.num_heads, cfg.attention_units
    ctx_dim = params["wv"].shape[-1]
    dv = ctx_dim // nh
    dev = audio_tbd.device

    a_bm = audio_tbd.transpose(0, 1).to(cdt)
    vm = video_memory.to(cdt)
    q = (a_bm @ params["wq"].to(cdt)).reshape(B, T_a, nh, A)
    k = (vm @ params["wk"].to(cdt)).reshape(B, T_v, nh, A)
    v = (vm @ params["wv"].to(cdt)).reshape(B, T_v, nh, dv)
    ctx, w = fusion_attention(q, k, v, video_lengths)  # w [B, nh, T_a, T_v] fp32
    ctx = (ctx.reshape(B, T_a, ctx_dim) @ params["wo"].to(cdt)).float()

    a_mask = (torch.arange(T_a, device=dev)[:, None] < audio_lengths[None, :]).float()
    ctx_tm = ctx.transpose(0, 1) * a_mask[:, :, None]
    fused = torch.cat([audio_tbd * a_mask[:, :, None], ctx_tm], dim=-1)
    aligns = w.mean(dim=1).transpose(0, 1) * a_mask[:, :, None]

    au_pred = None
    if "au_w" in params:
        au = dot_f32(ctx_tm, params["au_w"], cdt) + params["au_b"]
        au_pred = au * a_mask[:, :, None]
    return FusionOutput(fused=fused, alignments=aligns, au_predictions=au_pred)


def au_regression_loss(au_pred: torch.Tensor, au_target: torch.Tensor,
                       audio_lengths: torch.Tensor,
                       row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked MSE between predicted and target action units (reference
    ``au_regression_loss``): [T_a, B, au_dim] each; ``row_weights`` [B]
    drops rows with no real AU stream."""
    T_a = au_pred.shape[0]
    mask = (torch.arange(T_a, device=au_pred.device)[:, None]
            < audio_lengths[None, :]).float()
    if row_weights is not None:
        mask = mask * row_weights[None, :].float()
    sq = (au_pred - au_target).square().sum(dim=-1)
    return (sq * mask).sum() / torch.clamp(mask.sum(), min=1.0)
