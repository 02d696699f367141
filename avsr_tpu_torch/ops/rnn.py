"""Fused-gate LSTM and GRU cells and scans (counterpart of ``avsr_tpu/ops/rnn.py``).

``lstm_step`` is one plain LSTM step (the RNN decoder's cells, the plain
twin of the AV-Align fusion scan).

The reference hoists the input projection ``x @ Wx`` for all timesteps out
of the scan (one large matmul, stored in the compute dtype) and runs both
BiLSTM directions in ONE scan over a direction-batched recurrent product,
with the backward direction's stream and mask flipped in time.  Padded
steps carry (h, c) through unchanged and emit zeros.

The recurrence itself — ``_bilstm_scan_core`` in the reference, its
hand-derived custom-VJP core — is kernel K1 here, forward and backward.
``BiLSTMScanCore`` is the ``torch.autograd.Function`` around it: its
forward saves the bf16 carries entering each step (only when a gradient
is wanted) and its backward is the reference's reverse scan with gate
recompute.  ``scan_core_fwd`` / ``scan_core_bwd`` launch the CUDA kernels
(``csrc/lstm_scan.cu``) for tensors on a GPU and run the plain versions
(``bilstm_scan_core_fwd_impl`` / ``bilstm_scan_core_bwd_plain``) for
tensors on the CPU, so the CPU tests run the hand-written backward's twin
rather than torch's autodiff of the forward.

A unidirectional layer (``lstm_scan`` / ``rnn_scan``) is the reference's
``_lstm_scan_core``, kernel K2: the same core at G = 1, with a given
initial state, whose launches the kernel wrappers count apart from K1's.

Variational recurrent dropout (train mode; the reference takes its plain
``lax.scan`` there, ``rnn.py:535-547`` and ``:654-668``) runs on the same
core with a mask ``rd`` [G, B, H]: the recurrent product's operand is
bf16(h * rd), the carry h stays unmasked, the saved residual is that
operand, and the backward scales the operand's cotangent by ``rd``.

GRU cells (``cell_type="gru"``, gate order r, z, n, no recurrent bias) run
on kernel K12 (``csrc/gru_scan.cu``), forward and backward, behind
``GRUScanCore``; a bidirectional GRU layer is one direction-batched scan at
G = 2 (the reference runs two scans, the same function).  Its backward
recomputes the gates from the saved bf16 carries and mirrors the rounding
points of JAX's autodiff of ``gru_step`` (the operand's and the input
product's cotangents rounded to the compute dtype).

LN-LSTM cells (``layer_norm=True``, the reference's
``LayerNormBasicLSTMCell``-style cell) run on kernel K13
(``csrc/ln_lstm_scan.cu``), forward and backward, behind
``LNLSTMScanCore``: each step's pre-activations ``z = xw + bf16(h) @
bf16(Wh)`` are normalised per gate block over its H units (population
variance, eps 1e-5), scaled by ``ln_gamma`` and only then biased by ``b``
(no beta on the gates); the cell's new state is normalised with
``ln_cell_gamma`` / ``ln_cell_beta`` for the output, ``h = sigmoid(o) *
tanh(LN(c_new))``, while the carry keeps the un-normalised ``c_new``.  A
bidirectional LN layer is one direction-batched scan at G = 2 (the
reference runs two scans of the same function).  The backward is the
reverse scan of JAX's autodiff of that body with its rounding points (the
operand's cotangent rounded to the compute dtype); the recurrent product's
cotangent is the pre-LN gate cotangent ``dz``, so dWh is the caller's
``h_res^T dxw`` product as for K1.  ``lstm_step`` with LN stays plain: no
decoder cell uses it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avsr_tpu_torch import kernels
from avsr_tpu_torch.utils.numerics import check_policy, dot_f32, rounded
from avsr_tpu_torch.utils.params import Params, glorot_uniform, orthogonal

LN_EPS = 1e-5  # the reference's LayerNorm epsilon (``_gate_layer_norm``, the cell LN)


def lstm_init(gen: torch.Generator, input_dim: int, hidden: int, device, *,
              layer_norm: bool = False) -> Params:
    """``wx [D,4H]`` Glorot, ``wh [H,4H]`` block-orthogonal, ``b [4H]``
    zeros with forget-gate bias 1 (gate order i, f, g, o); with
    ``layer_norm`` also ``ln_gamma [4H]`` and ``ln_cell_gamma [H]`` ones and
    ``ln_cell_beta [H]`` zeros, all fp32."""
    b = torch.zeros(4 * hidden, dtype=torch.float32)
    b[hidden:2 * hidden] = 1.0
    params = {
        "wx": glorot_uniform(gen, (input_dim, 4 * hidden), device),
        "wh": orthogonal(gen, (hidden, 4 * hidden), device),
        "b": b.to(device),
    }
    if layer_norm:
        params["ln_gamma"] = torch.ones(4 * hidden, dtype=torch.float32, device=device)
        params["ln_cell_gamma"] = torch.ones(hidden, dtype=torch.float32, device=device)
        params["ln_cell_beta"] = torch.zeros(hidden, dtype=torch.float32, device=device)
    return params


def gru_init(gen: torch.Generator, input_dim: int, hidden: int, device) -> Params:
    """``wx [D,3H]`` Glorot, ``wh [H,3H]`` block-orthogonal, ``b [3H]``
    zeros (gate order r, z, n)."""
    return {
        "wx": glorot_uniform(gen, (input_dim, 3 * hidden), device),
        "wh": orthogonal(gen, (hidden, 3 * hidden), device),
        "b": torch.zeros(3 * hidden, dtype=torch.float32, device=device),
    }


def cell_init(cell_type: str, gen: torch.Generator, input_dim: int, hidden: int, device, *,
              layer_norm: bool = False) -> Params:
    """LSTM cells with the LN leaves where ``layer_norm``; GRU cells ignore
    it, as the reference's do."""
    if cell_type == "lstm":
        return lstm_init(gen, input_dim, hidden, device, layer_norm=layer_norm)
    if cell_type == "gru":
        return gru_init(gen, input_dim, hidden, device)
    raise ValueError(f"unknown cell type {cell_type}")


def _normalize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_hat, rstd): x_hat = (x - mean) * rstd, rstd = rsqrt(var + eps) over
    the last axis, with the population variance ``jnp.var`` takes
    (``correction=0``)."""
    rstd = torch.rsqrt(x.var(dim=-1, keepdim=True, correction=0) + LN_EPS)
    return (x - x.mean(dim=-1, keepdim=True)) * rstd, rstd


def _layer_norm_last(x: torch.Tensor) -> torch.Tensor:
    return _normalize(x)[0]


def _gate_layer_norm(z: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Each of the 4 gate blocks of ``z [..., 4H]`` normalised over its H
    units, then scaled by ``gamma [4H]`` (the reference's
    ``_gate_layer_norm``; no beta)."""
    g = _layer_norm_last(z.reshape(*z.shape[:-1], 4, z.shape[-1] // 4))
    return g.reshape(z.shape) * gamma


def lstm_step(params: Params, x_or_xw: torch.Tensor,
              state: Tuple[torch.Tensor, torch.Tensor], cdt: torch.dtype, *,
              preprojected: bool = False):
    """One fused LSTM step (the reference's ``lstm_step``, plain cells, or
    LN cells where the params hold ``ln_gamma``).

    ``x_or_xw`` is the input [B, D_in], or the fp32 input product [B, 4H]
    when ``preprojected``; state (h, c) fp32 [B, H].  Gates are
    ``LN(xw + bf16(h) @ bf16(Wh)) + b`` (no LN for plain cells) with fp32
    products -> ((h', c'), h'); an LN cell's output reads ``LN(c')``.
    """
    h, c = state
    xw = x_or_xw if preprojected else dot_f32(x_or_xw, params["wx"], cdt)
    gates = xw + dot_f32(h, params["wh"], cdt)
    if "ln_gamma" in params:
        gates = _gate_layer_norm(gates, params["ln_gamma"])
    gates = gates + params["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    c_out = c_new
    if "ln_cell_gamma" in params:
        c_out = _layer_norm_last(c_new) * params["ln_cell_gamma"] + params["ln_cell_beta"]
    h_new = torch.sigmoid(o) * torch.tanh(c_out)
    return (h_new, c_new), h_new


def gru_step(params: Params, x_or_xw: torch.Tensor, h: torch.Tensor, cdt: torch.dtype, *,
             preprojected: bool = False):
    """One fused GRU step (the reference's ``gru_step``; gate order r, z,
    n).  ``x_or_xw`` is the input [B, D_in], or the input product [B, 3H]
    when ``preprojected``; state h fp32 [B, H] -> (h', h')."""
    xw = x_or_xw if preprojected else dot_f32(x_or_xw, params["wx"], cdt)
    hw = dot_f32(h, params["wh"], cdt)
    xr, xz, xn = (xw + params["b"]).chunk(3, dim=-1)
    hr, hz, hn = hw.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    h_new = (1.0 - z) * n + z * h
    return h_new, h_new


def project_inputs(params: Params, x_tbd: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Hoisted input projection ``[T,B,D] @ [D,GH]`` (4H LSTM, 3H GRU),
    stored in ``cdt`` (fp32 accumulation; the reference's
    ``_project_inputs``)."""
    return x_tbd.to(cdt) @ params["wx"].to(cdt)


def bilstm_scan_core_fwd_impl(wh, b, xw, mask, h0, c0, cdt, save, rd=None):
    """Plain-PyTorch K1 forward: the reference's ``_bilstm_scan_core_fwd_impl``
    and, with a recurrent-dropout mask ``rd`` [G,B,H], the body of its plain
    scan with ``recurrent_dropout_masks`` (``rnn.py:650-668``).

    wh [G,H,4H], b [G,4H], xw [T,G,B,4H] (any float dtype), mask [T,G,B]
    fp32, h0/c0 [G,B,H] fp32 -> ((ys [T,G,B,H] in ``cdt``, hT, cT fp32),
    res), where res is (h_res, c_res) [T,G,B,H] in ``cdt`` when ``save``,
    else None: each step's recurrent operand (h, or h * rd) and the carry c
    entering it.
    """
    wh_c = wh.to(cdt).float()  # compute-dtype operands, fp32 products
    b_e = b[:, None, :]
    h, c = h0, c0
    ys, h_res, c_res = [], [], []
    for t in range(xw.shape[0]):
        hp = (h if rd is None else h * rd).to(cdt)
        if save:
            h_res.append(hp)
            c_res.append(c.to(cdt))
        gates = xw[t].float() + torch.bmm(hp.float(), wh_c) + b_e
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t][..., None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ys.append((h_new * m).to(cdt))
    res = (torch.stack(h_res), torch.stack(c_res)) if save else None
    return (torch.stack(ys), h, c), res


def bilstm_scan_core_plain(wh, b, xw, mask, h0, c0, cdt, rd=None):
    """Plain-PyTorch K1 forward, outputs only: (ys, hT, cT)."""
    out, _ = bilstm_scan_core_fwd_impl(wh, b, xw, mask, h0, c0, cdt, save=False, rd=rd)
    return out


def bilstm_scan_core_bwd_plain(wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, cdt, rd=None):
    """Plain-PyTorch K1 backward: the reference's ``_bilstm_scan_core_bwd``
    (``avsr_tpu/ops/rnn.py:382-454``), line for line; with the forward's
    mask ``rd`` the cotangent of each step's recurrent operand (the dgates
    product) is scaled by it before the carried dh is added (the reference
    takes this gradient by autodiff of its plain scan).

    Returns (dwh, db, dxw, dh0, dc0): dwh/db in the parameters' dtypes, dxw
    in ``xw``'s (it is the ``cdt``-rounded dgates), dh0/dc0 fp32.
    """
    wh_c = wh.to(cdt).float()
    b_e = b[:, None, :].float()
    dh_out, dc_out = dhT.float(), dcT.float()
    db_acc = torch.zeros_like(b, dtype=torch.float32)
    dxw = [None] * xw.shape[0]
    for t in reversed(range(xw.shape[0])):
        c_prev = c_res[t].float()
        m = mask[t][..., None]
        gates = xw[t].float() + torch.bmm(h_res[t].float(), wh_c) + b_e
        gi, gf, gg, go = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
        g = torch.tanh(gg)
        c_new = f * c_prev + i * g
        tc = torch.tanh(c_new)

        dh_new = (dh_out + dys[t].float()) * m
        dh_prev_direct = dh_out * (1.0 - m)
        dc_new = dc_out * m
        dc_prev_direct = dc_out * (1.0 - m)

        do = dh_new * tc
        dc_new = dc_new + dh_new * o * (1.0 - tc * tc)
        df = dc_new * c_prev
        di = dc_new * g
        dg = dc_new * i
        dc_prev = dc_new * f + dc_prev_direct

        dgates = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                            dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dgates_c = dgates.to(cdt)
        dh_rec = torch.bmm(dgates_c.float(), wh_c.transpose(1, 2))
        dh_prev = (dh_rec if rd is None else dh_rec * rd) + dh_prev_direct
        db_acc = db_acc + dgates.sum(dim=1)
        dh_out, dc_out = dh_prev, dc_prev
        dxw[t] = dgates_c
    dxw = torch.stack(dxw)
    return (_dwh(h_res, dxw).to(wh.dtype), db_acc.to(b.dtype), dxw.to(xw.dtype),
            dh_out, dc_out)


def _dwh(h_res, dxw):
    """dWh = sum over steps and rows of h_res^T dxw, fp32 (the reference
    hoists this out of the scan as one einsum, ``rnn.py:445-447``)."""
    return torch.einsum("tgbh,tgbk->ghk", h_res.float(), dxw.float())


def _lstm_family(xw, rd) -> str:
    """The LSTM scan's kernel family for ``numerics.check_policy``: "K1",
    "K1 rd" (under a recurrent-dropout mask) or "K2" (one direction)."""
    return "K2" if xw.shape[1] == 1 else ("K1 rd" if rd is not None else "K1")


def _rd_arg(rd):
    return None if rd is None else rd.float().contiguous()


def scan_core_fwd(wh, b, xw, mask, h0, c0, cdt, save, rd=None):
    """K1 forward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``bilstm_scan_core_fwd_impl``.

    The kernels run the bf16 policy, and K1 without a mask the fp32 one too
    (its fp32 instance, operands and residuals in ``cdt``); any other
    family or dtype on a GPU raises rather than falling back.
    """
    if xw.device.type == "cpu":
        return bilstm_scan_core_fwd_impl(wh, b, xw, mask, h0, c0, cdt, save, rd)
    check_policy(cdt, _lstm_family(xw, rd))
    ys, hT, cT, h_res, c_res = kernels.lstm_scan_fwd(
        wh.to(cdt).contiguous(), b.float().contiguous(),
        xw.to(cdt).contiguous(), mask.float().contiguous(),
        h0.float().contiguous(), c0.float().contiguous(), save=save, rd=_rd_arg(rd),
    )
    return (ys, hT, cT), ((h_res, c_res) if save else None)


def scan_core_bwd(wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, cdt, rd=None):
    """K1 backward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``bilstm_scan_core_bwd_plain``."""
    if xw.device.type == "cpu":
        return bilstm_scan_core_bwd_plain(wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, cdt, rd)
    check_policy(cdt, _lstm_family(xw, rd))
    dxw, db, dh0, dc0 = kernels.lstm_scan_bwd(
        wh.to(cdt).contiguous(), b.float().contiguous(),
        xw.to(cdt).contiguous(), mask.float().contiguous(),
        h_res.contiguous(), c_res.contiguous(), dys.to(cdt).contiguous(),
        dhT.float().contiguous(), dcT.float().contiguous(), rd=_rd_arg(rd),
    )
    return _dwh(h_res, dxw).to(wh.dtype), db.to(b.dtype), dxw.to(xw.dtype), dh0, dc0


class BiLSTMScanCore(torch.autograd.Function):
    """K1 with its hand-written gradient (the reference's ``jax.custom_vjp``;
    under a recurrent-dropout mask ``rd``, the gradient its autodiff takes
    through the plain scan).

    The forward saves each step's recurrent operand and the carry c
    entering it, in ``cdt``, and only when an input asks for a gradient;
    the backward recomputes the gates from them.  ``mask`` and ``rd`` get
    no gradient (the reference returns zeros for the mask; the dropout
    mask is a constant draw).
    """

    @staticmethod
    def forward(ctx, wh, b, xw, mask, h0, c0, cdt, rd=None):
        save = any(ctx.needs_input_grad)
        (ys, hT, cT), res = scan_core_fwd(wh, b, xw, mask, h0, c0, cdt, save, rd)
        ctx.cdt = cdt
        if save:
            ctx.save_for_backward(wh, b, xw, mask, *res, rd)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        wh, b, xw, mask, h_res, c_res, rd = ctx.saved_tensors
        dwh, db, dxw, dh0, dc0 = scan_core_bwd(wh, b, xw, mask, h_res, c_res,
                                               dys, dhT, dcT, ctx.cdt, rd)
        return dwh, db, dxw, None, dh0, dc0, None, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def bilstm_scan_core(wh, b, xw, mask, h0, c0, cdt, rd=None):
    """K1 as the encoders call it: (ys, hT, cT).  With autograd recording
    and an input that needs a gradient it goes through ``BiLSTMScanCore``;
    otherwise (serving) straight to the forward wrapper, saving nothing.
    ``rd`` [G,B,H] is the recurrent-dropout mask (train mode), or None."""
    if _wants_grad(wh, b, xw, h0, c0):
        return BiLSTMScanCore.apply(wh, b, xw, mask, h0, c0, cdt, rd)
    out, _ = scan_core_fwd(wh, b, xw, mask, h0, c0, cdt, False, rd)
    return out


# ---------------------------------------------------------------------------
# K12: the GRU recurrence
# ---------------------------------------------------------------------------


def gru_scan_core_fwd_plain(wh, b, xw, mask, h0, cdt, save):
    """Plain-PyTorch K12 forward: the reference's ``gru_scan`` body
    (``rnn.py:576-583`` over ``gru_step``) direction-batched.

    wh [G,H,3H], b [G,3H], xw [T,G,B,3H] (any float dtype), mask [T,G,B]
    fp32, h0 [G,B,H] fp32 -> ((ys [T,G,B,H] in ``cdt``, hT fp32), h_res),
    h_res the ``cdt`` carries entering each step [T,G,B,H] (the recurrent
    product's operand) when ``save``, else None.
    """
    wh_c = wh.to(cdt).float()
    b_e = b[:, None, :].float()
    h = h0
    ys, h_res = [], []
    for t in range(xw.shape[0]):
        hb = h.to(cdt)
        if save:
            h_res.append(hb)
        xr, xz, xn = (xw[t].float() + b_e).chunk(3, dim=-1)
        hr, hz, hn = torch.bmm(hb.float(), wh_c).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        m = mask[t][..., None]
        h = m * h_new + (1.0 - m) * h
        ys.append((h_new * m).to(cdt))
    return (torch.stack(ys), h), (torch.stack(h_res) if save else None)


def gru_scan_core_bwd_plain(wh, b, xw, mask, h_res, dys, dhT, cdt):
    """Plain-PyTorch K12 backward: the reverse scan of JAX's autodiff of the
    GRU body, with its rounding points (the cotangent of the operand
    ``h.astype(cdt)`` and of the ``cdt`` input product rounded to ``cdt``);
    the gates are recomputed from the saved ``cdt`` carries ``h_res``, which
    also stand in for h in the update's gradient.

    Returns (dwh, db, dxw, dh0): dwh = h_res^T dhw over all steps, where
    dhw, the recurrent product's cotangent, has dn * r in its n block (not
    dn, as dxw has); dwh/db in the parameters' dtypes, dxw in ``xw``'s, dh0
    fp32.
    """
    wh_c = wh.to(cdt).float()
    whT_c = wh_c.transpose(1, 2)
    b_e = b[:, None, :].float()
    d = dhT.float()
    db = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    T = xw.shape[0]
    dxw, dhw = [None] * T, [None] * T
    for t in reversed(range(T)):
        h = h_res[t].float()
        xr, xz, xn = (xw[t].float() + b_e).chunk(3, dim=-1)
        hr, hz, hn = torch.bmm(h, wh_c).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        m = mask[t][..., None]
        dh_new = (d + dys[t].float()) * m
        dh_dir = d * (1.0 - m) + dh_new * z
        dn = dh_new * (1.0 - z) * (1.0 - n * n)
        dz = dh_new * (h - n) * z * (1.0 - z)
        dr = dn * hn * r * (1.0 - r)
        dx = torch.cat([dr, dz, dn], dim=-1)
        dhw[t] = torch.cat([dr, dz, dn * r], dim=-1)
        db = db + dx.sum(dim=1)
        dxw[t] = dx.to(cdt)
        d = rounded(torch.bmm(dhw[t], whT_c), cdt) + dh_dir
    dwh = _dwh(h_res, torch.stack(dhw))
    return dwh.to(wh.dtype), db.to(b.dtype), torch.stack(dxw).to(xw.dtype), d


def gru_core_fwd(wh, b, xw, mask, h0, cdt, save):
    """K12 forward wrapper: the CUDA kernel for GPU tensors (bf16 policy
    only), the plain version on the CPU; same contract as
    ``gru_scan_core_fwd_plain``."""
    if xw.device.type == "cpu":
        return gru_scan_core_fwd_plain(wh, b, xw, mask, h0, cdt, save)
    check_policy(cdt, "K12")
    ys, hT, h_res = kernels.gru_scan_fwd(
        wh.to(torch.bfloat16).contiguous(), b.float().contiguous(),
        xw.to(torch.bfloat16).contiguous(), mask.float().contiguous(),
        h0.float().contiguous(), save=save)
    return (ys, hT), h_res


def gru_core_bwd(wh, b, xw, mask, h_res, dys, dhT, cdt):
    """K12 backward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``gru_scan_core_bwd_plain``."""
    if xw.device.type == "cpu":
        return gru_scan_core_bwd_plain(wh, b, xw, mask, h_res, dys, dhT, cdt)
    check_policy(cdt, "K12")
    dxw, db, dh0, dhw = kernels.gru_scan_bwd(
        wh.to(torch.bfloat16).contiguous(), b.float().contiguous(),
        xw.to(torch.bfloat16).contiguous(), mask.float().contiguous(), h_res.contiguous(),
        dys.to(torch.bfloat16).contiguous(), dhT.float().contiguous())
    return _dwh(h_res, dhw).to(wh.dtype), db.to(b.dtype), dxw.to(xw.dtype), dh0


class GRUScanCore(torch.autograd.Function):
    """K12 with its hand-written gradient: the forward saves the ``cdt``
    carries entering each step, only when an input asks for a gradient;
    the backward recomputes the gates from them.  ``mask`` gets no
    gradient."""

    @staticmethod
    def forward(ctx, wh, b, xw, mask, h0, cdt):
        save = any(ctx.needs_input_grad)
        (ys, hT), h_res = gru_core_fwd(wh, b, xw, mask, h0, cdt, save)
        ctx.cdt = cdt
        if save:
            ctx.save_for_backward(wh, b, xw, mask, h_res)
        return ys, hT

    @staticmethod
    def backward(ctx, dys, dhT):
        wh, b, xw, mask, h_res = ctx.saved_tensors
        dwh, db, dxw, dh0 = gru_core_bwd(wh, b, xw, mask, h_res, dys, dhT, ctx.cdt)
        return dwh, db, dxw, None, dh0, None


def gru_scan_core(wh, b, xw, mask, h0, cdt):
    """K12 as the encoders call it: (ys, hT); through ``GRUScanCore`` when
    autograd records and an input needs a gradient, else straight to the
    forward wrapper, saving nothing."""
    if _wants_grad(wh, b, xw, h0):
        return GRUScanCore.apply(wh, b, xw, mask, h0, cdt)
    out, _ = gru_core_fwd(wh, b, xw, mask, h0, cdt, False)
    return out


# ---------------------------------------------------------------------------
# K13: the LN-LSTM recurrence
# ---------------------------------------------------------------------------


def _ln_cell(z, b, lng, lncg, lncb, c):
    """An LN-LSTM step from its pre-activations ``z`` [G,B,4H] fp32 and the
    carry c: (gn [G,B,4,H] the normalised gate blocks and their rstd, (i, f,
    g, o), c_new, cn the normalised c_new and its rstd, tc = tanh(cn * lncg
    + lncb))."""
    G, B, H4 = z.shape
    gn, g_rstd = _normalize(z.reshape(G, B, 4, H4 // 4))
    pre = gn.reshape(G, B, H4) * lng[:, None, :] + b[:, None, :]
    gi, gf, gg, go = pre.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
    g = torch.tanh(gg)
    c_new = f * c + i * g
    cn, c_rstd = _normalize(c_new)
    tc = torch.tanh(cn * lncg[:, None, :] + lncb[:, None, :])
    return (gn, g_rstd), (i, f, g, o), (cn, c_rstd), c_new, tc


def ln_lstm_scan_core_fwd_plain(wh, b, lng, lncg, lncb, xw, mask, h0, c0, cdt, save, rd=None):
    """Plain-PyTorch K13 forward: the reference's plain ``lax.scan`` over
    ``lstm_step`` with LN cells (``rnn.py:535-553``; with ``rd`` its
    recurrent-dropout branch), direction-batched.

    wh [G,H,4H], b / lng [G,4H], lncg / lncb [G,H], xw [T,G,B,4H] (any float
    dtype), mask [T,G,B] fp32, h0 / c0 [G,B,H] fp32, ``rd`` [G,B,H] or None
    -> ((ys [T,G,B,H] in ``cdt``, hT, cT fp32), res), res = (h_res [T,G,B,H]
    in ``cdt``: each step's recurrent operand bf16(h * rd); c_res [T,G,B,H]
    fp32: the carry c entering it; z [T,G,B,4H] fp32: its pre-LN gates) when
    ``save``, else None.
    """
    wh_c = wh.to(cdt).float()
    lng, lncg, lncb, b = lng.float(), lncg.float(), lncb.float(), b.float()
    h, c = h0, c0
    ys, h_res, c_res, zs = [], [], [], []
    for t in range(xw.shape[0]):
        hp = (h if rd is None else h * rd).to(cdt)
        z = xw[t].float() + torch.bmm(hp.float(), wh_c)
        if save:
            h_res.append(hp)
            c_res.append(c)
            zs.append(z)
        _, (_, _, _, o), _, c_new, tc = _ln_cell(z, b, lng, lncg, lncb, c)
        h_new = o * tc
        m = mask[t][..., None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        ys.append((h_new * m).to(cdt))
    res = (torch.stack(h_res), torch.stack(c_res), torch.stack(zs)) if save else None
    return (torch.stack(ys), h, c), res


def _ln_backward(x_hat, rstd, dy):
    """The cotangent of x through y = (x - mean(x)) * rstd over the last axis
    (population variance): rstd * (dy - mean(dy) - x_hat * mean(dy * x_hat))."""
    return rstd * (dy - dy.mean(dim=-1, keepdim=True)
                   - x_hat * (dy * x_hat).mean(dim=-1, keepdim=True))


def ln_lstm_scan_core_bwd_plain(wh, b, lng, lncg, lncb, mask, h_res, c_res, z, dys, dhT, dcT,
                                cdt, rd=None):
    """Plain-PyTorch K13 backward: the reverse scan of JAX's autodiff of the
    LN-LSTM body, each step recomputed from its saved pre-LN gates ``z`` and
    carry ``c_res``; the cotangent of the recurrent operand bf16(h * rd) is
    rounded to ``cdt`` as the transpose of the cast rounds it, then scaled by
    ``rd``.  The recurrent product's cotangent is ``dz``, which is also the
    input product's (rounded to ``cdt``: dxw).

    Returns (dwh, db, dlng, dlncg, dlncb, dxw, dh0, dc0): dwh = h_res^T dxw
    over all steps (``_dwh``, as K1's); the parameter sums over (T, B) fp32 in
    the parameters' dtypes; dxw [T,G,B,4H] in ``cdt``; dh0 / dc0 fp32.
    """
    G, H = wh.shape[0], wh.shape[1]
    whT_c = wh.to(cdt).float().transpose(1, 2)
    lng_f, lncg_f, lncb_f, b_f = lng.float(), lncg.float(), lncb.float(), b.float()
    dh, dc = dhT.float(), dcT.float()
    db = torch.zeros((G, 4 * H), dtype=torch.float32, device=wh.device)
    dlng = torch.zeros_like(db)
    dlncg = torch.zeros((G, H), dtype=torch.float32, device=wh.device)
    dlncb = torch.zeros_like(dlncg)
    T = z.shape[0]
    dxw = [None] * T
    for t in reversed(range(T)):
        zt, cp = z[t].float(), c_res[t].float()
        B = zt.shape[1]
        (gn, g_rstd), (i, f, g, o), (cn, c_rstd), _, tc = _ln_cell(zt, b_f, lng_f, lncg_f,
                                                                    lncb_f, cp)
        m = mask[t][..., None]
        dh_new = (dh + dys[t].float()) * m
        dh_dir = dh * (1.0 - m)
        do = dh_new * tc
        dcfo = dh_new * o * (1.0 - tc * tc)
        dlncg = dlncg + (dcfo * cn).sum(dim=1)
        dlncb = dlncb + dcfo.sum(dim=1)
        dc_new = dc * m + _ln_backward(cn, c_rstd, dcfo * lncg_f[:, None, :])
        dc = dc_new * f + dc * (1.0 - m)
        dpre = torch.cat([dc_new * g * i * (1.0 - i), dc_new * cp * f * (1.0 - f),
                          dc_new * i * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        db = db + dpre.sum(dim=1)
        dlng = dlng + (dpre * gn.reshape(G, B, 4 * H)).sum(dim=1)
        dz = _ln_backward(gn, g_rstd, (dpre * lng_f[:, None, :]).reshape(G, B, 4, H))
        dz = dz.reshape(G, B, 4 * H)
        dxw[t] = dz.to(cdt)
        dh_rec = rounded(torch.bmm(dz, whT_c), cdt)
        dh = (dh_rec if rd is None else dh_rec * rd) + dh_dir
    dxw = torch.stack(dxw)
    return (_dwh(h_res, dxw).to(wh.dtype), db.to(b.dtype), dlng.to(lng.dtype),
            dlncg.to(lncg.dtype), dlncb.to(lncb.dtype), dxw, dh, dc)


def _ln_params(wh, b, lng, lncg, lncb):
    return (wh.to(torch.bfloat16).contiguous(), b.float().contiguous(),
            lng.float().contiguous(), lncg.float().contiguous(), lncb.float().contiguous())


def ln_core_fwd(wh, b, lng, lncg, lncb, xw, mask, h0, c0, cdt, save, rd=None):
    """K13 forward wrapper: the CUDA kernel for GPU tensors (bf16 policy
    only), the plain version on the CPU; same contract as
    ``ln_lstm_scan_core_fwd_plain``."""
    if xw.device.type == "cpu":
        return ln_lstm_scan_core_fwd_plain(wh, b, lng, lncg, lncb, xw, mask, h0, c0, cdt, save,
                                           rd)
    check_policy(cdt, "K13")
    ys, hT, cT, h_res, c_res, z = kernels.ln_lstm_scan_fwd(
        *_ln_params(wh, b, lng, lncg, lncb), xw.to(torch.bfloat16).contiguous(),
        mask.float().contiguous(), h0.float().contiguous(), c0.float().contiguous(),
        save=save, rd=_rd_arg(rd))
    return (ys, hT, cT), ((h_res, c_res, z) if save else None)


def ln_core_bwd(wh, b, lng, lncg, lncb, mask, h_res, c_res, z, dys, dhT, dcT, cdt, rd=None):
    """K13 backward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``ln_lstm_scan_core_bwd_plain``."""
    if z.device.type == "cpu":
        return ln_lstm_scan_core_bwd_plain(wh, b, lng, lncg, lncb, mask, h_res, c_res, z, dys,
                                           dhT, dcT, cdt, rd)
    check_policy(cdt, "K13")
    dxw, db, dlng, dlncg, dlncb, dh0, dc0 = kernels.ln_lstm_scan_bwd(
        *_ln_params(wh, b, lng, lncg, lncb), mask.float().contiguous(), c_res.contiguous(),
        z.contiguous(), dys.to(torch.bfloat16).contiguous(), dhT.float().contiguous(),
        dcT.float().contiguous(), rd=_rd_arg(rd))
    return (_dwh(h_res, dxw).to(wh.dtype), db.to(b.dtype), dlng.to(lng.dtype),
            dlncg.to(lncg.dtype), dlncb.to(lncb.dtype), dxw, dh0, dc0)


class LNLSTMScanCore(torch.autograd.Function):
    """K13 with its hand-written gradient: the forward saves each step's
    recurrent operand, the carry c entering it and its pre-LN gates, only
    when an input asks for a gradient; the backward recomputes the rest
    from them.  ``mask`` and ``rd`` get no gradient."""

    @staticmethod
    def forward(ctx, wh, b, lng, lncg, lncb, xw, mask, h0, c0, cdt, rd=None):
        save = any(ctx.needs_input_grad)
        (ys, hT, cT), res = ln_core_fwd(wh, b, lng, lncg, lncb, xw, mask, h0, c0, cdt, save, rd)
        ctx.cdt, ctx.xw_dtype = cdt, xw.dtype
        if save:
            ctx.save_for_backward(wh, b, lng, lncg, lncb, mask, *res, rd)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        wh, b, lng, lncg, lncb, mask, h_res, c_res, z, rd = ctx.saved_tensors
        dwh, db, dlng, dlncg, dlncb, dxw, dh0, dc0 = ln_core_bwd(
            wh, b, lng, lncg, lncb, mask, h_res, c_res, z, dys, dhT, dcT, ctx.cdt, rd)
        return (dwh, db, dlng, dlncg, dlncb, dxw.to(ctx.xw_dtype), None, dh0, dc0, None, None)


def ln_lstm_scan_core(wh, b, lng, lncg, lncb, xw, mask, h0, c0, cdt, rd=None):
    """K13 as the encoders call it: (ys, hT, cT); through ``LNLSTMScanCore``
    when autograd records and an input needs a gradient, else straight to
    the forward wrapper, saving nothing."""
    if _wants_grad(wh, b, lng, lncg, lncb, xw, h0, c0):
        return LNLSTMScanCore.apply(wh, b, lng, lncg, lncb, xw, mask, h0, c0, cdt, rd)
    out, _ = ln_core_fwd(wh, b, lng, lncg, lncb, xw, mask, h0, c0, cdt, False, rd)
    return out


LN_KEYS = ("ln_gamma", "ln_cell_gamma", "ln_cell_beta")


def _ln_stack(*params: Params):
    """The directions' LN leaves batched on G: (ln_gamma, ln_cell_gamma,
    ln_cell_beta)."""
    return tuple(torch.stack([p[k] for p in params]) for k in LN_KEYS)


def _fused_streams(params_fwd: Params, params_bwd: Params, x_tbd, mask_tb, cdt):
    """Both directions' operands batched on G = 2, the backward direction's
    input product and mask flipped in time: (xw [T,2,B,GH], mask [T,2,B],
    wh [2,H,GH], b [2,GH])."""
    T, B, _ = x_tbd.shape
    if mask_tb is None:
        mask_tb = torch.ones((T, B), dtype=torch.float32, device=x_tbd.device)
    mask_tb = mask_tb.float()
    xw_f = project_inputs(params_fwd, x_tbd, cdt)
    xw_b = project_inputs(params_bwd, x_tbd, cdt)
    xw = torch.stack([xw_f, torch.flip(xw_b, (0,))], dim=1)
    mask2 = torch.stack([mask_tb, torch.flip(mask_tb, (0,))], dim=1)
    wh2 = torch.stack([params_fwd["wh"], params_bwd["wh"]])
    b2 = torch.stack([params_fwd["b"], params_bwd["b"]])
    return xw, mask2, wh2, b2


def _unflip(ys: torch.Tensor) -> torch.Tensor:
    """[T, 2, B, H] direction-batched outputs -> concat(fwd, bwd) [T, B, 2H]."""
    return torch.cat([ys[:, 0], torch.flip(ys[:, 1], (0,))], dim=-1)


def fused_bilstm_scan(
    params_fwd: Params,
    params_bwd: Params,
    x_tbd: torch.Tensor,
    mask_tb: Optional[torch.Tensor],
    cdt: torch.dtype,
    recurrent_dropout_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple]:
    """Both BiLSTM directions in one scan (reference ``fused_bilstm_scan``).

    ``recurrent_dropout_masks`` (fwd, bwd) [B, H] each (train mode) scale
    the recurrent product's operand; the backward direction's mask is
    constant over time and is not flipped.  Returns (concat(fwd, bwd)
    outputs [T,B,2H] in ``cdt``, ((hT_f, cT_f), (hT_b, cT_b))).
    """
    B, H = x_tbd.shape[1], params_fwd["wh"].shape[0]
    xw, mask2, wh2, b2 = _fused_streams(params_fwd, params_bwd, x_tbd, mask_tb, cdt)
    h0 = torch.zeros((2, B, H), dtype=torch.float32, device=x_tbd.device)
    c0 = torch.zeros((2, B, H), dtype=torch.float32, device=x_tbd.device)
    rd = None if recurrent_dropout_masks is None else torch.stack(recurrent_dropout_masks)
    ys, hT, cT = bilstm_scan_core(wh2, b2, xw, mask2, h0, c0, cdt, rd)
    return _unflip(ys), ((hT[0], cT[0]), (hT[1], cT[1]))


def fused_bigru_scan(params_fwd: Params, params_bwd: Params, x_tbd: torch.Tensor,
                     mask_tb: Optional[torch.Tensor], cdt: torch.dtype):
    """Both GRU directions in one K12 scan at G = 2 (the reference's
    ``bidirectional_scan`` runs two ``gru_scan``s, the second reversed:
    the same function).  Returns (concat(fwd, bwd) outputs [T,B,2H] in
    ``cdt``, (hT_f, hT_b))."""
    B, H = x_tbd.shape[1], params_fwd["wh"].shape[0]
    xw, mask2, wh2, b2 = _fused_streams(params_fwd, params_bwd, x_tbd, mask_tb, cdt)
    h0 = torch.zeros((2, B, H), dtype=torch.float32, device=x_tbd.device)
    ys, hT = gru_scan_core(wh2, b2, xw, mask2, h0, cdt)
    return _unflip(ys), (hT[0], hT[1])


def fused_ln_lstm_scan(params_fwd: Params, params_bwd: Params, x_tbd: torch.Tensor,
                       mask_tb: Optional[torch.Tensor], cdt: torch.dtype,
                       recurrent_dropout_masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Both LN-LSTM directions in one K13 scan at G = 2 (the reference's
    ``bidirectional_scan`` runs two LN ``lstm_scan``s, the second reversed:
    the same function).  Returns (concat(fwd, bwd) outputs [T,B,2H] in
    ``cdt``, ((hT_f, cT_f), (hT_b, cT_b)))."""
    B, H = x_tbd.shape[1], params_fwd["wh"].shape[0]
    xw, mask2, wh2, b2 = _fused_streams(params_fwd, params_bwd, x_tbd, mask_tb, cdt)
    h0 = torch.zeros((2, B, H), dtype=torch.float32, device=x_tbd.device)
    rd = None if recurrent_dropout_masks is None else torch.stack(recurrent_dropout_masks)
    ys, hT, cT = ln_lstm_scan_core(wh2, b2, *_ln_stack(params_fwd, params_bwd), xw, mask2, h0,
                                   torch.zeros_like(h0), cdt, rd)
    return _unflip(ys), ((hT[0], cT[0]), (hT[1], cT[1]))


def _check_cell(cell_type: str) -> None:
    if cell_type not in ("lstm", "gru"):
        raise ValueError(f"unknown cell type {cell_type}")


def bidirectional_scan(cell_type: str, params_fwd: Params, params_bwd: Params,
                       x_tbd, mask_tb, cdt, recurrent_dropout_masks=None):
    """The reference's ``bidirectional_scan``: plain LSTM cells on the fused
    single scan (K1, with the recurrent-dropout masks where given), LN-LSTM
    cells on one direction-batched K13 scan (with the masks too), GRU cells
    on one direction-batched K12 scan.  GRU ignores the masks, as the
    reference does."""
    _check_cell(cell_type)
    if cell_type == "gru":
        return fused_bigru_scan(params_fwd, params_bwd, x_tbd, mask_tb, cdt)
    if "ln_gamma" in params_fwd:
        return fused_ln_lstm_scan(params_fwd, params_bwd, x_tbd, mask_tb, cdt,
                                  recurrent_dropout_masks)
    return fused_bilstm_scan(params_fwd, params_bwd, x_tbd, mask_tb, cdt,
                             recurrent_dropout_masks)


def lstm_scan(params: Params, x_tbd: torch.Tensor, mask_tb: Optional[torch.Tensor] = None,
              initial_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, *,
              reverse: bool = False, cdt: torch.dtype = torch.bfloat16,
              recurrent_dropout_mask: Optional[torch.Tensor] = None):
    """One LSTM direction over time (the reference's ``lstm_scan`` on its
    custom-VJP branch: plain cells, unroll 1, or with
    ``recurrent_dropout_mask`` [B, H] its plain scan).  The recurrence is
    kernel K2: K1's kernels at G = 1, counted apart (``kernels.LAUNCHES``
    ``lstm_scan_uni[_rd]_fwd`` / ``_bwd``), behind ``BiLSTMScanCore``; LN
    cells run K13 at G = 1 (``ln_lstm_scan_uni[_rd]_*``).

    x_tbd [T, B, D], mask_tb [T, B] (1 = valid), initial_state (h0, c0) fp32
    [B, H] or zeros; ``reverse`` scans from T-1 down to 0 (the input product
    and the mask flipped in time, the outputs flipped back).  Returns
    (outputs [T, B, H] in ``cdt``, zeros at padded steps; (hT, cT) fp32).
    """
    T, B, _ = x_tbd.shape
    H = params["wh"].shape[0]
    dev = x_tbd.device
    xw = project_inputs(params, x_tbd, cdt)
    if initial_state is None:
        h0 = torch.zeros((B, H), dtype=torch.float32, device=dev)
        c0 = torch.zeros((B, H), dtype=torch.float32, device=dev)
    else:
        h0, c0 = initial_state
    if mask_tb is None:
        mask_tb = torch.ones((T, B), dtype=torch.float32, device=dev)
    mask_tb = mask_tb.float()
    if reverse:
        xw, mask_tb = torch.flip(xw, (0,)), torch.flip(mask_tb, (0,))
    rd = None if recurrent_dropout_mask is None else recurrent_dropout_mask[None]
    if "ln_gamma" in params:
        ys, hT, cT = ln_lstm_scan_core(params["wh"][None], params["b"][None],
                                       *_ln_stack(params), xw[:, None], mask_tb[:, None],
                                       h0[None], c0[None], cdt, rd)
    else:
        ys, hT, cT = bilstm_scan_core(params["wh"][None], params["b"][None], xw[:, None],
                                      mask_tb[:, None], h0[None], c0[None], cdt, rd)
    ys = ys[:, 0]
    if reverse:
        ys = torch.flip(ys, (0,))
    return ys, (hT[0], cT[0])


def gru_scan(params: Params, x_tbd: torch.Tensor, mask_tb: Optional[torch.Tensor] = None,
             initial_state: Optional[torch.Tensor] = None, *, reverse: bool = False,
             cdt: torch.dtype = torch.bfloat16):
    """One GRU direction over time (the reference's ``gru_scan``): K12 at
    G = 1, counted apart (``gru_scan_uni_fwd`` / ``_bwd``), behind
    ``GRUScanCore``.  Arguments as ``lstm_scan``'s, initial_state h0 fp32
    [B, H] or zeros.  Returns (outputs [T, B, H] in ``cdt``, zeros at padded
    steps; hT fp32)."""
    T, B, _ = x_tbd.shape
    H = params["wh"].shape[0]
    dev = x_tbd.device
    xw = project_inputs(params, x_tbd, cdt)
    h0 = torch.zeros((B, H), dtype=torch.float32, device=dev) if initial_state is None \
        else initial_state
    if mask_tb is None:
        mask_tb = torch.ones((T, B), dtype=torch.float32, device=dev)
    mask_tb = mask_tb.float()
    if reverse:
        xw, mask_tb = torch.flip(xw, (0,)), torch.flip(mask_tb, (0,))
    ys, hT = gru_scan_core(params["wh"][None], params["b"][None], xw[:, None],
                           mask_tb[:, None], h0[None], cdt)
    ys = ys[:, 0]
    if reverse:
        ys = torch.flip(ys, (0,))
    return ys, hT[0]


def rnn_scan(cell_type: str, params: Params, x_tbd, mask_tb=None, initial_state=None, *,
             reverse: bool = False, cdt: torch.dtype = torch.bfloat16,
             recurrent_dropout_mask: Optional[torch.Tensor] = None):
    """The reference's ``rnn_scan``: ``lstm_scan`` (with the recurrent
    dropout mask where given; K13 for LN cells) or ``gru_scan`` (which takes
    none)."""
    _check_cell(cell_type)
    if cell_type == "gru":
        if recurrent_dropout_mask is not None:
            raise ValueError("gru_scan takes no recurrent dropout mask")
        return gru_scan(params, x_tbd, mask_tb, initial_state, reverse=reverse, cdt=cdt)
    return lstm_scan(params, x_tbd, mask_tb, initial_state, reverse=reverse, cdt=cdt,
                     recurrent_dropout_mask=recurrent_dropout_mask)
