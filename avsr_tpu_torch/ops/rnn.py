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
product's cotangents rounded to the compute dtype).  LN-LSTM cells
(``layer_norm=True``) are not ported and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avsr_tpu_torch import kernels
from avsr_tpu_torch.utils.numerics import dot_f32, rounded
from avsr_tpu_torch.utils.params import Params, glorot_uniform, orthogonal

LN_LSTM_UNPORTED = (
    "LN-LSTM cells (layer_norm=True) are not ported yet: they wait for the next slice's "
    "kernel (K13), whose per-gate-block LayerNorm reduces over all H units of a row inside "
    "the recurrence")


def lstm_init(gen: torch.Generator, input_dim: int, hidden: int, device) -> Params:
    """``wx [D,4H]`` Glorot, ``wh [H,4H]`` block-orthogonal, ``b [4H]``
    zeros with forget-gate bias 1 (gate order i, f, g, o)."""
    b = torch.zeros(4 * hidden, dtype=torch.float32)
    b[hidden:2 * hidden] = 1.0
    return {
        "wx": glorot_uniform(gen, (input_dim, 4 * hidden), device),
        "wh": orthogonal(gen, (hidden, 4 * hidden), device),
        "b": b.to(device),
    }


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
    if layer_norm:
        raise ValueError(LN_LSTM_UNPORTED)
    if cell_type == "lstm":
        return lstm_init(gen, input_dim, hidden, device)
    if cell_type == "gru":
        return gru_init(gen, input_dim, hidden, device)
    raise ValueError(f"unknown cell type {cell_type}")


def lstm_step(params: Params, x_or_xw: torch.Tensor,
              state: Tuple[torch.Tensor, torch.Tensor], cdt: torch.dtype, *,
              preprojected: bool = False):
    """One fused LSTM step (the reference's ``lstm_step``, plain cells).

    ``x_or_xw`` is the input [B, D_in], or the fp32 input product [B, 4H]
    when ``preprojected``; state (h, c) fp32 [B, H].  Gates are
    ``(xw + bf16(h) @ bf16(Wh)) + b`` with fp32 products -> ((h', c'), h').
    """
    if "ln_gamma" in params:
        raise ValueError(LN_LSTM_UNPORTED)
    h, c = state
    xw = x_or_xw if preprojected else dot_f32(x_or_xw, params["wx"], cdt)
    gates = xw + dot_f32(h, params["wh"], cdt)
    gates = gates + params["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
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


def _check_policy(cdt):
    if cdt != torch.bfloat16:
        raise ValueError(f"the LSTM scan kernels run the bf16 policy only, got {cdt}")


def _rd_arg(rd):
    return None if rd is None else rd.float().contiguous()


def scan_core_fwd(wh, b, xw, mask, h0, c0, cdt, save, rd=None):
    """K1 forward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``bilstm_scan_core_fwd_impl``.

    The kernel implements the main path's bf16 policy only; any other
    compute dtype on a GPU raises rather than falling back.
    """
    if xw.device.type == "cpu":
        return bilstm_scan_core_fwd_impl(wh, b, xw, mask, h0, c0, cdt, save, rd)
    _check_policy(cdt)
    ys, hT, cT, h_res, c_res = kernels.lstm_scan_fwd(
        wh.to(torch.bfloat16).contiguous(), b.float().contiguous(),
        xw.to(torch.bfloat16).contiguous(), mask.float().contiguous(),
        h0.float().contiguous(), c0.float().contiguous(), save=save, rd=_rd_arg(rd),
    )
    return (ys, hT, cT), ((h_res, c_res) if save else None)


def scan_core_bwd(wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, cdt, rd=None):
    """K1 backward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``bilstm_scan_core_bwd_plain``."""
    if xw.device.type == "cpu":
        return bilstm_scan_core_bwd_plain(wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, cdt, rd)
    _check_policy(cdt)
    dxw, db, dh0, dc0 = kernels.lstm_scan_bwd(
        wh.to(torch.bfloat16).contiguous(), b.float().contiguous(),
        xw.to(torch.bfloat16).contiguous(), mask.float().contiguous(),
        h_res.contiguous(), c_res.contiguous(), dys.to(torch.bfloat16).contiguous(),
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
    _check_policy(cdt)
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
    _check_policy(cdt)
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


def _check_cell(cell_type: str, params: Params) -> None:
    if "ln_gamma" in params:
        raise ValueError(LN_LSTM_UNPORTED)
    if cell_type not in ("lstm", "gru"):
        raise ValueError(f"unknown cell type {cell_type}")


def bidirectional_scan(cell_type: str, params_fwd: Params, params_bwd: Params,
                       x_tbd, mask_tb, cdt, recurrent_dropout_masks=None):
    """The reference's ``bidirectional_scan``: plain LSTM cells on the fused
    single scan (K1, with the recurrent-dropout masks where given), GRU
    cells on one direction-batched K12 scan.  GRU ignores the masks, as
    the reference does."""
    _check_cell(cell_type, params_fwd)
    if cell_type == "gru":
        return fused_bigru_scan(params_fwd, params_bwd, x_tbd, mask_tb, cdt)
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
    ``lstm_scan_uni[_rd]_fwd`` / ``_bwd``), behind ``BiLSTMScanCore``.

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
    dropout mask where given) or ``gru_scan`` (which takes none); LN-LSTM
    raises."""
    _check_cell(cell_type, params)
    if cell_type == "gru":
        if recurrent_dropout_mask is not None:
            raise ValueError("gru_scan takes no recurrent dropout mask")
        return gru_scan(params, x_tbd, mask_tb, initial_state, reverse=reverse, cdt=cdt)
    return lstm_scan(params, x_tbd, mask_tb, initial_state, reverse=reverse, cdt=cdt,
                     recurrent_dropout_mask=recurrent_dropout_mask)
