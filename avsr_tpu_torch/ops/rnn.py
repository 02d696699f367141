"""Fused-gate LSTM scans (counterpart of ``avsr_tpu/ops/rnn.py``).

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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from avsr_tpu_torch import kernels
from avsr_tpu_torch.utils.params import Params, glorot_uniform, orthogonal


def lstm_init(gen: torch.Generator, input_dim: int, hidden: int, device="cpu") -> Params:
    """``wx [D,4H]`` Glorot, ``wh [H,4H]`` block-orthogonal, ``b [4H]``
    zeros with forget-gate bias 1 (gate order i, f, g, o)."""
    b = torch.zeros(4 * hidden, dtype=torch.float32)
    b[hidden:2 * hidden] = 1.0
    return {
        "wx": glorot_uniform(gen, (input_dim, 4 * hidden), device),
        "wh": orthogonal(gen, (hidden, 4 * hidden), device),
        "b": b.to(device),
    }


def project_inputs(params: Params, x_tbd: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """Hoisted input projection ``[T,B,D] @ [D,4H]``, stored in ``cdt``
    (fp32 accumulation; the reference's ``_project_inputs``)."""
    return x_tbd.to(cdt) @ params["wx"].to(cdt)


def bilstm_scan_core_fwd_impl(wh, b, xw, mask, h0, c0, cdt, save):
    """Plain-PyTorch K1 forward: the reference's ``_bilstm_scan_core_fwd_impl``.

    wh [G,H,4H], b [G,4H], xw [T,G,B,4H] (any float dtype), mask [T,G,B]
    fp32, h0/c0 [G,B,H] fp32 -> ((ys [T,G,B,H] in ``cdt``, hT, cT fp32),
    res), where res is (h_res, c_res), the ``cdt`` carries entering each
    step [T,G,B,H], when ``save``, else None.
    """
    wh_c = wh.to(cdt).float()  # compute-dtype operands, fp32 products
    b_e = b[:, None, :]
    h, c = h0, c0
    ys, h_res, c_res = [], [], []
    for t in range(xw.shape[0]):
        if save:
            h_res.append(h.to(cdt))
            c_res.append(c.to(cdt))
        gates = xw[t].float() + torch.bmm(h.to(cdt).float(), wh_c) + b_e
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


def bilstm_scan_core_plain(wh, b, xw, mask, h0, c0, cdt):
    """Plain-PyTorch K1 forward, outputs only: (ys, hT, cT)."""
    out, _ = bilstm_scan_core_fwd_impl(wh, b, xw, mask, h0, c0, cdt, save=False)
    return out


def bilstm_scan_core_bwd_plain(wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, cdt):
    """Plain-PyTorch K1 backward: the reference's ``_bilstm_scan_core_bwd``
    (``avsr_tpu/ops/rnn.py:382-454``), line for line.

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
        dh_prev = torch.bmm(dgates_c.float(), wh_c.transpose(1, 2)) + dh_prev_direct
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


def scan_core_fwd(wh, b, xw, mask, h0, c0, cdt, save):
    """K1 forward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``bilstm_scan_core_fwd_impl``.

    The kernel implements the main path's bf16 policy only; any other
    compute dtype on a GPU raises rather than falling back.
    """
    if xw.device.type == "cpu":
        return bilstm_scan_core_fwd_impl(wh, b, xw, mask, h0, c0, cdt, save)
    _check_policy(cdt)
    ys, hT, cT, h_res, c_res = kernels.lstm_scan_fwd(
        wh.to(torch.bfloat16).contiguous(), b.float().contiguous(),
        xw.to(torch.bfloat16).contiguous(), mask.float().contiguous(),
        h0.float().contiguous(), c0.float().contiguous(), save=save,
    )
    return (ys, hT, cT), ((h_res, c_res) if save else None)


def scan_core_bwd(wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, cdt):
    """K1 backward wrapper: the CUDA kernel for GPU tensors, the plain
    version on the CPU; same contract as ``bilstm_scan_core_bwd_plain``."""
    if xw.device.type == "cpu":
        return bilstm_scan_core_bwd_plain(wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, cdt)
    _check_policy(cdt)
    dxw, db, dh0, dc0 = kernels.lstm_scan_bwd(
        wh.to(torch.bfloat16).contiguous(), b.float().contiguous(),
        xw.to(torch.bfloat16).contiguous(), mask.float().contiguous(),
        h_res.contiguous(), c_res.contiguous(), dys.to(torch.bfloat16).contiguous(),
        dhT.float().contiguous(), dcT.float().contiguous(),
    )
    return _dwh(h_res, dxw).to(wh.dtype), db.to(b.dtype), dxw.to(xw.dtype), dh0, dc0


class BiLSTMScanCore(torch.autograd.Function):
    """K1 with its hand-written gradient (the reference's ``jax.custom_vjp``).

    The forward saves the ``cdt`` carries entering each step, and only
    when an input asks for a gradient; the backward recomputes the gates
    from them.  ``mask`` gets no gradient (the reference returns zeros).
    """

    @staticmethod
    def forward(ctx, wh, b, xw, mask, h0, c0, cdt):
        save = any(ctx.needs_input_grad)
        (ys, hT, cT), res = scan_core_fwd(wh, b, xw, mask, h0, c0, cdt, save)
        ctx.cdt = cdt
        if save:
            ctx.save_for_backward(wh, b, xw, mask, *res)
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        wh, b, xw, mask, h_res, c_res = ctx.saved_tensors
        dwh, db, dxw, dh0, dc0 = scan_core_bwd(wh, b, xw, mask, h_res, c_res,
                                               dys, dhT, dcT, ctx.cdt)
        return dwh, db, dxw, None, dh0, dc0, None


def bilstm_scan_core(wh, b, xw, mask, h0, c0, cdt):
    """K1 as the encoders call it: (ys, hT, cT).  With autograd recording
    and an input that needs a gradient it goes through ``BiLSTMScanCore``;
    otherwise (serving) straight to the forward wrapper, saving nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (wh, b, xw, h0, c0)):
        return BiLSTMScanCore.apply(wh, b, xw, mask, h0, c0, cdt)
    out, _ = scan_core_fwd(wh, b, xw, mask, h0, c0, cdt, save=False)
    return out


def fused_bilstm_scan(
    params_fwd: Params,
    params_bwd: Params,
    x_tbd: torch.Tensor,
    mask_tb: Optional[torch.Tensor],
    cdt: torch.dtype,
) -> Tuple[torch.Tensor, Tuple]:
    """Both BiLSTM directions in one scan (reference ``fused_bilstm_scan``).

    Returns (concat(fwd, bwd) outputs [T,B,2H] in ``cdt``,
    ((hT_f, cT_f), (hT_b, cT_b))).
    """
    T, B, _ = x_tbd.shape
    H = params_fwd["wh"].shape[0]
    dev = x_tbd.device
    if mask_tb is None:
        mask_tb = torch.ones((T, B), dtype=torch.float32, device=dev)
    mask_tb = mask_tb.float()
    xw_f = project_inputs(params_fwd, x_tbd, cdt)
    xw_b = project_inputs(params_bwd, x_tbd, cdt)
    xw = torch.stack([xw_f, torch.flip(xw_b, (0,))], dim=1)              # [T,2,B,4H]
    mask2 = torch.stack([mask_tb, torch.flip(mask_tb, (0,))], dim=1)     # [T,2,B]
    wh2 = torch.stack([params_fwd["wh"], params_bwd["wh"]])
    b2 = torch.stack([params_fwd["b"], params_bwd["b"]])
    h0 = torch.zeros((2, B, H), dtype=torch.float32, device=dev)
    c0 = torch.zeros((2, B, H), dtype=torch.float32, device=dev)
    ys, hT, cT = bilstm_scan_core(wh2, b2, xw, mask2, h0, c0, cdt)
    out = torch.cat([ys[:, 0], torch.flip(ys[:, 1], (0,))], dim=-1)
    return out, ((hT[0], cT[0]), (hT[1], cT[1]))


def bidirectional_scan(cell_type: str, params_fwd: Params, params_bwd: Params,
                       x_tbd, mask_tb, cdt):
    """The reference's ``bidirectional_scan`` for plain LSTM cells, which
    always takes the fused single-scan path."""
    if cell_type != "lstm" or "ln_gamma" in params_fwd:
        raise ValueError("the port runs plain LSTM cells only (no GRU, no LN-LSTM)")
    return fused_bilstm_scan(params_fwd, params_bwd, x_tbd, mask_tb, cdt)
