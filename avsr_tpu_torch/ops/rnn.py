"""Fused-gate LSTM scans, forward (counterpart of ``avsr_tpu/ops/rnn.py``).

The reference hoists the input projection ``x @ Wx`` for all timesteps out
of the scan (one large matmul, stored in the compute dtype) and runs both
BiLSTM directions in ONE scan over a direction-batched recurrent product,
with the backward direction's stream and mask flipped in time.  Padded
steps carry (h, c) through unchanged and emit zeros.

The recurrence itself — ``_bilstm_scan_core`` in the reference, its
hand-derived custom-VJP core — is kernel K1 here: ``bilstm_scan_core``
launches the CUDA kernel (``csrc/lstm_scan.cu``) for tensors on a GPU and
runs ``bilstm_scan_core_plain`` for tensors on the CPU.  Only the forward
direction of autodiff exists so far (serving); the backward kernel is
later work.
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


def bilstm_scan_core_plain(wh, b, xw, mask, h0, c0, cdt):
    """Plain-PyTorch K1: the reference's ``_bilstm_scan_core`` forward.

    wh [G,H,4H], b [G,4H], xw [T,G,B,4H] (any float dtype), mask [T,G,B]
    fp32, h0/c0 [G,B,H] fp32 -> (ys [T,G,B,H] in ``cdt``, hT, cT fp32).
    """
    wh_c = wh.to(cdt).float()  # compute-dtype operands, fp32 products
    b_e = b[:, None, :]
    h, c = h0, c0
    ys = []
    for t in range(xw.shape[0]):
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
    return torch.stack(ys), h, c


def bilstm_scan_core(wh, b, xw, mask, h0, c0, cdt):
    """K1 wrapper: CUDA kernel for GPU tensors, plain version on the CPU.

    The kernel implements the main path's bf16 policy only; any other
    compute dtype on a GPU raises rather than falling back.
    """
    if xw.device.type == "cpu":
        return bilstm_scan_core_plain(wh, b, xw, mask, h0, c0, cdt)
    if cdt != torch.bfloat16:
        raise ValueError(f"the LSTM scan kernel runs the bf16 policy only, got {cdt}")
    return kernels.lstm_scan_fwd(
        wh.to(torch.bfloat16).contiguous(), b.float().contiguous(),
        xw.to(torch.bfloat16).contiguous(), mask.float().contiguous(),
        h0.float().contiguous(), c0.float().contiguous(),
    )


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
