"""K9's fused backward schedule, mirrored in numpy on the CPU.

The CUDA kernel (``csrc/conformer_conv.cu``, ``conv_bwd_fused_kernel``) walks
each item, an utterance's chunk of steps [c0, c1), in one pass over time:
the GLU'd rows y over [c0 - 2h, c1 + 2h), the LayerNorm backward's dx over
[c0 - h, c1 + h) (h = k / 2; rows outside [0, T) zero), du over [c0, c1),
and the item's partial sums of ddw, dln_scale, dln_bias and db_in over the
rows it owns; a second launch sums the items' partial rows in a fixed order
(lanes p = y, y + 8, ... first, then the 8 lanes in order).  The mirror
below runs the plain twin's arithmetic that way, item by item, and must
equal ``conformer_conv_bwd_plain`` up to the order of fp32 sums.  The
plan (route, chunks, scratch) is a function of (T, B, d, k) alone.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from avsr_tpu_torch import kernels
from avsr_tpu_torch.models import transformer as tfm

# Tolerances against the plain twin (max abs error over max |plain|), both
# in fp32 on the CPU with the same rounding points; only sum orders differ:
# du is bf16, and an fp32 sum of the transposed conv landing on the other
# side of dy's bf16 rounding moves an element by one bf16 ulp of dy (2^-8
# of it); db_in is an fp32 sum rounded once to bf16 (2^-8); ddw and the
# LayerNorm's gradients are fp32 sums of B * T rows in another order.
DU_REL_TOL = 8e-3
DB_REL_TOL = 8e-3
PARAM_REL_TOL = 1e-5


def bf16(x: np.ndarray) -> np.ndarray:
    """Round fp32 to the nearest bf16 (ties to even), kept as fp32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def sigmoid(x: np.ndarray) -> np.ndarray:
    return (np.float32(1) / (np.float32(1) + np.exp(-x))).astype(np.float32)


def mirror_bwd(u, b_in, dw, ln_scale, ln_bias, lengths, dout, chunks, chunk):
    """The fused kernel's schedule over numpy fp32 operands (u and dout hold
    bf16 values; dw [k, d]) -> (du, db_in, ddw, dln_scale, dln_bias)."""
    T, B, d2 = u.shape
    d, k = d2 // 2, dw.shape[0]
    h = k // 2
    f32 = np.float32
    ba, bg = bf16(b_in[:d]), bf16(b_in[d:])
    du = np.zeros((T, B, d2), f32)
    parts = []
    for b in range(B):
        for ci in range(chunks):
            c0, c1 = ci * chunk, min(ci * chunk + chunk, T)
            # A: y over [c0 - 2h, c1 + 2h), zero outside [0, T)
            ty = np.arange(c0 - 2 * h, c1 + 2 * h)
            y = np.zeros((len(ty), d), f32)
            a = np.zeros((len(ty), d), f32)
            g = np.zeros((len(ty), d), f32)
            inside = (ty >= 0) & (ty < T)
            rows = ty[inside]
            a[inside] = bf16(u[rows, b, :d] + ba)
            g[inside] = bf16(u[rows, b, d:] + bg)
            mask = (rows < lengths[b]).astype(f32)[:, None]
            y[inside] = bf16(a[inside] * bf16(sigmoid(g[inside]))) * mask
            # B: x, the LayerNorm and its backward over [c0 - h, c1 + h)
            tx = ty[h:len(ty) - h]
            x = np.zeros((len(tx), d), f32)
            for j in range(k):
                x = (x + y[j:j + len(tx)] * dw[j]).astype(f32)
            mu = (x.sum(axis=1, keepdims=True, dtype=f32) / f32(d)).astype(f32)
            var = ((x - mu) ** 2).sum(axis=1, keepdims=True, dtype=f32) / f32(d)
            rstd = (f32(1) / np.sqrt(var + f32(1e-6))).astype(f32)
            xh = ((x - mu) * rstd).astype(f32)
            z = (xh * ln_scale + ln_bias).astype(f32)
            go = np.zeros((len(tx), d), f32)
            inx = (tx >= 0) & (tx < T)
            go[inx] = dout[tx[inx], b]
            sz = sigmoid(z)
            dz = (go * sz + (z * go) * (sz * sigmoid(-z))).astype(f32)
            dxh = (dz * ln_scale).astype(f32)
            m1 = dxh.sum(axis=1, keepdims=True, dtype=f32) / f32(d)
            m2 = (dxh * xh).sum(axis=1, keepdims=True, dtype=f32) / f32(d)
            dx = (rstd * (dxh - m1 - xh * m2)).astype(f32)
            dx[~inx] = 0.0
            # C: the transposed conv, the mask and the GLU backward over [c0, c1)
            n = c1 - c0
            dy = np.zeros((n, d), f32)
            for j in range(k):
                dy = (dy + dx[2 * h - j:2 * h - j + n] * dw[j]).astype(f32)
            own = slice(2 * h, 2 * h + n)  # rows [c0, c1) of y, a, g
            m = (np.arange(c0, c1) < lengths[b]).astype(f32)[:, None]
            e = bf16(dy) * m
            sg = bf16(sigmoid(g[own]))
            da = bf16(e * sg)
            ds = bf16(e * a[own])
            dg = bf16(ds * bf16(sg * bf16(sigmoid(-g[own]))))
            du[c0:c1, b, :d], du[c0:c1, b, d:] = da, dg
            # the item's partial row: sums over its own rows, in time order
            part = np.zeros((k + 4) * d, f32)
            pw = part[:k * d].reshape(k, d)
            dsc, dbi = part[k * d:(k + 1) * d], part[(k + 1) * d:(k + 2) * d]
            db = part[(k + 2) * d:]
            for r in range(n):
                xr = h + r  # row c0 + r of x / dx; y[t + j - h] is y[r + h + j]
                for j in range(k):
                    pw[j] += y[r + h + j] * dx[xr]
                dsc += dz[xr] * xh[xr]
                dbi += dz[xr]
                db[:d] += da[r]
                db[d:] += dg[r]
            parts.append(part)
    # the second launch: lanes p = y, y + 8, ... then the 8 lanes in order
    parts = np.stack(parts)
    lanes = [parts[y::8].astype(f32).cumsum(axis=0, dtype=f32)[-1] if len(parts[y::8])
             else np.zeros(parts.shape[1], f32) for y in range(8)]
    total = np.zeros(parts.shape[1], f32)
    for lane in lanes:
        total = (total + lane).astype(f32)
    total[(k + 2) * d:] = bf16(total[(k + 2) * d:])
    ddw = total[:k * d].reshape(k, d)
    return (du, total[(k + 2) * d:], ddw, total[k * d:(k + 1) * d],
            total[(k + 1) * d:(k + 2) * d])


def _inputs(T, B, d, k, seed):
    """Numpy operands (u, dout bf16-valued; ragged lengths, row 1 of
    length 0) and the same as torch tensors for the plain twin."""
    rng = np.random.default_rng(seed)
    u = bf16(rng.standard_normal((T, B, 2 * d)).astype(np.float32))
    dout = bf16(rng.standard_normal((T, B, d)).astype(np.float32))
    b_in = (0.1 * rng.standard_normal(2 * d)).astype(np.float32)
    dw = (rng.standard_normal((k, d)) / np.sqrt(k)).astype(np.float32)
    ln_scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    ln_bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    lengths[0] = T
    if B > 1:
        lengths[1] = 0
    return u, b_in, dw, ln_scale, ln_bias, lengths, dout


# (T, B, d, k): T not a multiple of the chunk (3 chunks of 17, 17, 16);
# T < k (one chunk shorter than the taps); a batch that fills a wave (one
# chunk an utterance); an odd width the kernel admits (d = 200: 200
# channels on 224 threads); every case has a row of length 0
CASES = ((50, 3, 512, 15), (10, 2, 512, 15), (20, 133, 8, 15), (41, 4, 200, 15))


@pytest.mark.parametrize("T, B, d, k", CASES)
def test_fused_schedule_matches_the_plain_twin(T, B, d, k):
    plan = kernels.conformer_bwd_plan(T, B, d, k)
    assert plan["route"] == "fused"
    u, b_in, dw, ln_scale, ln_bias, lengths, dout = _inputs(T, B, d, k, seed=T + B + d)
    got = mirror_bwd(u, b_in, dw, ln_scale, ln_bias, lengths, dout, plan["chunks"],
                     plan["chunk"])
    bf = torch.bfloat16  # exact: u and dout hold bf16 values
    want = tfm.conformer_conv_bwd_plain(
        torch.from_numpy(u).to(bf), torch.from_numpy(b_in), torch.from_numpy(dw)[:, None, :],
        torch.from_numpy(ln_scale), torch.from_numpy(ln_bias), torch.from_numpy(lengths),
        torch.from_numpy(dout).to(bf))
    names = ("du", "db_in", "ddw", "dln_scale", "dln_bias")
    tols = (DU_REL_TOL, DB_REL_TOL, PARAM_REL_TOL, PARAM_REL_TOL, PARAM_REL_TOL)
    for name, g, w, tol in zip(names, got, want, tols):
        w = w.float().reshape(g.shape).numpy()
        rel = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert rel <= tol, f"{name}: {rel} > {tol}"
    # a row of length 0 takes no gradient through the mask
    assert not got[0][:, 1].any()


def test_plan_follows_from_the_shape_alone():
    """Route, chunks, partial rows, dx scratch and shared memory of K9's
    backward at the main path's and the phase check's shapes, and at the
    shapes the fused kernel does not take (the general route)."""
    plan = kernels.conformer_bwd_plan
    fused = kernels.conformer_bwd_fused_smem(512)
    assert fused == 38 * 2048 + 3 * 8 * 1024 + 2 * 22 * 1024 + 22 * 2048 + 2048 + 24
    assert fused <= kernels.SMEM_LIMIT
    want = {
        # train_v2: one chunk an utterance, one partial row an utterance
        (197, 128, 512, 15): ("fused", 1, 197, 128, 0, fused),
        # 16 s at B = 4: 32 chunks of 17 steps, one wave of 128 items
        (531, 4, 512, 15): ("fused", 32, 17, 128, 0, fused),
        (50, 3, 512, 15): ("fused", 3, 17, 9, 0, fused),
        (10, 2, 512, 15): ("fused", 1, 10, 2, 0, fused),
        (41, 4, 200, 15): ("fused", 2, 21, 8, 0, kernels.conformer_bwd_fused_smem(200)),
        # outside the fused kernel: other taps, widths past 512 or not a
        # multiple of 8 -> three launches over chunks of 64 steps
        (197, 128, 1024, 15): ("general", 4, 64, 512, 197 * 128 * 1024,
                               (16 + 14) * 1024 * 6),
        (197, 128, 512, 31): ("general", 4, 64, 512, 197 * 128 * 512, (16 + 30) * 512 * 6),
        (70, 5, 200, 3): ("general", 2, 64, 10, 70 * 5 * 200,
                          max(18 * 200 * 4 + 4 * 4 * 16 * 4, 18 * 200 * 6)),
        (197, 128, 500, 15): ("general", 4, 64, 512, 197 * 128 * 500, 30 * 500 * 6),
    }
    for shape, (route, nc, ch, rows, dx, smem) in want.items():
        got = plan(*shape)
        assert got == plan(*shape)  # no state between calls
        assert (got["route"], got["chunks"], got["chunk"], got["part_rows"],
                got["dx_elements"], got["smem"]) == (route, nc, ch, rows, dx, smem), shape
        T = shape[0]
        assert got["chunks"] * got["chunk"] >= T > (got["chunks"] - 1) * got["chunk"]
    # every fused shape holds in one block's shared memory
    for d in range(8, kernels.CONV_BWD_MAX_D + 1, 8):
        assert plan(197, 128, d, 15)["smem"] <= kernels.SMEM_LIMIT
    # the chunks: one an utterance once B fills a wave, at least 16 steps each
    for B in (1, 2, 8, 33, 66, 67, 132, 256):
        for T in (1, 15, 16, 17, 197, 531):
            got = plan(T, B, 512, 15)
            if B * 2 > kernels.CONV_BWD_BLOCKS:
                assert got["chunks"] == 1
            assert got["chunks"] == 1 or got["chunk"] >= kernels.CONV_BWD_MIN_CH
            assert got["part_rows"] == B * got["chunks"]
