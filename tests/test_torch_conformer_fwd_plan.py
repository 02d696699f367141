"""K9's fused forward schedule, mirrored in numpy on the CPU.

The CUDA kernel (``csrc/conformer_conv.cu``, ``conv_fwd_fused_kernel``)
walks each item, an utterance's chunk of steps [c0, c1), in one pass over
time: tile n's stage A forms the GLU'd rows y of c0 - 9 + 8 n .. c0 - 2 + 8
n (those of [c0 - h, c1 + h) inside [0, T) from u, every other row 0; h =
k / 2) into a window of y's last three tiles held in each thread's
registers, and from tile 2 on stage B runs the conv, the LayerNorm and the
swish of rows c0 + 8 (n - 2) .. and writes those inside [c0, c1).  The
mirror below runs the plain twin's arithmetic that way, item by item, and
must give the plain twin's output; it also checks that stage B always finds
in the window the rows it reads, and that the plan (``kernels.
conformer_fwd_plan``: route, chunks, shared memory) covers every
(utterance, step) once and is a function of (T, B, d, k) alone.  The plain
forward is held against a jnp transcription of the JAX encoder's conv span
(``avsr_tpu/models/transformer.py:240-264``) at small sizes.

Tolerances: the mirror against the plain twin in fp32 at 1e-5 (both fp32
with the same rounding points; only sum orders differ, outputs of order
one); under the bf16 policy at 2e-2 + 2^-7 |plain| (chip_smoke's K9_TOL and
K9_ULP: an fp32 sum in another order can land on the other side of the
output's bf16 rounding, one bf16 ulp).  The plain twin against jnp: 1e-5 in
fp32; in bf16 2e-2 as ``tests/test_torch_transformer_encoder.py`` holds it,
plus 2^-7 of the value (one bf16 ulp: JAX on the CPU rounds each step of its
bf16 sigmoid, the port each sigmoid once, and an output past 4 moves by
0.03125 where one rounding flips; chip_smoke's K9_ULP).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.models.transformer_common import layer_norm as jlayer_norm
from avsr_tpu_torch import kernels
from avsr_tpu_torch.models import transformer as tfm

BR = kernels.CONV_BWD_ROWS   # rows a tile
TAPS = kernels.CONV_BWD_TAPS
FPRO = 2                     # tiles of stage A alone before stage B's first


def bf16(x: np.ndarray) -> np.ndarray:
    """Round fp32 to the nearest bf16 (ties to even), kept as fp32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def sigmoid(x: np.ndarray) -> np.ndarray:
    return (np.float32(1) / (np.float32(1) + np.exp(-x))).astype(np.float32)


def mirror_fwd(u, b_in, dw, ln_scale, ln_bias, lengths, chunks, chunk, rnd):
    """The fused forward's tile walk over numpy fp32 operands (dw [k, d];
    ``rnd`` the compute dtype's rounding: ``bf16`` or the identity) ->
    (out [T, B, d], z [T, B, d])."""
    T, B, d2 = u.shape
    d, k = d2 // 2, dw.shape[0]
    h = k // 2
    f32 = np.float32
    ba, bg = rnd(b_in[:d]), rnd(b_in[d:])
    out = np.full((T, B, d), np.nan, f32)
    z_all = np.full((T, B, d), np.nan, f32)
    written = np.zeros((T, B), np.int32)
    for b in range(B):
        for ci in range(chunks):
            c0, c1 = ci * chunk, min(ci * chunk + chunk, T)
            u_lo, u_hi = max(c0 - h, 0), min(c1 + h, T)
            ntiles = FPRO + -(-(c1 - c0) // BR)
            win = np.zeros((3 * BR, d), f32)
            rows = np.full(3 * BR, -10 ** 6)  # the window's row of each slot
            for n in range(ntiles):
                A0, B0 = c0 + h + (n - FPRO) * BR, c0 + (n - FPRO) * BR
                win[:2 * BR], rows[:2 * BR] = win[BR:].copy(), rows[BR:].copy()
                for r in range(BR):
                    t = A0 + r
                    live = u_lo <= t < u_hi and t < lengths[b]
                    y = 0.0
                    if live:
                        a = rnd(u[t, b, :d] + ba)
                        g = rnd(u[t, b, d:] + bg)
                        y = rnd(a * rnd(sigmoid(g)))
                    win[2 * BR + r], rows[2 * BR + r] = y, t
                if n < FPRO:
                    continue
                yw = win[3 * BR - (2 * h + BR):]
                # stage B reads y's rows B0 - h .. B0 + BR - 1 + h, each in the
                # window (rows outside [c0 - h, c1 + h) hold 0 there, as they
                # would from u only where outside [0, T) or masked)
                assert list(rows[3 * BR - (2 * h + BR):]) == list(range(B0 - h, B0 + BR + h))
                x = np.zeros((BR, d), f32)
                for j in range(k):
                    x = (x + yw[j:j + BR] * dw[j]).astype(f32)
                mu = (x.sum(axis=1, keepdims=True, dtype=f32) * f32(1.0 / d)).astype(f32)
                var = ((x - mu) ** 2).sum(axis=1, keepdims=True, dtype=f32) * f32(1.0 / d)
                rstd = (f32(1) / np.sqrt(var + f32(1e-6))).astype(f32)
                z = ((x - mu) * rstd * ln_scale + ln_bias).astype(f32)
                o = rnd((z * sigmoid(z)).astype(f32))
                for r in range(BR):
                    t = B0 + r
                    if c0 <= t < c1:
                        out[t, b], z_all[t, b] = o[r], z[r]
                        written[t, b] += 1
    assert (written == 1).all()  # every (step, utterance) once
    return out, z_all


def _inputs(T, B, d, k, seed):
    """Numpy operands (u bf16-valued; ragged lengths, row 1 of length 0)."""
    rng = np.random.default_rng(seed)
    u = bf16(rng.standard_normal((T, B, 2 * d)).astype(np.float32))
    b_in = bf16((0.1 * rng.standard_normal(2 * d)).astype(np.float32))
    dw = (rng.standard_normal((k, d)) / np.sqrt(k)).astype(np.float32)
    ln_scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    ln_bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    lengths[0] = T
    if B > 1:
        lengths[1] = 0
    return u, b_in, dw, ln_scale, ln_bias, lengths


def _plain(u, b_in, dw, ln_scale, ln_bias, lengths, dtype):
    return tfm.conformer_conv_plain(
        torch.from_numpy(u).to(dtype), torch.from_numpy(b_in), torch.from_numpy(dw)[:, None, :],
        torch.from_numpy(ln_scale), torch.from_numpy(ln_bias),
        torch.from_numpy(lengths)).float().numpy()


# (T, B, d): many chunks of 8 steps (B = 2: 132 chunks an utterance wanted,
# as many as T gives), T not a multiple of 8, T shorter than the taps, a
# batch with chunks of 16, an odd width the kernel admits (d = 200)
CASES = ((40, 2, 16), (21, 3, 32), (10, 2, 16), (50, 20, 8), (30, 5, 200))


@pytest.mark.parametrize("T, B, d", CASES)
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_fused_schedule_matches_the_plain_twin(T, B, d, policy):
    plan = kernels.conformer_fwd_plan(T, B, d, TAPS)
    assert plan["route"] == "fused"
    args = _inputs(T, B, d, TAPS, seed=T + B + d)
    rnd, dtype = (bf16, torch.bfloat16) if policy == "bf16" else (lambda x: x, torch.float32)
    got, _ = mirror_fwd(*args, plan["chunks"], plan["chunk"], rnd)
    want = _plain(*args, dtype)
    if policy == "fp32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert (np.abs(got - want) <= 2e-2 + 2.0 ** -7 * np.abs(want)).all()
    # the padded steps' GLU is zero, not their output: every row is written
    assert np.isfinite(got).all()


@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 8, 16, 33, 64, 100, 128])
@pytest.mark.parametrize("T", [1, 7, 8, 50, 133, 197, 531])
def test_plan_covers_every_step_once(B, T):
    """At the presets' widths every (utterance, step) lies in exactly one
    item; chunks are whole tiles of 8 steps; the items fit one wave of
    ``CONV_FWD_ITEMS`` (two blocks an SM), one chunk an utterance where B
    fills it."""
    plan = kernels.conformer_fwd_plan(T, B, 512, TAPS)
    assert plan["route"] == "fused"
    nc, ch = plan["chunks"], plan["chunk"]
    assert ch % BR == 0 and ch >= 1
    assert nc * ch >= T and (nc - 1) * ch < T
    cover = np.zeros(T, np.int32)
    for c in range(nc):
        cover[c * ch:min(T, (c + 1) * ch)] += 1
    assert (cover == 1).all()
    assert B * nc <= max(B, kernels.CONV_FWD_ITEMS)
    if B * 2 > kernels.CONV_FWD_ITEMS:
        assert nc == 1


def test_plan_follows_from_the_shape_alone():
    """Route, chunks and shared memory of K9's forward at the main path's
    shapes (a train batch, a request, the 16 s limit) and at the shapes the
    pass over time does not take (the tiles)."""
    plan = kernels.conformer_fwd_plan
    fused = kernels.conformer_fwd_fused_smem(512)
    want = {
        (197, 128, 512, 15): ("fused", 2, 104, fused),
        (197, 8, 512, 15): ("fused", 25, 8, fused),
        (531, 4, 512, 15): ("fused", 34, 16, fused),
        (531, 1, 512, 15): ("fused", 67, 8, fused),
        (197, 264, 512, 15): ("fused", 1, 200, fused),
        (30, 5, 200, 15): ("fused", 4, 8, kernels.conformer_fwd_fused_smem(200)),
        (197, 128, 1024, 15): ("tiles", 13, 16, (16 + 14) * 1024 * 4 + 2 * 16 * 16 * 4),
        (197, 128, 512, 31): ("tiles", 13, 16, (16 + 30) * 512 * 4 + 2 * 8 * 16 * 4),
        (70, 5, 200, 3): ("tiles", 5, 16, (16 + 2) * 200 * 4 + 2 * 4 * 16 * 4),
        (197, 128, 500, 15): ("tiles", 13, 16, 30 * 500 * 4 + 2 * 8 * 16 * 4),
    }
    for shape, (route, nc, ch, smem) in want.items():
        for _ in range(2):
            p = plan(*shape)
            assert (p["route"], p["chunks"], p["chunk"], p["smem"]) == (route, nc, ch, smem), shape


@pytest.mark.parametrize("d", list(range(8, kernels.CONV_BWD_MAX_D + 1, 8)))
def test_fused_forward_layout_fits(d):
    """The fused forward's shared memory at every width it takes: u's three
    tiles [8, 2d] bf16, the two row reductions' per-warp partials and three
    mbarriers, well within a block's (two blocks an SM)."""
    smem = kernels.conformer_fwd_fused_smem(d)
    assert smem == 3 * 8 * 4 * d + 2 * 16 * 8 * 4 + 3 * 8
    assert kernels.CONV_FWD_CTAS_PER_SM * smem <= 228 * 1024
    assert smem <= kernels.SMEM_LIMIT


@pytest.mark.parametrize("T, B, d, k", [(197, 128, 512, 15), (70, 5, 1024, 15)])
def test_launcher_rejects_cpu_tensors_and_counts_no_launch(T, B, d, k):
    """The CUDA wrapper checks the device before building or launching, on
    either route, and counts no launch; z is the pass over time's alone."""
    bf = torch.bfloat16
    args = (torch.zeros(4, 2, 2 * d, dtype=bf), torch.zeros(2 * d, dtype=bf), torch.zeros(k, d),
            torch.ones(d), torch.zeros(d), torch.tensor([4, 0], dtype=torch.int32))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.conformer_conv_fwd(*args)
    assert kernels.LAUNCHES == before
    assert kernels.conformer_fwd_plan(T, B, d, k)["route"] == ("fused" if d <= 512 else "tiles")


def _jnp_conv_module(u, b_in, dw, ln_scale, ln_bias, lengths):
    """transformer.py:241-264 from the first pointwise product to the
    operand of the second, time-major u [T, B, 2d]."""
    cdt = u.dtype
    d = u.shape[-1] // 2
    mask = (jnp.arange(u.shape[0])[:, None] < lengths[None, :]).astype(jnp.float32)
    g = u + b_in.astype(cdt)
    a, b_gate = jnp.split(g, 2, axis=-1)
    y = a * jax.nn.sigmoid(b_gate)
    y = y * mask[:, :, None].astype(cdt)
    yb = jnp.transpose(y, (1, 0, 2)).astype(jnp.float32)
    yb = jax.lax.conv_general_dilated(yb, dw.astype(jnp.float32), window_strides=(1,),
                                      padding="SAME", dimension_numbers=("NWC", "WIO", "NWC"),
                                      feature_group_count=d)
    y = jlayer_norm(jnp.transpose(yb, (1, 0, 2)), ln_scale, ln_bias)
    return (y * jax.nn.sigmoid(y)).astype(cdt)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("T", [9, 40])
def test_plain_forward_matches_the_jax_conv_span(policy, T):
    """The plain forward (the CPU side of both routes) at the presets' 15
    taps against the JAX encoder's conv span, ragged with a 0-length row."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[policy]
    u, b_in, dw, ln_scale, ln_bias, lengths = _inputs(T, 4, 32, TAPS, seed=T)
    want = _jnp_conv_module(jnp.asarray(u, jdt), jnp.asarray(b_in), jnp.asarray(dw)[:, None, :],
                            jnp.asarray(ln_scale), jnp.asarray(ln_bias), jnp.asarray(lengths))
    got = _plain(u, b_in, dw, ln_scale, ln_bias, lengths, tdt)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=1e-5 if policy == "fp32" else 2e-2,
                               rtol=0 if policy == "fp32" else 2.0 ** -7)
