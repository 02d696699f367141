"""K5's cross attention kernels (``csrc/decoder_cross_attention.cuh``) as
their plain mirror on the CPU.

The kernels run only on the card (chip_smoke holds them against the plain
twins there).  Here their decomposition, ``decoder_cross_fwd_split_plain``
/ ``decoder_cross_bwd_split_plain`` below, is held against the plain twins (``decoder_attention_fwd_plain`` /
``_bwd_plain``) and against ``jax.vjp`` of the reference's cross-attention
core lines (``avsr_tpu/models/transformer_decoder.py:359-373``): the
forward in blocks of 16-query strips (``kernels.decoder_cross_fwd_strips``:
5 at Q = 80, two blocks of 5 at Q = 150, 3 where a long memory's scores
fill the block), the scores a 32-key tile at a time, the row sum over the
two halves' alternate key steps, P.V over the two 128-column halves of
V; the backward's D over a first pass of the key tiles, dQ summed over
the tiles in order, each tile's dK and dV.  Shapes: Q = 80, a Q that is
not a multiple of 16 (37), S = 50, 197, 531 and 900 (past the length at
which five strips' scores fit a block), with a memory of length 0 (the
uniform softmax over all S keys) in every batch; the kernels' widths (dk,
dv) = (128, 256).

Tolerances.  Against the twins in fp32: the same arithmetic with sums in
another order: outputs atol 1e-5 / rtol 1e-4 (the row max exactly equal:
a max has no order), gradients 1e-5 of the largest twin value.  Under the
bf16 policy both sides round the same values at the same points; a sum in
another order can move a value across a rounding boundary, 2^-8 relative:
outputs atol / rtol 2e-2, gradients 3e-2 of the largest value (the
decoder tests' tolerances).  Against JAX: the decoder kernel tests'
(``test_torch_decoder_kernels.py``): fp32 atol 1e-5 / rtol 1e-4, bf16 as
above.  The route by shape (``kernels.decoder_cross_route``: these
kernels where they hold the lengths, the streamed tiles past them) is
checked as a table.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avsr_tpu_torch import kernels
from avsr_tpu_torch.models import transformer_decoder as ttd

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
DK, DV = 128, 256
# (B, Q, S, nh): the fast memory, v2's, a Q off the 16-row strips, the 16 s
# memory at the 150-label horizon, a memory past five strips' scores
SHAPES = [(3, 80, 50, 1), (2, 80, 197, 2), (3, 37, 197, 1), (2, 150, 531, 1), (2, 80, 900, 1)]
IDS = [f"Q{q}-S{s}" for _, q, s, _ in SHAPES]
# the longest memory the forward's block holds, one 16-query strip's scores
FWD_MAX_S = 5376


CROSS_TILE = 32  # keys a ring tile of K5's cross kernels (TK in csrc/decoder_cross_attention.cuh)


def _halves(x: torch.Tensor, S: int) -> torch.Tensor:
    """Sum over the last axis (S keys) as the cross kernels take it: the
    16-key steps alternate between a strip's two warps, each half summed
    apart, then half 0 + half 1."""
    pad = (-S) % 16
    steps = F.pad(x, (0, pad)).unflatten(-1, (-1, 16))
    return steps[..., 0::2, :].sum(dim=(-1, -2)) + steps[..., 1::2, :].sum(dim=(-1, -2))


def _cross_scores(q, k, bias):
    """fp32 [B,nh,Q,S] scores of the cross kernels: bf16(q.k) one 32-key tile
    at a time (the value the forward stores), / sqrt(dk), plus the bias."""
    S, dk = k.shape[1], q.shape[-1]
    raw = torch.cat([torch.einsum("bqhd,bkhd->bhqk", q, k[:, t:t + CROSS_TILE])
                     for t in range(0, S, CROSS_TILE)], dim=-1)
    return raw.float() / math.sqrt(dk) + bias[:, None, None, :]


def decoder_cross_fwd_split_plain(q, k, v, bias, *, save: bool = False):
    """The decomposition of K5's cross forward (``csrc/decoder_cross_attention.cuh``)
    in plain PyTorch: blocks of ``kernels.decoder_cross_fwd_strips``
    strips of 16 queries; per block the scores one key tile at a time, the
    row max, the sum over the two halves' alternate key steps, bf16(P), then
    P.V for each 128-column half of the values, summed tile by tile.  Same
    contract as ``ttd.decoder_attention_fwd_plain`` with a bias."""
    B, Q, nh, _ = q.shape
    S, dv = k.shape[1], v.shape[-1]
    strips = kernels.decoder_cross_fwd_strips(Q, S)
    ctx = torch.empty((B, Q, nh, dv), dtype=q.dtype)
    row_max = torch.empty((B, nh, Q))
    row_sum = torch.empty((B, nh, Q))
    for i0 in range(0, Q, 16 * strips):
        rows = slice(i0, i0 + 16 * strips)
        s = _cross_scores(q[:, rows], k, bias)
        mx = s.amax(dim=-1)
        e = torch.exp(s - mx[..., None])
        sm = _halves(e, S)
        p = (e / sm[..., None]).to(q.dtype)
        half = dv // 2
        for c in range(2):
            cols = slice(c * half, (c + 1) * half)
            acc = torch.zeros(ctx[:, rows, :, cols].shape)
            for t in range(0, S, CROSS_TILE):
                acc += torch.einsum("bhqk,bkhd->bqhd", p[..., t:t + CROSS_TILE].float(),
                                    v[:, t:t + CROSS_TILE, :, cols].float())
            ctx[:, rows, :, cols] = acc.to(q.dtype)
        row_max[..., rows], row_sum[..., rows] = mx, sm
    return ctx, ((row_max, row_sum) if save else None)


def decoder_cross_bwd_split_plain(q, k, v, bias, row_max, row_sum, dctx):
    """The decomposition of K5's cross backward in plain PyTorch: every
    query of a (b, h) at once; a first pass over the key tiles
    for D = rowsum(bf16(dP) * P) (the halves' alternate key steps apart),
    then per tile dsc = bf16(P (dP - D) / sqrt(dk)), the tile's dK =
    bf16(dsc^T q) and dV = bf16(bf16(P)^T dctx), and dQ summed over the
    tiles in order (fp32) and rounded once.  Same contract as
    ``ttd.decoder_attention_bwd_plain`` with a bias."""
    S, dk = k.shape[1], q.shape[-1]
    cdt = q.dtype
    p = torch.exp(_cross_scores(q, k, bias) - row_max[..., None]) / row_sum[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", dctx.to(cdt), v).float()
    D = _halves(dp * p, S)
    dq = torch.zeros(q.shape)
    dks, dvs = [], []
    for t in range(0, S, CROSS_TILE):
        keys = slice(t, t + CROSS_TILE)
        dsc = (p[..., keys] * (dp[..., keys] - D[..., None]) / math.sqrt(dk)).to(cdt)
        dq += torch.einsum("bhqk,bkhd->bqhd", dsc.float(), k[:, keys].float())
        dks.append(torch.einsum("bhqk,bqhd->bkhd", dsc, q))
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p[..., keys].to(cdt), dctx.to(cdt)))
    return dq.to(cdt), torch.cat(dks, dim=1).to(cdt), torch.cat(dvs, dim=1).to(cdt)


def decoder_cross_bwd_smem(strips: int, slots: int = 2) -> int:
    """Shared memory of K5's cross backward, every query of a (b, h) in one
    block of ``strips`` strips, bytes (``BwdLayout``): the ring of ``slots``
    32-row key and value tile pairs (272 + 528 B a row), q and dctx [16
    strips] rows, bf16 P and dsc [16 strips, 80 B], the row max, sum and D
    halves (fp32 [4, 16 strips]), 2 slots + 1 mbarriers."""
    return slots * 32 * 800 + 16 * strips * (272 + 528 + 2 * 80 + 16) + 8 * (2 * slots + 1)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _operands(B, Q, S, nh, tdt, seed=0):
    """q, k, v in ``tdt``, dctx, and the key bias: the first row's memory
    full, the last row's of length 0 (every key at -1e30), the rest ragged."""
    rng = np.random.default_rng(seed)
    q, k, v, dctx = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(tdt)
                     for s in ((B, Q, nh, DK), (B, S, nh, DK), (B, S, nh, DV), (B, Q, nh, DV)))
    lens = np.array([S] + [int(x) for x in rng.integers(1, S + 1, B - 2)] + [0])
    bias = torch.from_numpy(((1.0 - (np.arange(S)[None, :] < lens[:, None])) * -1e30)
                            .astype(np.float32))
    return q, k, v, bias, dctx


def _close(got, want, dtype, out):
    got, want = (np.asarray(x.float().numpy(), np.float32) for x in (got, want))
    if dtype == "float32":
        if out:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()), rtol=0)
    elif out:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    else:
        np.testing.assert_allclose(got, want, atol=3e-2 * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_forward_matches_the_plain_twin(dtype, shape):
    """ctx and the saved row statistics; the length-0 memory's weights,
    rebuilt from its statistics, are 1/S."""
    B, Q, S, nh = shape
    q, k, v, bias, _ = _operands(B, Q, S, nh, DTYPES[dtype][1])
    ctx_s, (mx_s, sm_s) = decoder_cross_fwd_split_plain(q, k, v, bias, save=True)
    ctx_p, (mx_p, sm_p) = ttd.decoder_attention_fwd_plain(q, k, v, bias, save=True)
    assert ctx_s.dtype == q.dtype and ctx_s.shape == ctx_p.shape
    _close(ctx_s, ctx_p, dtype, out=True)
    np.testing.assert_allclose(mx_s.numpy(), mx_p.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sm_s.numpy(), sm_p.numpy(), rtol=1e-5)
    w = ttd.decoder_attention_weights(q, k, bias, mx_s, sm_s)
    np.testing.assert_allclose(w[-1].numpy(), 1.0 / S, rtol=1e-6)
    assert decoder_cross_fwd_split_plain(q, k, v, bias)[1] is None


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_backward_matches_the_plain_twin(dtype, shape):
    """dq, dk, dv from the same saved statistics; a nonempty memory's padded
    keys get exactly nothing."""
    B, Q, S, nh = shape
    q, k, v, bias, dctx = _operands(B, Q, S, nh, DTYPES[dtype][1], seed=1)
    _, st = ttd.decoder_attention_fwd_plain(q, k, v, bias, save=True)
    got = decoder_cross_bwd_split_plain(q, k, v, bias, *st, dctx)
    want = ttd.decoder_attention_bwd_plain(q, k, v, bias, *st, dctx)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b, dtype, out=False)
    for b in range(B):  # a nonempty memory's padded keys (the empty one's weigh 1/S)
        n = int((bias[b] == 0).sum())
        if n:
            for g in got[1:]:
                assert float(g[b, n:].float().abs().sum()) == 0.0


def _jax_cross(q, k, v, bias, jdt):
    """The reference's cross-attention core lines (transformer_decoder.py
    :366-372), for one memory."""
    cs = jnp.einsum("bqha,bsha->bhqs", q, k).astype(jnp.float32)
    cs = cs / np.sqrt(q.shape[-1]) + bias[:, None, None, :]
    cw = jax.nn.softmax(cs, axis=-1).astype(jdt)
    return jnp.einsum("bhqs,bshd->bqhd", cw, v)


@pytest.mark.parametrize("shape", [(3, 37, 50, 1), (2, 80, 197, 1)], ids=["Q37-S50", "Q80-S197"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_matches_jax_vjp(dtype, shape):
    """ctx, then dq, dk, dv for a random cotangent, against ``jax.vjp`` of the
    reference core; the last row's memory is empty."""
    jdt, tdt = DTYPES[dtype]
    B, Q, S, nh = shape
    q, k, v, bias, dctx = _operands(B, Q, S, nh, tdt, seed=2)
    prim = tuple(jnp.asarray(x.float().numpy()).astype(jdt) for x in (q, k, v))
    jb = jnp.asarray(bias.numpy())
    ctx_j, vjp = jax.vjp(lambda a, b, c: _jax_cross(a, b, c, jb, jdt), *prim)
    g_j = vjp(jnp.asarray(dctx.float().numpy()).astype(jdt))
    ctx_s, st = decoder_cross_fwd_split_plain(q, k, v, bias, save=True)
    _close(ctx_s, torch.from_numpy(np.array(ctx_j.astype(jnp.float32))), dtype, out=True)
    g_s = decoder_cross_bwd_split_plain(q, k, v, bias, *st, dctx)
    for a, b in zip(g_s, g_j):
        _close(a, torch.from_numpy(np.array(b.astype(jnp.float32))), dtype, out=False)


def test_forward_blocks_by_shape():
    """Strips a forward block holds: five at Q = 80 (no warp without a
    query), two blocks of five at Q = 150, fewer where a long memory's
    scores fill the block; every strip count's shared memory fits."""
    assert kernels.decoder_cross_fwd_strips(80, 197) == 5
    assert kernels.decoder_cross_fwd_strips(80, 531) == 5
    assert kernels.decoder_cross_fwd_strips(150, 197) == 5
    assert kernels.decoder_cross_fwd_strips(37, 197) == 3
    assert kernels.decoder_cross_fwd_strips(80, 900) == 3
    for Q in (1, 16, 37, 80, 150, 160):
        for S in (1, 50, 197, 531, 900, 4000):
            ns = kernels.decoder_cross_fwd_strips(Q, S)
            assert 1 <= ns <= 5 and kernels.decoder_cross_fwd_smem(ns, S) <= kernels.SMEM_LIMIT
    for ns in range(1, 11):  # the backward holds all 160 queries
        assert decoder_cross_bwd_smem(ns) <= kernels.SMEM_LIMIT


def test_cross_lengths_the_kernels_take():
    """Each direction on these kernels where they hold the lengths (the
    forward any Q and S <= 5376, the backward Q <= 160 and any S), on the
    streamed tiles past them; lengths under 1 raise with the numbers."""
    for Q, S in ((1, 1), (80, 50), (150, 531), (160, 4000), (200, 197), (400, FWD_MAX_S)):
        assert kernels.decoder_cross_route(Q, S, backward=False) == "resident"
    for Q, S in ((1, FWD_MAX_S + 1), (80, 6000), (200, 20000)):
        assert kernels.decoder_cross_route(Q, S, backward=False) == "stream"
    for Q, S in ((1, 1), (80, 197), (150, 531), (160, 6000), (160, 20000)):
        assert kernels.decoder_cross_route(Q, S, backward=True) == "resident"
    for Q, S in ((161, 1), (200, 197), (400, 6000)):
        assert kernels.decoder_cross_route(Q, S, backward=True) == "stream"
    for Q, S in ((0, 50), (80, 0)):
        for backward in (False, True):
            with pytest.raises(ValueError, match=f"Q={Q} and S={S}"):
                kernels.decoder_cross_route(Q, S, backward=backward)


def test_cross_route_is_shape_only(monkeypatch):
    """The route is read from the lengths alone: it needs no library."""
    def refuse():
        raise AssertionError("the route loaded the library")

    monkeypatch.setattr(kernels, "_load", refuse)
    assert kernels.decoder_cross_route(80, 197, backward=False) == "resident"
    assert kernels.decoder_cross_route(80, 6000, backward=False) == "stream"
    assert kernels.decoder_cross_route(200, 197, backward=True) == "stream"
    assert kernels.attention_family("decoder_cross_attention", DK, DV) == "cross"


@pytest.mark.parametrize("Q,S", [(8, 5), (170, 5), (8, FWD_MAX_S + 1)],
                         ids=["resident", "stream-bwd", "stream-fwd"])
def test_cross_launcher_refuses_cpu_tensors(Q, S):
    """Both cross launchers refuse CPU tensors and count no launch, on
    either route."""
    q, k, v, bias, dctx = _operands(2, Q, S, 1, torch.bfloat16)
    st = (torch.zeros(2, 1, Q), torch.ones(2, 1, Q))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.decoder_attention_fwd(q, k, v, bias, save=True)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.decoder_attention_bwd(q, k, v, bias, *st, dctx)
    assert kernels.LAUNCHES == before
