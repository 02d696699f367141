"""The cluster route of the port's LN-LSTM scan kernel (K13) on the CPU.

The cluster kernels (``avsr_tpu_torch/csrc/ln_lstm_cluster.cuh``) run only
on the card; here we hold what surrounds them: ``kernels.ln_lstm_family``,
which routes a scan by its shape alone (the block kernel keeps H = 80 and
the widths past the cluster's); ``kernels.ln_lstm_cluster_smem``, which the
card's build is checked against; the weight layout the kernels read (K1's
``cluster_lstm_weights``); the launchers' refusal of CPU tensors; and the
kernels' decomposition itself, written out in plain torch (float32):

- each of the 8 CTAs forms its units' four gate columns from its resident
  slice of bf16(Wh);
- each LayerNorm's statistics are merged as the kernels merge them: a
  warp's (mean, M2) of its 8 units by the two-pass form (a quad's
  butterflies), the CTA's warps and then the 8 CTAs in rank order by Chan's
  formula for equal counts (one exchange a statistics round);
- the backward's LN sums go warp, CTA, then the CTAs in rank order;
- the backward's dh is the rank-ordered sum of the CTAs' partial products
  of dz split into hi = bf16(dz) and lo = bf16(dz - hi) (the fp32 operand
  kept to 16 bits), rounded to bf16 once at the end, as JAX's transpose of
  the bf16 product rounds it.

The mirror is held against ``avsr_tpu.ops.rnn.lstm_scan`` with LN cells
(``jax.vjp`` for the backward) in the bf16 policy at the repository's bf16
tolerance (3e-2 of the largest reference value; ``_close``), and against
the port's plain twins at chip_smoke's kernel tolerances (``K1_TOL`` on the
forward, ``K1B_REL_TOL`` of the largest value on the backward).  The
statistics merge is held against ``jnp.var`` (rtol 1e-5) and the hi / lo
product against JAX's dot of an fp32 operand with a bf16 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.ops import rnn as jrnn
from avsr_tpu_torch import kernels
from avsr_tpu_torch.ops import rnn as trnn
from test_torch_encoder_options import _close

C = kernels.LSTM_CLUSTER
EPS = 1e-5
K1_TOL = 2e-2       # chip_smoke's: bf16 outputs and fp32 states, kernel against twin
K1B_REL_TOL = 2e-2  # chip_smoke's: the backward, relative to the largest twin value


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---- routing, shared memory, layout, launchers ------------------------------

@pytest.mark.parametrize("G,B,H,family", [
    (2, 128, 256, "cluster"),  # every preset's LN-LSTM layer
    (1, 128, 256, "cluster"),
    (2, 1, 256, "cluster"),
    (1, 3, 128, "cluster"),
    (2, 8, 192, "cluster"),
    (2, 4, 320, "cluster"),
    (2, 1000, 384, "cluster"),  # the widest width whose backward fits a CTA
    (2, 20, 80, "block"),  # chip_smoke's off-multiple width
    (1, 5, 448, "block"),  # past the CTA's shared memory
    (2, 128, 512, "block"),
    (2, 8, 64, "block"),  # 8 units a CTA: one warp
    (2, 8, 96, "block"),  # not a multiple of 64
    (1, 2, 4, "block"),
])
def test_ln_lstm_family_routes_by_shape(G, B, H, family):
    assert kernels.ln_lstm_family(G, B, H) == family


@pytest.mark.parametrize("G,B,H", [(2, 4, 2), (2, 4, 514), (2, 4, 130), (0, 4, 256),
                                   (2, 0, 256)])
def test_ln_lstm_family_rejects_shapes_no_kernel_takes(G, B, H):
    with pytest.raises(ValueError, match="ln_lstm scan"):
        kernels.ln_lstm_family(G, B, H)


def test_ln_lstm_family_is_a_function_of_the_shape_alone(monkeypatch):
    """The route never depends on the library or on a launch that failed."""
    shapes = [(G, B, H) for G in (1, 2) for B in (1, 128) for H in range(4, 513, 4)]
    before = [kernels.ln_lstm_family(*s) for s in shapes]

    def no_library():
        raise RuntimeError("no library")

    monkeypatch.setattr(kernels, "_load", no_library)
    assert [kernels.ln_lstm_family(*s) for s in shapes] == before


def test_ln_cluster_widths_and_shared_memory():
    """The cluster takes H = 128..384 in steps of 64 (the library's
    ``AVSR_LN_LSTM_CLUSTER_WIDTHS``); ``ln_lstm_cluster_smem`` is the sum of
    the layout's buffers (``ln_lstm_cluster.cuh`` ``Shape``)."""
    cluster = [H for H in range(4, 513, 4) if kernels.ln_lstm_family(2, 1, H) == "cluster"]
    assert cluster == [128, 192, 256, 320, 384]
    for H in cluster + [448]:
        UR, NW = H // C, H // 64
        ncol = 4 * UR
        dgp = -(-ncol // 64) * 64
        slice_ = ncol * H * 2
        stat = NW * 16 * 4 * 8 + NW * 16 * 8 + C * 16 * 4 * 8 + C * 16 * 8 + 4 * 8
        fwd = slice_ + 2 * 16 * H * 2 + stat
        bwd = slice_ + 2 * 16 * dgp * 2 + 2 * C * 16 * UR * 4 + stat
        assert kernels.ln_lstm_cluster_smem(H, backward=False) == fwd
        assert kernels.ln_lstm_cluster_smem(H, backward=True) == bwd
        assert (bwd <= kernels.SMEM_LIMIT) == (H in cluster)
    # H = 256: the 64 KB slice, two 8 KB h tiles (fwd) or the two 4 KB dz
    # tiles and two 16 KB slots of dh partials (bwd), 7.5 KB of statistics
    assert kernels.ln_lstm_cluster_smem(256, backward=False) == 89632
    assert kernels.ln_lstm_cluster_smem(256, backward=True) == 114208


@pytest.mark.parametrize("H", [128, 192, 384])
def test_ln_cluster_weight_layout_keeps_every_gate_weight(H):
    """K13's CTAs read K1's layout: CTA r's slice row n holds gate (n % 32)
    // 8 of unit r H/8 + 8 (n // 32) + n % 8, over all H inputs, and the 8
    slices together hold every weight of Wh once."""
    G = 2
    wh = torch.randn(G, H, 4 * H)
    sl = kernels.cluster_lstm_weights(wh).reshape(G, C, H // 2, H)
    seen = torch.zeros(4 * H, dtype=torch.long)
    for r in range(C):
        cols = _cta_cols(H, r)
        seen[cols] += 1
        torch.testing.assert_close(sl[:, r], wh[:, :, cols].transpose(1, 2), rtol=0, atol=0)
    assert torch.equal(seen, torch.ones(4 * H, dtype=torch.long))


@pytest.mark.parametrize("rd", [False, True], ids=["plain", "rd"])
@pytest.mark.parametrize("G", [1, 2])
def test_ln_cluster_launchers_reject_cpu_tensors_and_count_nothing(G, rd):
    """At a cluster shape the launchers check the device before building or
    launching anything, and count no launch."""
    T, B, H = 3, 2, 256
    assert kernels.ln_lstm_family(G, B, H) == "cluster"
    bf = torch.bfloat16
    wh, b4 = torch.zeros(G, H, 4 * H, dtype=bf), torch.zeros(G, 4 * H)
    b1 = torch.zeros(G, H)
    xw, mask = torch.zeros(T, G, B, 4 * H, dtype=bf), torch.ones(T, G, B)
    state = torch.zeros(G, B, H)
    mask_rd = torch.ones(G, B, H) if rd else None
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.ln_lstm_scan_fwd(wh, b4, b4, b1, b1, xw, mask, state, state, save=True,
                                 rd=mask_rd)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.ln_lstm_scan_bwd(wh, b4, b4, b1, b1, mask, torch.zeros(T, G, B, H),
                                 torch.zeros(T, G, B, 4 * H), torch.zeros(T, G, B, H, dtype=bf),
                                 state, state, rd=mask_rd)
    assert kernels.LAUNCHES == before


# ---- the decomposition in plain torch ----------------------------------------

def _bf(x):
    return x.to(torch.bfloat16).float()


def _cta_cols(H, r):
    """CTA r's gate columns of a [..., 4H] tensor in slice order: row n of
    its slice is gate (n % 32) // 8 of unit r H/8 + 8 (n // 32) + n % 8."""
    n = torch.arange(H // 2)
    return (n % 32) // 8 * H + r * (H // C) + 8 * (n // 32) + n % 8


def _ordered_sum(x):
    """Sum over the last axis, one term after another (a CTA's merge of its
    warps' partials, or of the 8 CTAs' in rank order)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _by_warp(v, H):
    """[..., H] -> [..., C, NW, 4, 2]: unit r H/8 + 8 w + 2 tig + j held by
    CTA r, warp w, quad lane tig, as its j-th value."""
    return v.reshape(*v.shape[:-1], C, H // 64, 4, 2)


def _quad(v):
    """A warp's sum of its 8 units: each thread's pair, then the quad's
    butterfly ((t0 + t1) + (t2 + t3)); [..., 4, 2] -> [...]."""
    t = v[..., 0] + v[..., 1]
    return (t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3])


def _chan(mean, m2, n):
    """Chan's merge of partials of n values each, in order along the last
    axis: mean = sum(mean_i) / k, M2 = sum(M2_i + n (mean_i - mean)^2)."""
    mu = _ordered_sum(mean) / mean.shape[-1]
    acc = torch.zeros_like(mu)
    for i in range(mean.shape[-1]):
        d = mean[..., i] - mu
        acc = acc + (m2[..., i] + n * (d * d))
    return mu, acc


def cluster_row_stats(v, H):
    """(mean, rstd) of each row of v [..., H] as the cluster merges them."""
    w = _by_warp(v, H)
    mean_w = _quad(w) * 0.125
    d = w - mean_w[..., None, None]
    m2_w = _quad(d * d)
    mean_c, m2_c = _chan(mean_w, m2_w, 8.0)
    mean, m2 = _chan(mean_c, m2_c, float(H // C))
    return mean, torch.rsqrt(m2 / H + EPS)


def cluster_row_sums(v, H):
    """Each row's sum of v [..., H]: warps, then the CTA's warps in order,
    then the 8 CTAs in rank order."""
    return _ordered_sum(_ordered_sum(_quad(_by_warp(v, H))))


def hi_lo_product(x, w):
    """x [.., K] fp32 times w [K, N] (bf16 values) as the cluster backwards
    form it: two bf16 operands hi = bf16(x) and lo = bf16(x - hi) into one
    fp32 sum."""
    hi = _bf(x)
    return hi @ w + _bf(x - hi) @ w


def ln_cluster_fwd(wh, b, lng, lncg, lncb, xw, mask, h0, c0, rd=None):
    """K13's cluster forward of one direction: wh [H, 4H] (bf16 values), xw
    [T, B, 4H] (bf16 values), mask [T, B], h0 / c0 [B, H] -> (ys, hT, cT,
    h_res, c_res, z) as the kernel writes them."""
    T, B, H4 = xw.shape
    H = H4 // 4
    slices = kernels.cluster_lstm_weights(wh[None])[0].reshape(C, H // 2, H)
    cols = [_cta_cols(H, r) for r in range(C)]
    h, c = h0, c0
    out = {k: [] for k in ("ys", "h_res", "c_res", "z")}
    for t in range(T):
        hp = _bf(h if rd is None else h * rd)
        z = torch.empty(B, H4)
        for r in range(C):
            z[:, cols[r]] = xw[t][:, cols[r]] + hp @ slices[r].T
        zb = z.reshape(B, 4, H)
        gm, gr = cluster_row_stats(zb, H)
        a = (zb - gm[..., None]) * gr[..., None] * lng.reshape(4, H) + b.reshape(4, H)
        i, f, o = torch.sigmoid(a[:, 0]), torch.sigmoid(a[:, 1]), torch.sigmoid(a[:, 3])
        c_new = f * c + i * torch.tanh(a[:, 2])
        cm, cr = cluster_row_stats(c_new, H)
        h_new = o * torch.tanh((c_new - cm[:, None]) * cr[:, None] * lncg + lncb)
        m = mask[t][:, None]
        out["ys"].append(_bf(h_new * m))
        out["h_res"].append(hp)
        out["c_res"].append(c)
        out["z"].append(z)
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
    st = {k: torch.stack(x) for k, x in out.items()}
    return st["ys"], h, c, st["h_res"], st["c_res"], st["z"]


def ln_cluster_bwd(wh, b, lng, lncg, lncb, mask, c_res, z, dys, dhT, dcT, rd=None):
    """K13's cluster backward of one direction: the steps' row statistics
    by the statistics launch (two passes over each row), the reverse scan
    with the cluster's LN sums and the hi / lo dh partials summed in rank
    order -> (dxw, db, dln_gamma, dln_cell_gamma, dln_cell_beta, dh0,
    dc0)."""
    T, B, H4 = z.shape
    H = H4 // 4
    slices = kernels.cluster_lstm_weights(wh[None])[0].reshape(C, H // 2, H)
    cols = [_cta_cols(H, r) for r in range(C)]
    lng4, b4 = lng.reshape(4, H), b.reshape(4, H)

    def two_pass(v):
        mean = v.sum(-1) / H
        d = v - mean[..., None]
        return mean, torch.rsqrt((d * d).sum(-1) / H + EPS)

    dh, dc = dhT, dcT
    db, dlng = torch.zeros(4, H), torch.zeros(4, H)
    dlncg, dlncb = torch.zeros(H), torch.zeros(H)
    dxw = [None] * T
    for t in reversed(range(T)):
        zb, cp = z[t].reshape(B, 4, H), c_res[t]
        gm, gr = two_pass(zb)
        gn = (zb - gm[..., None]) * gr[..., None]
        a = gn * lng4 + b4
        i, f, g, o = (torch.sigmoid(a[:, 0]), torch.sigmoid(a[:, 1]), torch.tanh(a[:, 2]),
                      torch.sigmoid(a[:, 3]))
        c_new = f * cp + i * g
        cm, cr = two_pass(c_new)
        cnh = (c_new - cm[:, None]) * cr[:, None]
        tc = torch.tanh(cnh * lncg + lncb)
        m = mask[t][:, None]
        dh_new = (dh + dys[t]) * m
        dhd = dh * (1.0 - m)
        d_o = dh_new * tc
        dcf = dh_new * o * (1.0 - tc * tc)
        dlncg = dlncg + (dcf * cnh).sum(0)
        dlncb = dlncb + dcf.sum(0)
        y = dcf * lncg
        s1, s2 = cluster_row_sums(y, H) / H, cluster_row_sums(y * cnh, H) / H
        dc_new = dc * m + cr[:, None] * (y - s1[:, None] - cnh * s2[:, None])
        dpre = torch.stack([dc_new * g * i * (1.0 - i), dc_new * cp * f * (1.0 - f),
                            dc_new * i * (1.0 - g * g), d_o * o * (1.0 - o)], dim=1)
        dc = dc_new * f + dc * (1.0 - m)
        db = db + dpre.sum(0)
        dlng = dlng + (dpre * gn).sum(0)
        y = dpre * lng4
        s1, s2 = cluster_row_sums(y, H) / H, cluster_row_sums(y * gn, H) / H
        dz = (gr[..., None] * (y - s1[..., None] - gn * s2[..., None])).reshape(B, H4)
        dxw[t] = _bf(dz)
        parts = torch.stack([hi_lo_product(dz[:, cols[r]], slices[r]) for r in range(C)], -1)
        dh_rec = _bf(_ordered_sum(parts))
        dh = (dh_rec if rd is None else dh_rec * rd) + dhd
    return torch.stack(dxw), db.reshape(-1), dlng.reshape(-1), dlncg, dlncb, dh, dc


# ---- the mirror's pieces against JAX ------------------------------------------

@pytest.mark.parametrize("H", [128, 192, 256, 384])
@pytest.mark.parametrize("offset", [0.0, 30.0])
def test_cluster_statistics_merge_matches_jnp_var(H, offset):
    """The cluster's (mean, rstd): warps' two-pass partials merged by Chan's
    formula, CTAs in rank order, against jnp.mean / jnp.var's two passes
    (rtol 1e-5), also on rows far off zero, where the one-pass E[x^2] -
    E[x]^2 in fp32 loses the variance."""
    rng = np.random.default_rng(H + int(offset))
    x = (offset + rng.standard_normal((64, H)) * rng.uniform(0.1, 3.0, (64, 1)))
    x = x.astype(np.float32)
    mean, rstd = cluster_row_stats(torch.from_numpy(x), H)
    jm = np.asarray(jnp.mean(x, axis=-1))
    jr = np.asarray(jax.lax.rsqrt(jnp.var(x, axis=-1) + EPS))
    np.testing.assert_allclose(mean.numpy(), jm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), jr, rtol=1e-5)
    if offset:
        xt = torch.from_numpy(x)
        naive = (xt * xt).mean(-1) - xt.mean(-1) ** 2
        assert float(((naive - torch.from_numpy(np.var(x.astype(np.float64), axis=-1))).abs()
                      / torch.from_numpy(np.var(x.astype(np.float64), axis=-1))).max()) > 1e-3


def test_cluster_row_sums_are_the_row_sums():
    """The backward's LN sums: warps, CTAs, then ranks in order, equal to the
    row's sum up to fp32 rounding."""
    rng = np.random.default_rng(7)
    for H in (128, 256, 320):
        x = rng.standard_normal((32, H)).astype(np.float32)
        np.testing.assert_allclose(cluster_row_sums(torch.from_numpy(x), H).numpy(),
                                   x.astype(np.float64).sum(-1), rtol=1e-5, atol=1e-5)


def test_hi_lo_product_keeps_the_fp32_operand():
    """The backward's dh product of an fp32 cotangent with bf16(Wh) as hi and
    lo bf16 operands: within 2^-15 of the exact product's magnitude (|x| .
    |w|), where bf16(x) alone is not; rounded to bf16 it is JAX's dot of the
    fp32 operand with the bf16 one, rounded once, in all but rare ties (at
    most one bf16 ulp apart)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((16, 128)) * 10.0 ** rng.uniform(-3, 1, (16, 1))).astype(np.float32)
    w = _bf(torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32)))
    xt = torch.from_numpy(x)
    exact = xt.double() @ w.double()
    scale = xt.double().abs() @ w.double().abs()
    got = hi_lo_product(xt, w)
    assert float(((got.double() - exact).abs() / scale).max()) < 2.0 ** -15
    assert float(((_bf(xt).double() @ w.double() - exact).abs() / scale).max()) > 2.0 ** -12
    want = jnp.dot(jnp.asarray(x), jnp.asarray(w.numpy()).astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    mine = _bf(got)
    differ = mine != want
    assert float(differ.float().mean()) < 0.01
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert bool(((mine - want).abs() <= ulp)[differ].all())


# ---- the whole scan against the reference ---------------------------------------

T, B = 6, 3
LENGTHS = np.array([6, 4, 0])  # a ragged batch with a row of length 0


def _ln_case(H, seed, rd):
    """A one-direction LN-LSTM layer whose input product is its input: wx =
    I, x = the bf16 values of xw (exact through the reference's bf16
    projection)."""
    rng = np.random.default_rng(seed)
    params = {
        "wx": np.eye(4 * H, dtype=np.float32),
        "wh": (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32),
        "b": (0.1 * rng.standard_normal(4 * H)).astype(np.float32),
        "ln_gamma": (1 + 0.2 * rng.standard_normal(4 * H)).astype(np.float32),
        "ln_cell_gamma": (1 + 0.2 * rng.standard_normal(H)).astype(np.float32),
        "ln_cell_beta": (0.2 * rng.standard_normal(H)).astype(np.float32),
    }
    xw = np.asarray(jnp.asarray(rng.standard_normal((T, B, 4 * H)), jnp.bfloat16)
                    .astype(jnp.float32))
    mask = (np.arange(T)[:, None] < LENGTHS[None, :]).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    c0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    rdm = ((rng.uniform(size=(B, H)) < 0.8) / 0.8).astype(np.float32) if rd else None
    cot = (np.asarray(jnp.asarray(rng.standard_normal((T, B, H)), jnp.bfloat16)
                      .astype(jnp.float32)),
           rng.standard_normal((B, H)).astype(np.float32),
           rng.standard_normal((B, H)).astype(np.float32))
    return params, xw, mask, h0, c0, rdm, cot


@pytest.mark.parametrize("rd", [False, True], ids=["plain", "rd"])
@pytest.mark.parametrize("H", [128, 192])
def test_ln_cluster_mirror_matches_jax_and_the_twin(H, rd):
    """The cluster decomposition, forward and backward, against the
    reference's LN ``lstm_scan`` and its ``jax.vjp`` (bf16 policy, the
    repository's bf16 tolerance), and against the port's plain twins at
    chip_smoke's kernel tolerances; the 0-length row keeps (h0, c0) and
    passes (dhT, dcT)."""
    params, xw, mask, h0, c0, rdm, (dys, dhT, dcT) = _ln_case(H, H + rd, rd)
    assert kernels.ln_lstm_family(1, B, H) == "cluster"

    def ref(p, x, h0, c0):
        ys, (hT, cT) = jrnn.lstm_scan(p, x, jnp.asarray(mask), (h0, c0),
                                      compute_dtype=jnp.bfloat16,
                                      recurrent_dropout_mask=None if rdm is None
                                      else jnp.asarray(rdm))
        return ys, hT, cT

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    outs_j, vjp = jax.vjp(jax.jit(ref), jp, jnp.asarray(xw), jnp.asarray(h0), jnp.asarray(c0))
    g_j, dx_j, dh0_j, dc0_j = vjp((jnp.asarray(dys, jnp.bfloat16), jnp.asarray(dhT),
                                   jnp.asarray(dcT)))

    t = lambda a: None if a is None else torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    wh = _bf(t(params["wh"]))
    p = [t(params[k]) for k in ("b", "ln_gamma", "ln_cell_gamma", "ln_cell_beta")]
    ys, hT, cT, h_res, c_res, z = ln_cluster_fwd(wh, *p, t(xw), t(mask), t(h0), t(c0), t(rdm))
    for got, want, n in zip((ys, hT, cT), outs_j, ("ys", "hT", "cT")):
        _close(got.numpy(), np.asarray(want, np.float32), "bfloat16", n)
    dxw, db, dlng, dlncg, dlncb, dh0, dc0 = ln_cluster_bwd(
        wh, *p, t(mask), c_res, z, t(dys), t(dhT), t(dcT), t(rdm))
    dwh = torch.einsum("tbh,tbk->hk", h_res, dxw)
    for got, want, n in ((dwh, g_j["wh"], "dWh"), (db, g_j["b"], "db"),
                         (dlng, g_j["ln_gamma"], "dln_gamma"),
                         (dlncg, g_j["ln_cell_gamma"], "dln_cell_gamma"),
                         (dlncb, g_j["ln_cell_beta"], "dln_cell_beta"), (dxw, dx_j, "dxw"),
                         (dh0, dh0_j, "dh0"), (dc0, dc0_j, "dc0")):
        _close(got.numpy(), np.asarray(want, np.float32), "bfloat16", n)
    assert torch.equal(hT[2], t(h0)[2]) and torch.equal(cT[2], t(c0)[2])
    assert float(ys[:, 2].abs().max()) == 0.0 and float(dxw[:, 2].abs().max()) == 0.0
    assert torch.equal(dh0[2], t(dhT)[2]) and torch.equal(dc0[2], t(dcT)[2])

    # the port's plain twins on the same operands (G = 1)
    bf = torch.bfloat16
    tw = [t(params["wh"])[None], *(x[None] for x in p)]
    (ys_p, hT_p, cT_p), res_p = trnn.ln_lstm_scan_core_fwd_plain(
        *tw, t(xw)[:, None].to(bf), t(mask)[:, None], t(h0)[None], t(c0)[None], bf, True,
        None if rdm is None else t(rdm)[None])
    for got, want in ((ys, ys_p[:, 0]), (hT, hT_p[0]), (cT, cT_p[0]), (z, res_p[2][:, 0])):
        assert float((got - want.float()).abs().max()) <= K1_TOL
    g_p = trnn.ln_lstm_scan_core_bwd_plain(
        *tw, t(mask)[:, None], *res_p, t(dys)[:, None].to(bf), t(dhT)[None], t(dcT)[None], bf,
        None if rdm is None else t(rdm)[None])
    for got, want in zip((dwh, db, dlng, dlncg, dlncb, dxw, dh0, dc0),
                         (g_p[0][0], *(x[0] for x in g_p[1:5]), g_p[5][:, 0], g_p[6][0],
                          g_p[7][0])):
        want = want.float()
        assert float((got - want).abs().max()) <= K1B_REL_TOL * float(want.abs().max())
