"""The cluster route of the port's GRU scan kernel (K12) on the CPU.

The cluster kernels (``avsr_tpu_torch/csrc/gru_cluster.cuh``) run only on
the card; here we hold what surrounds them: ``kernels.gru_family``, which
routes a scan by its shape alone (the per-step kernels keep H = 80 and the
widths the cluster does not take); ``kernels.gru_cluster_smem``, which the
card's build is checked against; the weight layout the kernels read
(``kernels.cluster_gru_weights``); the launchers' refusal of CPU tensors;
and the kernels' decomposition itself, written out in plain torch
(float32): each of the 8 CTAs forms its units' r, z and n products from its
resident slice of bf16(Wh), hw_n kept apart from x_n; the backward
recomputes the gates from the bf16 carries, forms dhw = [dr, dz, dn r] in
fp32 and sums the CTAs' partial products of dhw split into hi = bf16(dhw)
and lo = bf16(dhw - hi) in rank order, rounded to bf16 once at the end, as
JAX's transpose of the bf16 product rounds it.

The mirror is held against ``avsr_tpu.ops.rnn.gru_scan`` and its
``jax.vjp`` in the bf16 policy at the repository's bf16 tolerance (3e-2 of
the largest reference value; ``_close``), and against the port's plain
twins at chip_smoke's kernel tolerances (``K1_TOL`` on the forward,
``K1B_REL_TOL`` of the largest value on the backward).
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
from test_torch_ln_lstm_cluster import K1_TOL, K1B_REL_TOL, _bf, _ordered_sum, hi_lo_product

C = kernels.LSTM_CLUSTER


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("G,B,H,family", [
    (2, 128, 256, "cluster"),  # every preset's GRU layer
    (1, 128, 256, "cluster"),
    (2, 1, 256, "cluster"),
    (1, 3, 128, "cluster"),
    (2, 1000, 384, "cluster"),  # the widest width whose backward fits a CTA
    (2, 20, 80, "step"),  # chip_smoke's off-multiple width
    (2, 8, 192, "step"),  # 3 H/8 = 72 slice columns: not whole 16-column k-steps
    (2, 8, 320, "step"),
    (1, 5, 448, "step"),
    (2, 128, 512, "step"),  # the backward's CTA past the shared memory
    (2, 8, 64, "step"),
    (1, 2, 16, "step"),
])
def test_gru_family_routes_by_shape(G, B, H, family):
    assert kernels.gru_family(G, B, H) == family


@pytest.mark.parametrize("G,B,H", [(2, 4, 8), (2, 4, 100), (2, 4, 528), (0, 4, 256),
                                   (2, 0, 256)])
def test_gru_family_rejects_shapes_no_kernel_takes(G, B, H):
    with pytest.raises(ValueError, match="gru scan"):
        kernels.gru_family(G, B, H)


def test_gru_family_is_a_function_of_the_shape_alone(monkeypatch):
    """The route never depends on the library or on a launch that failed."""
    shapes = [(G, B, H) for G in (1, 2) for B in (1, 128) for H in range(16, 513, 16)]
    before = [kernels.gru_family(*s) for s in shapes]

    def no_library():
        raise RuntimeError("no library")

    monkeypatch.setattr(kernels, "_load", no_library)
    assert [kernels.gru_family(*s) for s in shapes] == before


def test_gru_cluster_widths_and_shared_memory():
    """The cluster takes H = 128, 256, 384 (the library's
    ``AVSR_GRU_CLUSTER_WIDTHS``); ``gru_cluster_smem`` is the sum of the
    layout's buffers (``gru_cluster.cuh`` ``Shape``)."""
    cluster = [H for H in range(16, 513, 16) if kernels.gru_family(2, 1, H) == "cluster"]
    assert cluster == [128, 256, 384]
    for H in cluster + [512]:
        UR = H // C
        ncol = 3 * UR
        dgp = -(-ncol // 64) * 64
        slice_ = ncol * H * 2
        fwd = slice_ + 2 * 16 * H * 2 + 16
        bwd = slice_ + 16 * H * 2 + 2 * 16 * dgp * 2 + 2 * C * 16 * UR * 4 + 16
        assert kernels.gru_cluster_smem(H, backward=False) == fwd
        assert kernels.gru_cluster_smem(H, backward=True) == bwd
        assert (bwd <= kernels.SMEM_LIMIT) == (H in cluster)
    # H = 256: the 48 KB slice and two 8 KB h tiles; the backward's h_res
    # tile, two 4 KB dhw tiles and two 16 KB slots of dh partials
    assert kernels.gru_cluster_smem(256, backward=False) == 49152 + 16384 + 16
    assert kernels.gru_cluster_smem(256, backward=True) == 49152 + 8192 + 8192 + 32768 + 16


def _cta_cols(H, r):
    """CTA r's gate columns of a [..., 3H] tensor in slice order: row n of
    its slice is gate (n % 24) // 8 of unit r H/8 + 8 (n // 24) + n % 8."""
    n = torch.arange(3 * H // C)
    return (n % 24) // 8 * H + r * (H // C) + 8 * (n // 24) + n % 8


@pytest.mark.parametrize("H", [128, 256, 384])
def test_gru_cluster_weight_layout_keeps_every_gate_weight(H):
    """[G, 8, H/64, 3, 8, H]: CTA r, warp w, gate q, unit j, input k holds
    Wh[g, k, q*H + r*H/8 + 8*w + j]; CTA r's slice is one contiguous [3H/8,
    H] run whose row n = 24 w + 8 q + j, and the 8 slices together hold
    every weight of Wh once."""
    G, nw = 2, H // 64
    wh = torch.randn(G, H, 3 * H)
    cl = kernels.cluster_gru_weights(wh)
    assert tuple(cl.shape) == (G, C, nw, 3, 8, H) and cl.is_contiguous()
    g, r, w, q, j, k = torch.meshgrid(*(torch.arange(n) for n in (G, C, nw, 3, 8, H)),
                                      indexing="ij")
    torch.testing.assert_close(cl, wh[g, k, q * H + r * (H // C) + 8 * w + j], rtol=0, atol=0)
    slices = cl.reshape(G, C, 3 * H // C, H)
    seen = torch.zeros(3 * H, dtype=torch.long)
    for rank in range(C):
        cols = _cta_cols(H, rank)
        seen[cols] += 1
        torch.testing.assert_close(slices[:, rank], wh[:, :, cols].transpose(1, 2), rtol=0,
                                   atol=0)
    assert torch.equal(seen, torch.ones(3 * H, dtype=torch.long))


@pytest.mark.parametrize("G", [1, 2])
def test_gru_cluster_launchers_reject_cpu_tensors_and_count_nothing(G):
    """At a cluster shape the launchers check the device before building or
    launching anything, and count no launch."""
    T, B, H = 3, 2, 256
    assert kernels.gru_family(G, B, H) == "cluster"
    bf = torch.bfloat16
    wh, b = torch.zeros(G, H, 3 * H, dtype=bf), torch.zeros(G, 3 * H)
    xw, mask = torch.zeros(T, G, B, 3 * H, dtype=bf), torch.ones(T, G, B)
    state = torch.zeros(G, B, H)
    res = torch.zeros(T, G, B, H, dtype=bf)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.gru_scan_fwd(wh, b, xw, mask, state, save=True)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.gru_scan_bwd(wh, b, xw, mask, res, res, state)
    assert kernels.LAUNCHES == before


# ---- the decomposition in plain torch ----------------------------------------

def _gates(hp, slices, cols, xw_t, b, H):
    """Each CTA's product of the whole bf16 h with its resident slice: (x_r
    + b_r + hw_r, x_z + b_z + hw_z, x_n + b_n, hw_n)."""
    hw = torch.empty(hp.shape[0], 3 * H)
    for r in range(C):
        hw[:, cols[r]] = hp @ slices[r].T
    x = xw_t + b
    return (x[:, :H] + hw[:, :H], x[:, H:2 * H] + hw[:, H:2 * H], x[:, 2 * H:],
            hw[:, 2 * H:])


def gru_cluster_fwd(wh, b, xw, mask, h0):
    """K12's cluster forward of one direction: wh [H, 3H] (bf16 values), xw
    [T, B, 3H] (bf16 values) -> (ys, hT, h_res)."""
    T, _, H3 = xw.shape
    H = H3 // 3
    slices = kernels.cluster_gru_weights(wh[None])[0].reshape(C, H3 // C, H)
    cols = [_cta_cols(H, r) for r in range(C)]
    h, ys, h_res = h0, [], []
    for t in range(T):
        hp = _bf(h)
        ar, az, xn, hn = _gates(hp, slices, cols, xw[t], b, H)
        rg, zg = torch.sigmoid(ar), torch.sigmoid(az)
        h_new = (1.0 - zg) * torch.tanh(xn + rg * hn) + zg * h
        m = mask[t][:, None]
        ys.append(_bf(h_new * m))
        h_res.append(hp)
        h = m * h_new + (1.0 - m) * h
    return torch.stack(ys), h, torch.stack(h_res)


def gru_cluster_bwd(wh, b, xw, mask, h_res, dys, dhT):
    """K12's cluster backward of one direction -> (dxw, db, dh0, dhw): the
    gates recomputed from h_res with the slices, dhw = [dr, dz, dn r] fp32,
    dh the rank-ordered sum of the CTAs' hi / lo partials rounded to bf16."""
    T, _, H3 = xw.shape
    H = H3 // 3
    slices = kernels.cluster_gru_weights(wh[None])[0].reshape(C, H3 // C, H)
    cols = [_cta_cols(H, r) for r in range(C)]
    d, db = dhT, torch.zeros(H3)
    dxw, dhw = [None] * T, [None] * T
    for t in reversed(range(T)):
        h = h_res[t]
        ar, az, xn, hn = _gates(h, slices, cols, xw[t], b, H)
        rg, zg = torch.sigmoid(ar), torch.sigmoid(az)
        ng = torch.tanh(xn + rg * hn)
        m = mask[t][:, None]
        dh_new = (d + dys[t]) * m
        dhd = d * (1.0 - m) + dh_new * zg
        dn = dh_new * (1.0 - zg) * (1.0 - ng * ng)
        dz = dh_new * (h - ng) * zg * (1.0 - zg)
        dr = dn * hn * rg * (1.0 - rg)
        dx = torch.cat([dr, dz, dn], -1)
        dhw[t] = torch.cat([dr, dz, dn * rg], -1)
        dxw[t] = _bf(dx)
        db = db + dx.sum(0)
        parts = torch.stack([hi_lo_product(dhw[t][:, cols[r]], slices[r]) for r in range(C)], -1)
        d = _bf(_ordered_sum(parts)) + dhd
    return torch.stack(dxw), db, d, torch.stack(dhw)


T, B = 6, 3
LENGTHS = np.array([6, 4, 0])


@pytest.mark.parametrize("H", [128, 256])
def test_gru_cluster_mirror_matches_jax_and_the_twin(H):
    """The cluster decomposition, forward and backward, against the
    reference's ``gru_scan`` (its input product the input: wx = I, x = the
    bf16 values of xw) and its ``jax.vjp`` (bf16 policy, the repository's
    bf16 tolerance), and against the port's plain twins at chip_smoke's
    kernel tolerances; the 0-length row keeps h0 and passes dhT."""
    rng = np.random.default_rng(H)
    params = {"wx": np.eye(3 * H, dtype=np.float32),
              "wh": (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32),
              "b": (0.1 * rng.standard_normal(3 * H)).astype(np.float32)}
    bfv = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    xw = bfv(rng.standard_normal((T, B, 3 * H)))
    mask = (np.arange(T)[:, None] < LENGTHS[None, :]).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    dys = bfv(rng.standard_normal((T, B, H)))
    dhT = rng.standard_normal((B, H)).astype(np.float32)
    assert kernels.gru_family(1, B, H) == "cluster"

    def ref(p, x, h0):
        return jrnn.gru_scan(p, x, jnp.asarray(mask), h0, compute_dtype=jnp.bfloat16)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    outs_j, vjp = jax.vjp(jax.jit(ref), jp, jnp.asarray(xw), jnp.asarray(h0))
    g_j, dx_j, dh0_j = vjp((jnp.asarray(dys, jnp.bfloat16), jnp.asarray(dhT)))

    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    wh = _bf(t(params["wh"]))
    ys, hT, h_res = gru_cluster_fwd(wh, t(params["b"]), t(xw), t(mask), t(h0))
    for got, want, n in zip((ys, hT), outs_j, ("ys", "hT")):
        _close(got.numpy(), np.asarray(want, np.float32), "bfloat16", n)
    dxw, db, dh0, dhw = gru_cluster_bwd(wh, t(params["b"]), t(xw), t(mask), h_res, t(dys),
                                        t(dhT))
    dwh = torch.einsum("tbh,tbk->hk", h_res, dhw)
    for got, want, n in ((dwh, g_j["wh"], "dWh"), (db, g_j["b"], "db"), (dxw, dx_j, "dxw"),
                         (dh0, dh0_j, "dh0")):
        _close(got.numpy(), np.asarray(want, np.float32), "bfloat16", n)
    assert torch.equal(hT[2], t(h0)[2]) and float(ys[:, 2].abs().max()) == 0.0
    assert float(dxw[:, 2].abs().max()) == 0.0 and torch.equal(dh0[2], t(dhT)[2])

    # the port's plain twins on the same operands (G = 1)
    bf = torch.bfloat16
    a = (t(params["wh"])[None], t(params["b"])[None], t(xw)[:, None].to(bf), t(mask)[:, None])
    (ys_p, hT_p), h_res_p = trnn.gru_scan_core_fwd_plain(*a, t(h0)[None], bf, True)
    for got, want in ((ys, ys_p[:, 0]), (hT, hT_p[0]), (h_res, h_res_p[:, 0])):
        assert float((got - want.float()).abs().max()) <= K1_TOL
    g_p = trnn.gru_scan_core_bwd_plain(*a, h_res_p, t(dys)[:, None].to(bf), t(dhT)[None], bf)
    for got, want in zip((dwh, db, dxw, dh0), (g_p[0][0], g_p[1][0], g_p[2][:, 0], g_p[3][0])):
        want = want.float()
        assert float((got - want).abs().max()) <= K1B_REL_TOL * float(want.abs().max())
