"""The cluster route of the port's LSTM scan kernels (K1 and K2) on the CPU.

The cluster kernels (``avsr_tpu_torch/csrc/lstm_cluster.cuh``) run only on
the card; here we hold what surrounds them: ``kernels.lstm_family``, which
routes a scan by its shape alone; ``kernels.lstm_cluster_smem``, which the
card's build is checked against; the weight layout the kernels read
(``kernels.cluster_lstm_weights``); the launchers' refusal of CPU tensors;
and the kernels' decomposition itself, written out in plain torch from that
layout (each of the 8 CTAs forms its units' four gates from its slice, and
the backward's dh is the rank-ordered sum of the CTAs' partial products),
against the reference's ``_bilstm_scan_core_fwd_impl`` and
``_bilstm_scan_core_bwd`` in float32 (atol 1e-5 / rtol 1e-4: the same
products, only the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.ops import rnn as jrnn
from avsr_tpu_torch import kernels

C = kernels.LSTM_CLUSTER


@pytest.mark.parametrize("G,B,H,family", [
    (2, 128, 256, "cluster"),  # every preset's BiLSTM layer
    (1, 128, 256, "cluster"),  # K2, the one-direction layer
    (2, 1, 256, "cluster"),
    (1, 3, 128, "cluster"),
    (2, 1000, 384, "cluster"),  # the widest width whose backward fits a CTA
    (2, 8, 192, "cluster"),
    (2, 128, 512, "step"),  # a 256 KB Wh slice per CTA
    (1, 5, 448, "step"),
    (2, 8, 64, "step"),  # 8 units a CTA: one warp, 4-chunk dgates rows
    (2, 8, 96, "step"),  # not a multiple of 64
    (1, 2, 16, "step"),
    (2, 4, 320, "cluster"),
])
def test_lstm_family_routes_by_shape(G, B, H, family):
    assert kernels.lstm_family(G, B, H) == family


@pytest.mark.parametrize("G,B,H", [(2, 4, 8), (2, 4, 100), (0, 4, 256), (2, 0, 256)])
def test_lstm_family_rejects_shapes_no_kernel_takes(G, B, H):
    with pytest.raises(ValueError, match="lstm scan"):
        kernels.lstm_family(G, B, H)


def test_lstm_family_is_a_function_of_the_shape_alone(monkeypatch):
    """The route never depends on the library or on a launch that failed:
    with the library unloadable the answers are the same."""
    shapes = [(G, B, H) for G in (1, 2) for B in (1, 128) for H in range(16, 1025, 16)]
    before = [kernels.lstm_family(*s) for s in shapes]

    def no_library():
        raise RuntimeError("no library")

    monkeypatch.setattr(kernels, "_load", no_library)
    assert [kernels.lstm_family(*s) for s in shapes] == before


def test_cluster_widths_are_those_whose_backward_fits_a_cta():
    """The cluster route takes H = 128..384 in steps of 64: the CTA's shared
    memory (the Wh slice, H*H bytes, and its buffers) is what bounds it, as
    the library's instances (``AVSR_LSTM_CLUSTER_WIDTHS``) assume."""
    cluster = [H for H in range(16, 2049, 16) if kernels.lstm_family(2, 1, H) == "cluster"]
    assert cluster == [128, 192, 256, 320, 384]
    for H in cluster:
        assert kernels.lstm_cluster_smem(H, backward=False) < kernels.lstm_cluster_smem(H, True)
        assert kernels.lstm_cluster_smem(H, backward=True) <= kernels.SMEM_LIMIT
    assert kernels.lstm_cluster_smem(448, backward=True) > kernels.SMEM_LIMIT
    # H = 256: the 64 KB slice and two 8 KB h tiles; the backward's one h_res
    # tile, 4 KB of dgates rows and two 16 KB slots of dh partials; each
    # kernel's two 8-byte mbarriers
    assert kernels.lstm_cluster_smem(256, backward=False) == 65536 + 2 * 8192 + 16
    assert kernels.lstm_cluster_smem(256, backward=True) == 65536 + 8192 + 4096 + 2 * 16384 + 16


@pytest.mark.parametrize("H", [128, 256])
def test_cluster_weight_layout_keeps_every_gate_weight(H):
    """[G, 8, H/64, 4, 8, H]: CTA r, warp w, gate q, unit j, input k holds
    Wh[g, k, q*H + r*H/8 + 8*w + j]; CTA r's slice is one contiguous
    [H/2, H] run whose row n = 32 w + 8 q + j."""
    G, nw = 2, H // 64
    wh = torch.randn(G, H, 4 * H)
    cl = kernels.cluster_lstm_weights(wh)
    assert tuple(cl.shape) == (G, C, nw, 4, 8, H) and cl.is_contiguous()
    g, r, w, q, j, k = torch.meshgrid(*(torch.arange(n) for n in (G, C, nw, 4, 8, H)),
                                      indexing="ij")
    torch.testing.assert_close(cl, wh[g, k, q * H + r * (H // C) + 8 * w + j], rtol=0, atol=0)
    slices = cl.reshape(G, C, H // 2, H)
    n = torch.arange(H // 2)
    for rank in (0, C - 1):
        unit = rank * (H // C) + 8 * (n // 32) + n % 8
        col = (n % 32) // 8 * H + unit
        torch.testing.assert_close(slices[:, rank], wh[:, :, col].transpose(1, 2), rtol=0, atol=0)


@pytest.mark.parametrize("G", [1, 2])
def test_cluster_launchers_reject_cpu_tensors_and_count_nothing(G):
    """At a cluster shape the launchers check the device before building or
    launching anything, and count no launch."""
    T, B, H = 3, 2, 256
    assert kernels.lstm_family(G, B, H) == "cluster"
    bf = torch.bfloat16
    wh, b = torch.zeros(G, H, 4 * H, dtype=bf), torch.zeros(G, 4 * H)
    xw, mask = torch.zeros(T, G, B, 4 * H, dtype=bf), torch.ones(T, G, B)
    state = torch.zeros(G, B, H)
    res = torch.zeros(T, G, B, H, dtype=bf)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.lstm_scan_fwd(wh, b, xw, mask, state, state, save=True)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.lstm_scan_bwd(wh, b, xw, mask, res, res, res, state, state)
    assert kernels.LAUNCHES == before


# ---- the kernels' decomposition in plain torch ------------------------------

def _slice_cols(H):
    """Slice row n of any CTA -> (gate q, unit offset within the CTA)."""
    n = torch.arange(H // 2)
    return (n % 32) // 8, 8 * (n // 32) + n % 8


def _scatter(parts, H):
    """The CTAs' gate columns (slice order, [..., H/2] each) -> [..., 4H]."""
    q, u = _slice_cols(H)
    out = torch.empty(*parts[0].shape[:-1], 4 * H)
    for r, p in enumerate(parts):
        out[..., q * H + r * (H // C) + u] = p
    return out


def _gather(full, H, r):
    """CTA r's gate columns of a [..., 4H] tensor, in slice order."""
    q, u = _slice_cols(H)
    return full[..., q * H + r * (H // C) + u]


def _gates(h, slices, xw_t, b, H):
    """Each CTA's product of the whole h with its resident slice."""
    parts = [torch.einsum("gbk,gnk->gbn", h, slices[:, r]) for r in range(C)]
    return (xw_t + _scatter(parts, H)) + b[:, None]


def _cluster_fwd(wh, b, xw, mask, h0, c0):
    G, H, _ = wh.shape
    slices = kernels.cluster_lstm_weights(wh).reshape(G, C, H // 2, H)
    h, c, ys, h_res, c_res = h0, c0, [], [], []
    for t in range(xw.shape[0]):
        h_res.append(h)
        c_res.append(c)
        i, f, g, o = _gates(h, slices, xw[t], b, H).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t][..., None]
        ys.append(h_new * m)
        h, c = m * h_new + (1 - m) * h, m * c_new + (1 - m) * c
    return torch.stack(ys), h, c, torch.stack(h_res), torch.stack(c_res)


def _cluster_bwd(wh, b, xw, mask, h_res, c_res, dys, dhT, dcT):
    G, H, _ = wh.shape
    B = xw.shape[2]
    slices = kernels.cluster_lstm_weights(wh).reshape(G, C, H // 2, H)
    dh_dir, dc = dhT, dcT
    partial = None  # [C][G, B, H]: each CTA's dh product of the later step
    db_tiles = torch.zeros(G, -(-B // kernels.LSTM_CLUSTER_ROWS), 4 * H)
    dxw = [None] * xw.shape[0]
    for t in reversed(range(xw.shape[0])):
        # reduce-scatter: each owner sums its columns of the 8 partials in rank order
        dh_out = dh_dir if partial is None else sum(partial[1:], partial[0]) + dh_dir
        i, f, g, o = _gates(h_res[t], slices, xw[t], b, H).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c_prev = c_res[t]
        c_new = f * c_prev + i * g
        tc = torch.tanh(c_new)
        m = mask[t][..., None]
        dh_new = (dh_out + dys[t]) * m
        dc_new = dc * m + dh_new * o * (1 - tc * tc)
        dgates = torch.cat([dc_new * g * i * (1 - i), dc_new * c_prev * f * (1 - f),
                            dc_new * i * (1 - g * g), dh_new * tc * o * (1 - o)], dim=-1)
        dh_dir, dc = dh_out * (1 - m), dc_new * f + dc * (1 - m)
        for tile in range(db_tiles.shape[1]):
            rows = slice(tile * kernels.LSTM_CLUSTER_ROWS, (tile + 1) * kernels.LSTM_CLUSTER_ROWS)
            db_tiles[:, tile] += dgates[:, rows].sum(dim=1)
        partial = [torch.einsum("gbn,gnk->gbk", _gather(dgates, H, r), slices[:, r])
                   for r in range(C)]
        dxw[t] = dgates
    dh0 = sum(partial[1:], partial[0]) + dh_dir
    return torch.stack(dxw), db_tiles.sum(dim=1), dh0, dc


def _inputs(seed, T=7, G=2, B=5, H=128, lengths=(7, 0, 3, 6, 1)):
    rng = np.random.default_rng(seed)
    m = (np.arange(T)[:, None] < np.asarray(lengths)[None, :]).astype(np.float32)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return dict(wh=f(G, H, 4 * H, scale=H ** -0.5), b=f(G, 4 * H, scale=0.1),
                xw=f(T, G, B, 4 * H), mask=np.stack([m, m[::-1]], axis=1)[:, :G],
                h0=f(G, B, H, scale=0.5), c0=f(G, B, H, scale=0.5), dys=f(T, G, B, H),
                dhT=f(G, B, H), dcT=f(G, B, H))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("G", [1, 2])
def test_cluster_decomposition_forward_matches_reference(G):
    d = _inputs(G, G=G)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    ys, hT, cT, h_res, c_res = _cluster_fwd(t["wh"], t["b"], t["xw"], t["mask"], t["h0"], t["c0"])
    (ys_j, hT_j, cT_j), (h_res_j, c_res_j) = jrnn._bilstm_scan_core_fwd_impl(
        jnp.asarray(d["wh"]), jnp.asarray(d["b"]), jnp.asarray(d["xw"]), jnp.asarray(d["mask"]),
        (jnp.asarray(d["h0"]), jnp.asarray(d["c0"])), jnp.float32, save=True)
    for a, b in ((ys, ys_j), (hT, hT_j), (cT, cT_j), (h_res, h_res_j), (c_res, c_res_j)):
        _close(a, b)


@pytest.mark.parametrize("G", [1, 2])
def test_cluster_decomposition_backward_matches_reference(G):
    """dgates, db (per 16-row tile, then over tiles), dh0 (the rank-ordered
    partials of step 0 plus dh_direct) and dc0 against the reference's
    reverse scan on its own residuals; a 0-length row passes dhT / dcT
    through unchanged."""
    lengths = (7, 0, 3, 6, 1, 7, 2, 5, 4, 7, 0, 1, 6, 3, 2, 7, 5, 4, 6)  # two row tiles
    d = _inputs(10 + G, G=G, B=len(lengths), lengths=lengths)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    _, res = jrnn._bilstm_scan_core_fwd(j["wh"], j["b"], j["xw"], j["mask"], (j["h0"], j["c0"]),
                                        jnp.float32)
    _, db_j, dxw_j, _, (dh0_j, dc0_j) = jrnn._bilstm_scan_core_bwd(
        jnp.float32, res, (j["dys"], j["dhT"], j["dcT"]))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    h_res, c_res = (torch.from_numpy(np.array(x, np.float32)) for x in res[4:6])
    dxw, db, dh0, dc0 = _cluster_bwd(t["wh"], t["b"], t["xw"], t["mask"], h_res, c_res, t["dys"],
                                     t["dhT"], t["dcT"])
    for a, b in ((dxw, dxw_j), (db, db_j), (dh0, dh0_j), (dc0, dc0_j)):
        _close(a, b)
    assert torch.equal(dh0[:, 1], t["dhT"][:, 1]) and torch.equal(dc0[:, 1], t["dcT"][:, 1])
    assert float(dxw[:, :, 1].abs().max()) == 0.0
