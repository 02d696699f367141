"""Gradient of the port's LSTM recurrence (K1) against ``avsr_tpu.ops.rnn``.

On CPU tensors ``BiLSTMScanCore`` runs the plain forward and the plain
backward twin ``bilstm_scan_core_bwd_plain`` (a line-for-line translation
of the reference's hand-written ``_bilstm_scan_core_bwd``), not torch's
autodiff of the forward; these tests hold that twin against ``jax.vjp`` of
the JAX custom-VJP core and of ``fused_bilstm_scan`` on the same seeded
numpy inputs, with ragged masks that include a row of length 0.

Tolerances: fp32 at atol 1e-5 / rtol 1e-4 (JAX matmuls at "highest"
precision, only summation order differs).  Under the bf16 policy both
sides round the carries and the dgates to bf16 (2^-8 relative); a value
near a rounding boundary can land one ulp apart after a different
summation order and move what follows by about that much, so gradients
are held at 3e-2 of the largest reference value.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.ops import rnn as jrnn
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.ops import rnn as trnn

DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, atol=3e-2 * float(np.abs(want).max()), rtol=0)


def _core_inputs(seed, T=9, G=2, B=4, H=16, lengths=(9, 5, 1, 0)):
    rng = np.random.default_rng(seed)
    m = (np.arange(T)[:, None] < np.asarray(lengths)[None, :]).astype(np.float32)
    return dict(
        wh=rng.standard_normal((G, H, 4 * H)).astype(np.float32) * 0.3,
        b=rng.standard_normal((G, 4 * H)).astype(np.float32) * 0.1,
        xw=rng.standard_normal((T, G, B, 4 * H)).astype(np.float32),
        mask=np.stack([m, m[::-1]], axis=1),  # backward stream pre-flipped
        h0=rng.standard_normal((G, B, H)).astype(np.float32) * 0.5,
        c0=rng.standard_normal((G, B, H)).astype(np.float32) * 0.5,
        dys=rng.standard_normal((T, G, B, H)).astype(np.float32),
        dhT=rng.standard_normal((G, B, H)).astype(np.float32),
        dcT=rng.standard_normal((G, B, H)).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_core_grads_match_jax_vjp(dtype):
    """dWh, db, dxw, dh0, dc0 of the autograd Function against jax.vjp of
    ``_bilstm_scan_core`` for the same output cotangents."""
    jdt, tdt = DTYPES[dtype]
    d = _core_inputs(0)
    mask_j = jnp.asarray(d["mask"])

    def f(wh, b, xw, h0, c0):
        return jrnn._bilstm_scan_core(wh, b, xw, mask_j, (h0, c0), jdt)

    prim = (jnp.asarray(d["wh"]), jnp.asarray(d["b"]), jnp.asarray(d["xw"]).astype(jdt),
            jnp.asarray(d["h0"]), jnp.asarray(d["c0"]))
    outs_j, vjp = jax.vjp(f, *prim)
    cot = (jnp.asarray(d["dys"]).astype(jdt), jnp.asarray(d["dhT"]), jnp.asarray(d["dcT"]))
    grads_j = vjp(cot)

    ins = [_t(d["wh"]), _t(d["b"]), _t(d["xw"]).to(tdt), _t(d["h0"]), _t(d["c0"])]
    for x in ins:
        x.requires_grad_(True)
    outs_t = trnn.bilstm_scan_core(ins[0], ins[1], ins[2], _t(d["mask"]), ins[3], ins[4], tdt)
    assert outs_t[0].grad_fn is not None
    for a, b in zip(outs_t, outs_j):
        _close(a.detach().float().numpy(), _np(b), dtype)
    grads_t = torch.autograd.grad(
        outs_t, ins, grad_outputs=(_t(d["dys"]).to(tdt), _t(d["dhT"]), _t(d["dcT"])))
    assert grads_t[2].dtype == tdt and grads_t[0].dtype == torch.float32
    for name, a, b in zip(("dwh", "db", "dxw", "dh0", "dc0"), grads_t, grads_j):
        assert tuple(a.shape) == b.shape, name
        _close(a.float().numpy(), _np(b), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_backward_twin_matches_reference_bwd(dtype):
    """The plain twin against the reference's ``_bilstm_scan_core_bwd`` on
    the reference forward's own residuals (the same bf16 carries)."""
    jdt, tdt = DTYPES[dtype]
    d = _core_inputs(1, lengths=(9, 0, 4, 7))
    wh, b = jnp.asarray(d["wh"]), jnp.asarray(d["b"])
    xw, mask = jnp.asarray(d["xw"]).astype(jdt), jnp.asarray(d["mask"])
    init = (jnp.asarray(d["h0"]), jnp.asarray(d["c0"]))
    _, res = jrnn._bilstm_scan_core_fwd(wh, b, xw, mask, init, jdt)
    cot = (jnp.asarray(d["dys"]).astype(jdt), jnp.asarray(d["dhT"]), jnp.asarray(d["dcT"]))
    dwh_j, db_j, dxw_j, _, (dh0_j, dc0_j) = jrnn._bilstm_scan_core_bwd(jdt, res, cot)

    h_res = _t(_np(res[4])).to(tdt)
    c_res = _t(_np(res[5])).to(tdt)
    # the port's forward saves the same residuals
    (_, _, _), (h_res_t, c_res_t) = trnn.bilstm_scan_core_fwd_impl(
        _t(d["wh"]), _t(d["b"]), _t(d["xw"]).to(tdt), _t(d["mask"]), _t(d["h0"]),
        _t(d["c0"]), tdt, save=True)
    _close(h_res_t.float().numpy(), _np(res[4]), dtype)
    _close(c_res_t.float().numpy(), _np(res[5]), dtype)
    out = trnn.bilstm_scan_core_bwd_plain(
        _t(d["wh"]), _t(d["b"]), _t(d["xw"]).to(tdt), _t(d["mask"]), h_res, c_res,
        _t(d["dys"]).to(tdt), _t(d["dhT"]), _t(d["dcT"]), tdt)
    for a, b in zip(out, (dwh_j, db_j, dxw_j, dh0_j, dc0_j)):
        _close(a.float().numpy(), _np(b), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_bilstm_scan_param_grads_match_jax(dtype):
    """Parameter and input gradients through the whole fused layer (input
    projection, time flip, core) against jax.grad of the reference."""
    jdt, tdt = DTYPES[dtype]
    T, B, D, H = 8, 3, 6, 16
    kf, kb = jax.random.split(jax.random.PRNGKey(4))
    pf = jax.tree_util.tree_map(np.asarray, jrnn.lstm_init(kf, D, H))
    pb = jax.tree_util.tree_map(np.asarray, jrnn.lstm_init(kb, D, H))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    mask = (np.arange(T)[:, None] < np.array([8, 3, 0])[None, :]).astype(np.float32)
    w = rng.standard_normal((T, B, 2 * H)).astype(np.float32)

    def loss_j(params, x):
        ys, ((hf, cf), (hb, cb)) = jrnn.fused_bilstm_scan(
            params[0], params[1], x, jnp.asarray(mask), compute_dtype=jdt)
        return (jnp.sum(ys.astype(jnp.float32) * w) + jnp.sum(hf * 0.7) + jnp.sum(cf)
                + jnp.sum(hb * 1.3) + jnp.sum(cb * 0.5))

    g_j = jax.grad(loss_j, argnums=(0, 1))((pf, pb), jnp.asarray(x))
    tf = {k: v.requires_grad_(True) for k, v in convert.from_jax(pf).items()}
    tb = {k: v.requires_grad_(True) for k, v in convert.from_jax(pb).items()}
    xt = _t(x).requires_grad_(True)
    ys, ((hf, cf), (hb, cb)) = trnn.fused_bilstm_scan(tf, tb, xt, _t(mask), tdt)
    loss = (torch.sum(ys.float() * _t(w)) + torch.sum(hf * 0.7) + torch.sum(cf)
            + torch.sum(hb * 1.3) + torch.sum(cb * 0.5))
    loss.backward()
    for tp, jp in ((tf, g_j[0][0]), (tb, g_j[0][1])):
        for k in ("wx", "wh", "b"):
            _close(tp[k].grad.numpy(), _np(jp[k]), dtype)
    _close(xt.grad.numpy(), _np(g_j[1]), dtype)


def test_residuals_are_saved_only_when_a_gradient_is_wanted():
    """Serving (no grad) must not pay for the bf16 carries."""
    d = _core_inputs(2)
    args = [_t(d[k]) for k in ("wh", "b", "xw", "mask", "h0", "c0")]
    calls = []
    real = trnn.scan_core_fwd

    def spy(wh, b, xw, mask, h0, c0, cdt, save):
        calls.append(save)
        return real(wh, b, xw, mask, h0, c0, cdt, save)

    with mock.patch.object(trnn, "scan_core_fwd", spy):
        trnn.bilstm_scan_core(*args, torch.float32)
        args[0].requires_grad_(True)
        with torch.no_grad():
            trnn.bilstm_scan_core(*args, torch.float32)
        out = trnn.bilstm_scan_core(*args, torch.float32)
    assert calls == [False, False, True]
    assert out[0].grad_fn is not None


def test_backward_launcher_rejects_cpu_tensors():
    """The CUDA side of the backward never computes on the CPU: it checks
    the device before building or launching, and counts no launch."""
    T, G, B, H = 2, 2, 1, 16
    bf = torch.bfloat16
    args = (torch.zeros(G, H, 4 * H, dtype=bf), torch.zeros(G, 4 * H),
            torch.zeros(T, G, B, 4 * H, dtype=bf), torch.ones(T, G, B),
            torch.zeros(T, G, B, H, dtype=bf), torch.zeros(T, G, B, H, dtype=bf),
            torch.zeros(T, G, B, H, dtype=bf), torch.zeros(G, B, H), torch.zeros(G, B, H))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.lstm_scan_bwd(*args)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.lstm_scan_fwd(*args[:4], torch.zeros(G, B, H), torch.zeros(G, B, H), save=True)
    assert kernels.LAUNCHES == before


def test_backward_weight_tiling_keeps_every_weight():
    """The backward's dh product reads Wh as [G, H/16, H, 16, 4]: tile t,
    k quad kq, unit u, j holds Wh[g, 16*t + u, 4*kq + j]."""
    G, H = 2, 32
    wh = torch.randn(G, H, 4 * H)
    tiled = kernels.tile_lstm_weights_t(wh)
    assert tuple(tiled.shape) == (G, H // 16, H, 16, 4) and tiled.is_contiguous()
    g, unit, k = torch.meshgrid(torch.arange(G), torch.arange(H), torch.arange(4 * H),
                                indexing="ij")
    torch.testing.assert_close(tiled[g, unit // 16, k // 4, unit % 16, k % 4], wh[g, unit, k],
                               rtol=0, atol=0)
