"""The port's one-direction LSTM (K2: ``ops/rnn.py`` ``lstm_scan`` over
K1's core at G = 1) and the unidirectional encoder stack against
``avsr_tpu.ops.rnn`` and ``avsr_tpu.models.encoder``.

On CPU tensors ``BiLSTMScanCore`` runs the plain forward
``bilstm_scan_core_fwd_impl`` and the plain backward twin
``bilstm_scan_core_bwd_plain``; at G = 1 they must compute what the
reference's one-direction custom-VJP core ``_lstm_scan_core`` computes,
forward and backward, with a given nonzero initial state and a row of
length 0 (which returns h0 and c0 unchanged and emits zeros).

Inputs come from seeded numpy.  Tolerances: fp32 at atol 1e-5 / rtol 1e-4
(only summation order differs); under the bf16 policy both sides round
the carries, the outputs and the dgates to bf16 (2^-8 relative), and a
value near a rounding boundary can land one ulp apart after a different
summation order and move what follows by about that much, so values are
held at 3e-2 of the largest reference value (the K1 tests' bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import EncoderConfig
from avsr_tpu.models import encoder as jenc
from avsr_tpu.ops import rnn as jrnn
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.configs import EncoderConfig as TEncoderConfig
from avsr_tpu_torch.models import encoder as tenc
from avsr_tpu_torch.ops import rnn as trnn

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, atol=3e-2 * float(np.abs(want).max()), rtol=0)


def _core_inputs(seed, T=9, B=4, H=16, lengths=(9, 5, 0, 2)):
    """One direction's operands: [T, B, 4H] inputs, a ragged mask with a
    row of length 0, a nonzero initial state and output cotangents."""
    rng = np.random.default_rng(seed)
    return dict(
        wh=rng.standard_normal((H, 4 * H)).astype(np.float32) * 0.3,
        b=rng.standard_normal((4 * H,)).astype(np.float32) * 0.1,
        xw=rng.standard_normal((T, B, 4 * H)).astype(np.float32),
        mask=(np.arange(T)[:, None] < np.asarray(lengths)[None, :]).astype(np.float32),
        h0=rng.standard_normal((B, H)).astype(np.float32) * 0.5,
        c0=rng.standard_normal((B, H)).astype(np.float32) * 0.5,
        dys=rng.standard_normal((T, B, H)).astype(np.float32),
        dhT=rng.standard_normal((B, H)).astype(np.float32),
        dcT=rng.standard_normal((B, H)).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_uni_core_matches_jax_vjp(dtype):
    """The core at G = 1 through ``BiLSTMScanCore`` against ``jax.vjp`` of
    ``_lstm_scan_core``: (ys, hT, cT) and dWh, db, dxw, dh0, dc0."""
    jdt, tdt = DTYPES[dtype]
    d = _core_inputs(0)
    mask_j = jnp.asarray(d["mask"])

    def f(wh, b, xw, h0, c0):
        return jrnn._lstm_scan_core(wh, b, xw, mask_j, (h0, c0), jdt)

    outs_j, vjp = jax.vjp(f, jnp.asarray(d["wh"]), jnp.asarray(d["b"]),
                          jnp.asarray(d["xw"]).astype(jdt), jnp.asarray(d["h0"]),
                          jnp.asarray(d["c0"]))
    grads_j = vjp((jnp.asarray(d["dys"]).astype(jdt), jnp.asarray(d["dhT"]),
                   jnp.asarray(d["dcT"])))

    ins = [_t(d["wh"])[None], _t(d["b"])[None], _t(d["xw"]).to(tdt)[:, None],
           _t(d["h0"])[None], _t(d["c0"])[None]]
    for x in ins:
        x.requires_grad_(True)
    outs_t = trnn.bilstm_scan_core(ins[0], ins[1], ins[2], _t(d["mask"])[:, None], ins[3],
                                   ins[4], tdt)
    assert "BiLSTMScanCore" in type(outs_t[0].grad_fn).__name__
    for a, b in zip((outs_t[0][:, 0], outs_t[1][0], outs_t[2][0]), outs_j):
        _close(a.detach().float().numpy(), _np(b), dtype)
    # the length-0 row returns the given initial state and emits zeros
    assert torch.equal(outs_t[1][0, 2], _t(d["h0"])[2])
    assert torch.equal(outs_t[2][0, 2], _t(d["c0"])[2])
    assert float(outs_t[0].detach()[:, 0, 2].abs().max()) == 0.0
    grads_t = torch.autograd.grad(
        outs_t, ins, grad_outputs=(_t(d["dys"]).to(tdt)[:, None], _t(d["dhT"])[None],
                                   _t(d["dcT"])[None]))
    for name, a, b in zip(("dwh", "db", "dxw", "dh0", "dc0"), grads_t, grads_j):
        a = a[:, 0] if name == "dxw" else a[0]
        assert tuple(a.shape) == b.shape, name
        _close(a.float().numpy(), _np(b), dtype)
    # the length-0 row's initial state takes its final cotangents unchanged
    assert torch.equal(grads_t[3][0, 2], _t(d["dhT"])[2])
    assert torch.equal(grads_t[4][0, 2], _t(d["dcT"])[2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_uni_backward_twin_matches_reference_bwd(dtype):
    """The plain twins at G = 1 against the reference's
    ``_lstm_scan_core_fwd`` residuals and ``_lstm_scan_core_bwd``."""
    jdt, tdt = DTYPES[dtype]
    d = _core_inputs(1, lengths=(9, 0, 4, 7))
    init = (jnp.asarray(d["h0"]), jnp.asarray(d["c0"]))
    _, res = jrnn._lstm_scan_core_fwd(jnp.asarray(d["wh"]), jnp.asarray(d["b"]),
                                      jnp.asarray(d["xw"]).astype(jdt), jnp.asarray(d["mask"]),
                                      init, jdt)
    cot = (jnp.asarray(d["dys"]).astype(jdt), jnp.asarray(d["dhT"]), jnp.asarray(d["dcT"]))
    dwh_j, db_j, dxw_j, _, (dh0_j, dc0_j) = jrnn._lstm_scan_core_bwd(jdt, res, cot)
    args = (_t(d["wh"])[None], _t(d["b"])[None], _t(d["xw"]).to(tdt)[:, None],
            _t(d["mask"])[:, None])
    _, (h_res, c_res) = trnn.bilstm_scan_core_fwd_impl(
        *args, _t(d["h0"])[None], _t(d["c0"])[None], tdt, save=True)
    _close(h_res[:, 0].float().numpy(), _np(res[4]), dtype)
    _close(c_res[:, 0].float().numpy(), _np(res[5]), dtype)
    h_res = _t(_np(res[4])).to(tdt)[:, None]
    c_res = _t(_np(res[5])).to(tdt)[:, None]
    dwh, db, dxw, dh0, dc0 = trnn.bilstm_scan_core_bwd_plain(
        *args, h_res, c_res, _t(d["dys"]).to(tdt)[:, None], _t(d["dhT"])[None],
        _t(d["dcT"])[None], tdt)
    for a, b in zip((dwh[0], db[0], dxw[:, 0], dh0[0], dc0[0]),
                    (dwh_j, db_j, dxw_j, dh0_j, dc0_j)):
        _close(a.float().numpy(), _np(b), dtype)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lstm_scan_matches_jax(dtype, reverse):
    """``lstm_scan`` (the hoisted projection, the time flip, the core)
    against ``avsr_tpu.ops.rnn.lstm_scan``: outputs, final state and the
    gradients of the parameters, the inputs and the initial state."""
    jdt, tdt = DTYPES[dtype]
    T, B, D, H = 8, 3, 6, 16
    params = jax.tree_util.tree_map(np.asarray, jrnn.lstm_init(jax.random.PRNGKey(5), D, H))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    mask = (np.arange(T)[:, None] < np.array([8, 3, 0])[None, :]).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32) * 0.5
    c0 = rng.standard_normal((B, H)).astype(np.float32) * 0.5
    w = rng.standard_normal((T, B, H)).astype(np.float32)

    def loss_j(params, x, h0, c0):
        ys, (hT, cT) = jrnn.lstm_scan(params, x, jnp.asarray(mask), (h0, c0), reverse=reverse,
                                      compute_dtype=jdt)
        return jnp.sum(ys.astype(jnp.float32) * w) + jnp.sum(hT * 0.7) + jnp.sum(cT * 1.3), \
            (ys, hT, cT)

    (_, outs_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0))
    tp = {k: v.requires_grad_(True) for k, v in convert.from_jax(params, device="cpu").items()}
    xt, h0t, c0t = (_t(a).requires_grad_(True) for a in (x, h0, c0))
    ys, (hT, cT) = trnn.lstm_scan(tp, xt, _t(mask), (h0t, c0t), reverse=reverse, cdt=tdt)
    assert ys.dtype == tdt and tuple(ys.shape) == (T, B, H)
    for a, b in zip((ys, hT, cT), outs_j):
        _close(a.detach().float().numpy(), _np(b), dtype)
    assert float(ys.detach()[:, 2].abs().max()) == 0.0 and torch.equal(hT[2], h0t[2])
    loss = torch.sum(ys.float() * _t(w)) + torch.sum(hT * 0.7) + torch.sum(cT * 1.3)
    loss.backward()
    for k in ("wx", "wh", "b"):
        _close(tp[k].grad.numpy(), _np(g_j[0][k]), dtype)
    for a, b in zip((xt, h0t, c0t), g_j[1:]):
        _close(a.grad.numpy(), _np(b), dtype)


def _uni_cfg(time_reduction):
    return EncoderConfig(hidden_units=(16, 16), bidirectional=False, dropout_rate=0.0,
                         time_reduction=time_reduction)


@pytest.mark.parametrize("time_reduction", [None, (2, 1)], ids=["no-reduction", "reduction"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_unidirectional_encoder_matches_jax(dtype, time_reduction):
    """A 2-layer one-direction stack, with and without the pyramid: its
    tree (``fwd`` only, width H), the outputs (zero at padded steps), the
    final state (hT, cT) and the gradients of every leaf and the input."""
    jdt, tdt = DTYPES[dtype]
    cfg = _uni_cfg(time_reduction)
    tcfg = TEncoderConfig(**dataclasses.asdict(cfg))
    T, B, D = 11, 3, 5
    jp = jenc.encoder_init(jax.random.PRNGKey(2), cfg, D)
    assert [sorted(layer) for layer in jp["layers"]] == [["fwd"], ["fwd"]]
    tp0 = tenc.encoder_init(torch.Generator().manual_seed(0), tcfg, D, "cpu")
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), convert.to_jax_numpy(tp0)) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert tenc.encoder_output_dim(tcfg) == jenc.encoder_output_dim(cfg) == 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    lengths = np.array([11, 6, 0], np.int32)
    T_out = T if time_reduction is None else -(-T // 2)
    w = rng.standard_normal((T_out, B, 16)).astype(np.float32)

    def loss_j(params, x):
        out, (hT, cT) = jenc.encoder_apply(params, cfg, x, jnp.asarray(lengths),
                                           compute_dtype=jdt)
        return jnp.sum(out * w) + jnp.sum(hT * 0.5) + jnp.sum(cT), (out, hT, cT)

    (_, outs_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    tp = jax.tree_util.tree_map(lambda a: a.requires_grad_(True),
                                convert.from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                                 device="cpu"))
    xt = _t(x).requires_grad_(True)
    out, (hT, cT) = tenc.encoder_apply(tp, tcfg, xt, torch.from_numpy(lengths), tdt)
    assert out.dtype == torch.float32 and tuple(out.shape) == (T_out, B, 16)
    for a, b in zip((out, hT, cT), outs_j):
        _close(a.detach().numpy(), _np(b), dtype)
    valid = tenc.encoder_output_lengths(tcfg, torch.from_numpy(lengths))
    o = out.detach()
    assert float(o[int(valid[1]):, 1].abs().max()) == 0.0 and float(o[:, 2].abs().max()) == 0
    (torch.sum(out * _t(w)) + torch.sum(hT * 0.5) + torch.sum(cT)).backward()
    grads_t = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: a.grad, tp))
    for a, b in zip(grads_t, jax.tree_util.tree_leaves(g_j[0])):
        _close(a.numpy(), _np(b), dtype)
    _close(xt.grad.numpy(), _np(g_j[1]), dtype)


def test_one_direction_launches_count_apart_from_k1():
    """The LSTM kernels count a one-direction scan (G = 1, K2) under its own
    names, and reject CPU tensors before building or counting anything."""
    assert kernels._lstm_counter("lstm_scan_fwd", 1) == "lstm_scan_uni_fwd"
    assert kernels._lstm_counter("lstm_scan_bwd", 1) == "lstm_scan_uni_bwd"
    assert kernels._lstm_counter("lstm_scan_fwd", 2) == "lstm_scan_fwd"
    T, B, H = 2, 1, 16
    bf = torch.bfloat16
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.lstm_scan_fwd(torch.zeros(1, H, 4 * H, dtype=bf), torch.zeros(1, 4 * H),
                              torch.zeros(T, 1, B, 4 * H, dtype=bf), torch.ones(T, 1, B),
                              torch.zeros(1, B, H), torch.zeros(1, B, H))
    assert kernels.LAUNCHES == before
