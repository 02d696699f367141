"""LSTM recurrence of the PyTorch port against ``avsr_tpu.ops.rnn``.

The port's ``bilstm_scan_core`` is the K1 wrapper: on CPU tensors it runs
the plain version, which these tests hold against the JAX custom-VJP core
and ``fused_bilstm_scan`` on the same seeded numpy inputs and weights.

Tolerances: fp32 compute at atol 1e-5 / rtol 1e-4 (conftest runs JAX
matmuls at "highest" precision, so only summation order differs).  Under
the bf16 policy both sides round h and the outputs to bf16 (8 bits of
mantissa, relative step 2^-8 = 3.9e-3); a one-ulp flip in a rounded h
propagates through the recurrence, so bf16 outputs are held at
atol 2e-2 and the fp32 cell states at atol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.ops import rnn as jrnn
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.ops import rnn as trnn

torch.set_num_threads(1)

DTYPES = {
    "float32": (jnp.float32, torch.float32, dict(atol=1e-5, rtol=1e-4)),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2)),
}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _lengths_mask(T, lengths):
    return (np.arange(T)[:, None] < np.asarray(lengths)[None, :]).astype(np.float32)


def _layer(seed, D, H):
    kf, kb = jax.random.split(jax.random.PRNGKey(seed))
    fwd = jax.tree_util.tree_map(np.asarray, jrnn.lstm_init(kf, D, H))
    bwd = jax.tree_util.tree_map(np.asarray, jrnn.lstm_init(kb, D, H))
    return fwd, bwd


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_core_matches_jax_custom_vjp_core(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    T, G, B, H = 9, 2, 3, 16
    rng = np.random.default_rng(0)
    wh = rng.standard_normal((G, H, 4 * H)).astype(np.float32) * 0.3
    b = rng.standard_normal((G, 4 * H)).astype(np.float32) * 0.1
    xw = rng.standard_normal((T, G, B, 4 * H)).astype(np.float32)
    lengths = [9, 5, 1]
    m = _lengths_mask(T, lengths)
    mask = np.stack([m, m[::-1]], axis=1)  # backward stream pre-flipped
    h0 = rng.standard_normal((G, B, H)).astype(np.float32) * 0.5
    c0 = rng.standard_normal((G, B, H)).astype(np.float32) * 0.5

    ys_j, hT_j, cT_j = jrnn._bilstm_scan_core(
        jnp.asarray(wh), jnp.asarray(b), jnp.asarray(xw).astype(jdt),
        jnp.asarray(mask), (jnp.asarray(h0), jnp.asarray(c0)), jdt)
    ys_t, hT_t, cT_t = trnn.bilstm_scan_core(
        _t(wh), _t(b), _t(xw).to(tdt), _t(mask), _t(h0), _t(c0), tdt)
    assert ys_t.dtype == tdt and hT_t.dtype == torch.float32
    np.testing.assert_allclose(ys_t.float().numpy(), _np(ys_j), **tol)
    np.testing.assert_allclose(hT_t.numpy(), _np(hT_j), **tol)
    np.testing.assert_allclose(cT_t.numpy(), _np(cT_j), **tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_bilstm_scan_matches_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    T, B, D, H = 11, 3, 12, 16
    fwd, bwd = _layer(1, D, H)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    mask = _lengths_mask(T, [11, 7, 3])
    out_j, ((hf_j, cf_j), (hb_j, cb_j)) = jrnn.fused_bilstm_scan(
        fwd, bwd, jnp.asarray(x), jnp.asarray(mask), compute_dtype=jdt)
    out_t, ((hf_t, cf_t), (hb_t, cb_t)) = trnn.fused_bilstm_scan(
        convert.from_jax(fwd), convert.from_jax(bwd), _t(x), _t(mask), tdt)
    assert tuple(out_t.shape) == (T, B, 2 * H)
    np.testing.assert_allclose(out_t.float().numpy(), _np(out_j), **tol)
    for a, b in ((hf_t, hf_j), (cf_t, cf_j), (hb_t, hb_j), (cb_t, cb_j)):
        np.testing.assert_allclose(a.numpy(), _np(b), **tol)


def test_padded_steps_carry_state_and_emit_zeros():
    """Right padding must not change the valid outputs or the final states."""
    T, B, D, H = 10, 2, 6, 8
    fwd, bwd = _layer(2, D, H)
    pf, pb = convert.from_jax(fwd), convert.from_jax(bwd)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    lengths = [10, 6]
    out, ((hf, cf), (hb, cb)) = trnn.fused_bilstm_scan(
        pf, pb, _t(x), _t(_lengths_mask(T, lengths)), torch.float32)
    assert torch.all(out[6:, 1] == 0)
    # utterance 1 alone, unpadded
    x1 = _t(x[:6, 1:2])
    out1, ((hf1, cf1), (hb1, cb1)) = trnn.fused_bilstm_scan(pf, pb, x1, None, torch.float32)
    torch.testing.assert_close(out[:6, 1:2], out1, atol=1e-6, rtol=1e-5)
    for a, b in ((hf[1], hf1[0]), (cf[1], cf1[0]), (hb[1], hb1[0]), (cb[1], cb1[0])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_cuda_launcher_rejects_cpu_tensors():
    """The CUDA side of the wrapper never computes on the CPU: it checks
    the device before building or launching anything."""
    T, G, B, H = 2, 2, 1, 4
    args = (torch.zeros(G, H, 4 * H, dtype=torch.bfloat16), torch.zeros(G, 4 * H),
            torch.zeros(T, G, B, 4 * H, dtype=torch.bfloat16), torch.ones(T, G, B),
            torch.zeros(G, B, H), torch.zeros(G, B, H))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.lstm_scan_fwd(*args)
    assert kernels.LAUNCHES == before


def test_kernel_weight_tiling_keeps_every_gate_weight():
    """The LSTM kernel reads Wh as [G, H/16, H, 16, 4]: tile t, row k,
    unit u, gate q holds Wh[g, k, q*H + 16*t + u]."""
    G, H = 2, 32
    wh = torch.randn(G, H, 4 * H)
    tiled = kernels.tile_lstm_weights(wh)
    assert tuple(tiled.shape) == (G, H // 16, H, 16, 4) and tiled.is_contiguous()
    g, k, q, unit = torch.meshgrid(torch.arange(G), torch.arange(H), torch.arange(4),
                                   torch.arange(H), indexing="ij")
    torch.testing.assert_close(tiled[g, unit // 16, k, unit % 16, q], wh[g, k, q * H + unit],
                               rtol=0, atol=0)
