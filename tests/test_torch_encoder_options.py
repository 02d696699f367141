"""The RNN encoder's cell options against ``avsr_tpu``: GRU cells (K12),
variational recurrent dropout on the LSTM scans (K1 / K2 with a mask), and
the residual and highway wrappers.

On CPU tensors ``GRUScanCore`` and ``BiLSTMScanCore`` run their plain twins
(``gru_scan_core_fwd_plain`` / ``_bwd_plain``, the masked
``bilstm_scan_core_fwd_impl`` / ``_bwd_plain``), so these tests hold the
hand-written backwards against ``jax.vjp`` of the reference's scans (the
reference takes autodiff of its plain ``lax.scan`` for GRU cells and under
recurrent dropout), under ``jax.jit`` as the JAX package's train step runs
them (op by op, compiling each primitive took most of the file's time).  The recurrent dropout masks cannot be drawn alike
(``utils/rng.py``), so where a test compares a draw it injects the same
masks into both packages by patching each package's ``_rd_masks``.

Inputs come from seeded numpy (H = 16, T = 10-11, B = 3 with a row of
length 0), parameters from the JAX package carried across by ``convert``.
Tolerances: the fp32 policy at atol / rtol 1e-4 (only summation order
differs); the bf16 policy at 3e-2 of the largest reference value (both
sides round the carries, the operands and the input products' cotangents
to bf16, 2^-8 relative, and a value next to a rounding boundary can land
one ulp apart after another summation order and move what follows by
about that much: the K1 tests' bound).  The whole models and the trees'
round trips are ``test_torch_encoder_options_model.py``'s.
"""

import dataclasses
import itertools
from unittest import mock

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
from avsr_tpu_torch.utils.params import tree_map

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


def _close(got, want, dtype, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, atol=3e-2 * float(np.abs(want).max()), rtol=0,
                                   err_msg=what)


def _port(tree):
    """A JAX parameter tree as the port's CPU tensors that want a gradient."""
    return tree_map(lambda a: a.requires_grad_(True),
                    convert.from_jax(jax.tree_util.tree_map(np.asarray, tree), device="cpu"))


def _through(t, name, depth=4):
    """True where ``t``'s autograd graph reaches a node named ``name`` within
    ``depth`` steps (the scan's Function under the selects and flips)."""
    nodes = [t.grad_fn]
    for _ in range(depth):
        if any(name in type(n).__name__ for n in nodes if n is not None):
            return True
        nodes = [f for n in nodes if n is not None for f, _ in n.next_functions]
    return False


def _port_grads(tree):
    return [t.grad for _, t in convert.jax_order_leaves(tree)]


T, B, D, H = 10, 3, 6, 16
LENGTHS = np.array([10, 6, 0])


def _inputs(seed, width):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    mask = (np.arange(T)[:, None] < LENGTHS[None, :]).astype(np.float32)
    return rng, x, mask, rng.standard_normal((T, B, width)).astype(np.float32)


def _rd(rng, keep=0.8):
    """A [B, H] recurrent-dropout mask: 0 or 1/keep (not a power of two)."""
    return ((rng.uniform(size=(B, H)) < keep) / keep).astype(np.float32)


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gru_scan_matches_jax(dtype, reverse):
    """``gru_scan`` (K12 at G = 1) against ``avsr_tpu.ops.rnn.gru_scan``:
    outputs and final state, and the gradients of the parameters, the
    input and a nonzero initial state against ``jax.vjp``; the length-0
    row returns h0, emits zeros and passes dhT to h0 unchanged."""
    jdt, tdt = DTYPES[dtype]
    params = jrnn.gru_init(jax.random.PRNGKey(3), D, H)
    rng, x, mask, w = _inputs(3, H)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)

    def loss_j(p, x, h0):
        ys, hT = jrnn.gru_scan(p, x, jnp.asarray(mask), h0, reverse=reverse, compute_dtype=jdt)
        return jnp.sum(ys.astype(jnp.float32) * w) + jnp.sum(hT * 0.7), (ys, hT)

    (_, outs_j), g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(h0))
    tp = _port(params)
    xt, h0t = _t(x).requires_grad_(True), _t(h0).requires_grad_(True)
    ys, hT = trnn.gru_scan(tp, xt, _t(mask), h0t, reverse=reverse, cdt=tdt)
    assert _through(ys, "GRUScanCore")
    assert ys.dtype == tdt and tuple(ys.shape) == (T, B, H)
    for a, b, n in zip((ys, hT), outs_j, ("ys", "hT")):
        _close(a.detach().float().numpy(), _np(b), dtype, n)
    assert float(ys.detach()[:, 2].abs().max()) == 0.0 and torch.equal(hT[2], h0t[2])
    (torch.sum(ys.float() * _t(w)) + torch.sum(hT * 0.7)).backward()
    for a, b in zip(_port_grads(tp), jax.tree_util.tree_leaves(g_j[0])):
        _close(a.numpy(), _np(b), dtype)
    _close(xt.grad.numpy(), _np(g_j[1]), dtype, "dx")
    _close(h0t.grad.numpy(), _np(g_j[2]), dtype, "dh0")
    assert torch.equal(h0t.grad[2], torch.full((H,), 0.7))


@pytest.mark.parametrize("preprojected", [False, True], ids=["input", "preprojected"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gru_step_matches_jax(dtype, preprojected):
    """One ``gru_step`` (r, z, n; no recurrent bias) against the reference's,
    from the input or from a compute-dtype input product."""
    jdt, tdt = DTYPES[dtype]
    params = jrnn.gru_init(jax.random.PRNGKey(8), D, H)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 3 * H if preprojected else D)).astype(np.float32)
    h = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt) if preprojected else jnp.asarray(x)
    want, _ = jrnn.gru_step(params, xj, jnp.asarray(h), preprojected=preprojected,
                            compute_dtype=jdt)
    xt = _t(x).to(tdt) if preprojected else _t(x)
    got, out = trnn.gru_step(_port(params), xt, _t(h), tdt, preprojected=preprojected)
    assert got is out
    _close(got.detach().numpy(), _np(want), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bidirectional_gru_matches_jax(dtype):
    """A bidirectional GRU layer: the port's one direction-batched K12 scan
    (G = 2, the backward stream flipped) against the reference's two scans,
    forward and ``jax.vjp``; recurrent-dropout masks are ignored by GRU
    cells in both packages."""
    jdt, tdt = DTYPES[dtype]
    kf, kb = jax.random.split(jax.random.PRNGKey(4))
    params = {"fwd": jrnn.gru_init(kf, D, H), "bwd": jrnn.gru_init(kb, D, H)}
    rng, x, mask, w = _inputs(4, 2 * H)
    masks = (_rd(rng), _rd(rng))

    def loss_j(p, x):
        out, (hf, hb) = jrnn.bidirectional_scan("gru", p["fwd"], p["bwd"], x, jnp.asarray(mask),
                                                compute_dtype=jdt)
        return jnp.sum(out.astype(jnp.float32) * w) + jnp.sum(hf) - jnp.sum(hb), (out, hf, hb)

    (_, outs_j), g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    tp = _port(params)
    xt = _t(x).requires_grad_(True)
    out, (hf, hb) = trnn.bidirectional_scan("gru", tp["fwd"], tp["bwd"], xt, _t(mask), tdt,
                                            recurrent_dropout_masks=tuple(map(_t, masks)))
    for a, b, n in zip((out, hf, hb), outs_j, ("out", "hT_f", "hT_b")):
        _close(a.detach().float().numpy(), _np(b), dtype, n)
    (torch.sum(out.float() * _t(w)) + torch.sum(hf) - torch.sum(hb)).backward()
    for a, b in zip(_port_grads(tp), jax.tree_util.tree_leaves(g_j[0])):
        _close(a.numpy(), _np(b), dtype)
    _close(xt.grad.numpy(), _np(g_j[1]), dtype, "dx")


@pytest.mark.parametrize("G", [1, 2], ids=["G1", "G2"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_recurrent_dropout_lstm_scans_match_jax(dtype, G):
    """``fused_bilstm_scan`` (G = 2) and a reversed ``lstm_scan`` with a
    nonzero initial state (G = 1) under the same injected masks against the
    reference's plain scans: forward and ``jax.vjp``.  The masks are
    1/0.8, not a power of two: the operand is bf16(h * rd)."""
    jdt, tdt = DTYPES[dtype]
    kf, kb = jax.random.split(jax.random.PRNGKey(5 + G))
    params = {"fwd": jrnn.lstm_init(kf, D, H), "bwd": jrnn.lstm_init(kb, D, H)}
    rng, x, mask, w = _inputs(5 + G, G * H)
    masks = (_rd(rng), _rd(rng))
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    c0 = rng.standard_normal((B, H)).astype(np.float32)

    if G == 2:
        def run_j(p, x):
            out, ((hf, cf), (hb, cb)) = jrnn.fused_bilstm_scan(
                p["fwd"], p["bwd"], x, jnp.asarray(mask), compute_dtype=jdt,
                recurrent_dropout_masks=tuple(map(jnp.asarray, masks)))
            return out, hf + 2 * cf - hb - cb

        def run_t(p, x):
            out, ((hf, cf), (hb, cb)) = trnn.fused_bilstm_scan(
                p["fwd"], p["bwd"], x, _t(mask), tdt,
                recurrent_dropout_masks=tuple(map(_t, masks)))
            return out, hf + 2 * cf - hb - cb
    else:
        def run_j(p, x):
            out, (hT, cT) = jrnn.lstm_scan(
                p["fwd"], x, jnp.asarray(mask), (jnp.asarray(h0), jnp.asarray(c0)),
                reverse=True, compute_dtype=jdt, recurrent_dropout_mask=jnp.asarray(masks[0]))
            return out, hT + 2 * cT

        def run_t(p, x):
            out, (hT, cT) = trnn.lstm_scan(p["fwd"], x, _t(mask), (_t(h0), _t(c0)), reverse=True,
                                           cdt=tdt, recurrent_dropout_mask=_t(masks[0]))
            return out, hT + 2 * cT

    def loss_j(p, x):
        out, st = run_j(p, x)
        return jnp.sum(out.astype(jnp.float32) * w) + jnp.sum(st * 0.3), (out, st)

    (_, outs_j), g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    tp = _port(params)
    xt = _t(x).requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    out, st = run_t(tp, xt)
    assert _through(out, "BiLSTMScanCore")
    for a, b, n in zip((out, st), outs_j, ("out", "state")):
        _close(a.detach().float().numpy(), _np(b), dtype, n)
    (torch.sum(out.float() * _t(w)) + torch.sum(st * 0.3)).backward()
    grads = [g for g in _port_grads(tp) if g is not None]
    want = [g for g, (path, _) in zip(jax.tree_util.tree_leaves(g_j[0]),
                                      convert.jax_order_leaves(tp))
            if G == 2 or path[0] == "fwd"]
    assert len(grads) == len(want) == 3 * G
    for a, b in zip(grads, want):
        _close(a.numpy(), _np(b), dtype)
    _close(xt.grad.numpy(), _np(g_j[1]), dtype, "dx")
    assert kernels.LAUNCHES == before  # CPU tensors: the plain twins, nothing launched


def test_recurrent_dropout_twins_scale_the_operand():
    """The masked K1 twins at the core: the saved residual is bf16(h * rd)
    (not bf16(h) * rd), a mask of ones gives the unmasked scan's bits, and
    the backward scales the operand's cotangent by rd: a row whose mask is
    zero gets no recurrent cotangent at all."""
    rng = np.random.default_rng(9)
    G, Hs = 2, 16
    wh = _t(0.3 * rng.standard_normal((G, Hs, 4 * Hs)))
    b = _t(0.1 * rng.standard_normal((G, 4 * Hs)))
    xw = _t(rng.standard_normal((T, G, B, 4 * Hs))).to(torch.bfloat16)
    m = (np.arange(T)[:, None] < LENGTHS[None, :]).astype(np.float32)
    mask = _t(np.stack([m, m[::-1]], axis=1))
    h0 = _t(0.5 * rng.standard_normal((G, B, Hs)))
    c0 = _t(rng.standard_normal((G, B, Hs)))
    bf = torch.bfloat16
    rd = _t(((rng.uniform(size=(G, B, Hs)) < 0.8) / 0.8))
    (ys, hT, cT), (h_res, c_res) = trnn.bilstm_scan_core_fwd_impl(
        wh, b, xw, mask, h0, c0, bf, True, rd)
    assert torch.equal(h_res[0], (h0 * rd).to(bf))
    ones = torch.ones_like(rd)
    plain = trnn.bilstm_scan_core_fwd_impl(wh, b, xw, mask, h0, c0, bf, True)
    with_ones = trnn.bilstm_scan_core_fwd_impl(wh, b, xw, mask, h0, c0, bf, True, ones)
    for a, c in zip((*plain[0], *plain[1]), (*with_ones[0], *with_ones[1])):
        assert torch.equal(a, c)
    dys = _t(rng.standard_normal((T, G, B, Hs))).to(bf)
    zero = rd.clone()
    zero[:, 0] = 0.0
    args = (wh, b, xw, mask, h_res, c_res, dys, torch.zeros(G, B, Hs), torch.zeros(G, B, Hs), bf)
    dh0_zero = trnn.bilstm_scan_core_bwd_plain(*args, zero)[3]
    dh0_rd = trnn.bilstm_scan_core_bwd_plain(*args, rd)[3]
    assert float(dh0_zero[:, 0].abs().max()) == 0.0 and float(dh0_rd[:, 0].abs().max()) > 0


def test_gru_twins_hold_the_length_0_row_and_save_only_for_grads():
    """K12's plain twins on a direction-batched core: the length-0 row keeps
    h0 and passes dhT through; the forward saves the carries only when
    asked; ``gru_scan_core`` without autograd records nothing."""
    rng = np.random.default_rng(10)
    G = 2
    wh = _t(0.3 * rng.standard_normal((G, H, 3 * H)))
    b = _t(0.1 * rng.standard_normal((G, 3 * H)))
    xw = _t(rng.standard_normal((T, G, B, 3 * H))).to(torch.bfloat16)
    m = (np.arange(T)[:, None] < LENGTHS[None, :]).astype(np.float32)
    mask = _t(np.stack([m, m[::-1]], axis=1))
    h0 = _t(rng.standard_normal((G, B, H)))
    bf = torch.bfloat16
    (ys, hT), res = trnn.gru_scan_core_fwd_plain(wh, b, xw, mask, h0, bf, False)
    assert res is None and torch.equal(hT[:, 2], h0[:, 2])
    assert float(ys[:, :, 2].float().abs().max()) == 0.0
    (_, _), h_res = trnn.gru_scan_core_fwd_plain(wh, b, xw, mask, h0, bf, True)
    assert h_res.dtype == bf and torch.equal(h_res[0], h0.to(bf))
    dhT = _t(rng.standard_normal((G, B, H)))
    dys = _t(rng.standard_normal((T, G, B, H))).to(bf)
    dwh, db, dxw, dh0 = trnn.gru_scan_core_bwd_plain(wh, b, xw, mask, h_res, dys, dhT, bf)
    assert torch.equal(dh0[:, 2], dhT[:, 2]) and float(dxw[:, :, 2].float().abs().max()) == 0
    assert dwh.shape == wh.shape and db.shape == b.shape and dxw.dtype == bf
    ys2, hT2 = trnn.gru_scan_core(wh, b, xw, mask, h0, bf)
    assert ys2.grad_fn is None and torch.equal(ys2, ys) and torch.equal(hT2, hT)


def test_kernel_wrappers_count_apart_and_route_by_shape():
    """The masked K1 launches and K12's count under their own names (K12's
    per-step route apart); K12's route is "cluster" at the presets' H =
    256, "step" at the other widths its backward fits, and the wrappers
    refuse CPU tensors before building or counting anything."""
    assert kernels._lstm_counter("lstm_scan_fwd", 2, rd=torch.ones(1)) == "lstm_scan_rd_fwd"
    assert kernels._lstm_counter("lstm_scan_bwd", 1, rd=torch.ones(1)) == "lstm_scan_uni_rd_bwd"
    assert kernels._lstm_counter("lstm_scan_bwd", 1) == "lstm_scan_uni_bwd"
    for name in ("lstm_scan_rd_fwd", "lstm_scan_rd_bwd", "lstm_scan_uni_rd_fwd",
                 "lstm_scan_uni_rd_bwd", "gru_scan_fwd", "gru_scan_bwd", "gru_scan_uni_fwd",
                 "gru_scan_uni_bwd", "gru_scan_step_fwd", "gru_scan_step_bwd"):
        assert name in kernels.LAUNCHES
    for Hs in (16, 80, 256, 512):
        assert kernels.gru_family(2, 128, Hs) == ("cluster" if Hs == 256 else "step")
        assert kernels.gru_step_smem(Hs, True) <= kernels.SMEM_LIMIT
    for bad in (8, 40, 528):
        with pytest.raises(ValueError, match="gru scan"):
            kernels.gru_family(2, 8, bad)
    # the tiled layouts: slot 3 of the forward's tile is zero, Wh^T's runs
    wh = torch.arange(2 * 32 * 96, dtype=torch.float32).view(2, 32, 96)
    tiled = kernels.tile_gru_weights(wh)
    assert tuple(tiled.shape) == (2, 2, 32, 16, 4) and float(tiled[..., 3].abs().max()) == 0
    assert float(tiled[1, 1, 5, 3, 2]) == float(wh[1, 5, 2 * 32 + 16 + 3])
    tT = kernels.tile_gru_weights_t(wh)
    assert tuple(tT.shape) == (2, 2, 24, 16, 4)
    assert float(tT[1, 1, 7, 3, 2]) == float(wh[1, 16 + 3, 4 * 7 + 2])
    bf = torch.bfloat16
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.gru_scan_fwd(torch.zeros(1, 16, 48, dtype=bf), torch.zeros(1, 48),
                             torch.zeros(2, 1, 1, 48, dtype=bf), torch.ones(2, 1, 1),
                             torch.zeros(1, 1, 16))
    assert kernels.LAUNCHES == before


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

ENCODERS = {
    # name: (EncoderConfig overrides, train)
    "residual": (dict(residual=True), False),
    "highway": (dict(highway=True), False),
    "residual_over_highway": (dict(residual=True, highway=True), False),
    "gru_highway": (dict(cell_type="gru", highway=True), False),
    "rd_residual": (dict(recurrent_dropout_rate=0.2, residual=True), True),
    "rd_uni": (dict(recurrent_dropout_rate=0.2, bidirectional=False), True),
}


def _inject(masks):
    """Patches of both packages' ``_rd_masks`` that hand out ``masks`` in call
    order (cycling: a jitted JAX function draws at trace time, the port at
    every call)."""
    jit_, tit = itertools.cycle(masks), itertools.cycle(masks)

    def jdraw(layer, cfg, B, train, rng):
        return tuple(jnp.asarray(m) for m in next(jit_)), rng

    def tdraw(layer, cfg, B, train, generator):
        return tuple(_t(m) for m in next(tit))

    return mock.patch.object(jenc, "_rd_masks", jdraw), mock.patch.object(tenc, "_rd_masks",
                                                                         tdraw)


# both policies for the layers of the two configurations the card runs and
# the plain highway; fp32 for the other combinations
ENCODER_CASES = [(n, d) for n in sorted(ENCODERS) for d in sorted(DTYPES)
                 if d == "float32" or n in ("gru_highway", "highway", "rd_residual")]


@pytest.mark.parametrize("name,dtype", ENCODER_CASES, ids=[f"{n}-{d}" for n, d in ENCODER_CASES])
def test_encoder_options_match_jax(name, dtype):
    """A 3-layer stack (layer 0 6 -> 32, then 32 -> 32: the wrappers apply
    to layers 1 and 2) against ``avsr_tpu.models.encoder``: the tree (keys,
    shapes: ``hw_w`` / ``hw_b`` only where the width is kept), the outputs
    and final state, every gradient, and the dtype each layer leaves
    (residual bf16 + bf16 stays bf16, highway promotes to fp32)."""
    jdt, tdt = DTYPES[dtype]
    over, train = ENCODERS[name]
    cfg = EncoderConfig(hidden_units=(16, 16, 16), dropout_rate=0.0, **over)
    tcfg = TEncoderConfig(**dataclasses.asdict(cfg))
    jp = jenc.encoder_init(jax.random.PRNGKey(6), cfg, D)
    tp0 = tenc.encoder_init(torch.Generator().manual_seed(0), tcfg, D, "cpu")
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(convert.to_jax_numpy(tp0)) == shapes(jp)
    width = 32 if cfg.bidirectional else 16
    assert [("hw_w" in layer) for layer in jp["layers"]] == \
        [False, cfg.highway and cfg.bidirectional, cfg.highway and cfg.bidirectional]
    if cfg.highway:
        assert float(tp0["layers"][1]["hw_b"][0]) == -1.0
    rng, x, _, w = _inputs(6, width)
    rng = np.random.default_rng(60)
    masks = [(_rd(rng), _rd(rng)) for _ in range(3)]
    lengths = np.array([10, 6, 0], np.int32)
    dtypes = {"jax": [], "port": []}

    def recorded(mod, key):
        post = mod._post_layer

        def call(*args, **kw):
            out = post(*args, **kw)
            h = out[0] if isinstance(out, tuple) else out
            dtypes[key].append(str(h.dtype).replace("torch.", ""))
            return out
        return mock.patch.object(mod, "_post_layer", call)

    def loss_j(p, x):
        out, st = jenc.encoder_apply(p, cfg, x, jnp.asarray(lengths), train=train,
                                     dropout_rng=jax.random.PRNGKey(0), compute_dtype=jdt)
        return jnp.sum(out * w) + sum(jnp.sum(s) for s in jax.tree_util.tree_leaves(st)), out

    pj, pt = _inject(masks)
    with pj, pt, recorded(jenc, "jax"), recorded(tenc, "port"):
        (_, out_j), g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
            jp, jnp.asarray(x))
        tp = _port(jp)
        xt = _t(x).requires_grad_(True)
        out, st = tenc.encoder_apply(tp, tcfg, xt, torch.from_numpy(lengths), tdt, train=train,
                                     generator=torch.Generator().manual_seed(0))
    assert dtypes["port"] == dtypes["jax"][:3]
    if name == "highway" or name == "gru_highway":
        assert dtypes["port"][1:] == ["float32", "float32"]
    if name == "residual" and dtype == "bfloat16":
        assert dtypes["port"] == ["bfloat16"] * 3
    _close(out.detach().numpy(), _np(out_j), dtype, "out")
    loss = torch.sum(out * _t(w)) + sum(torch.sum(s) for s in jax.tree_util.tree_leaves(st))
    loss.backward()
    for (path, _), a, b in zip(convert.jax_order_leaves(tp), _port_grads(tp),
                               jax.tree_util.tree_leaves(g_j[0])):
        if a is None:  # a highway gate that residual overrides: no path, zeros in JAX
            assert name == "residual_over_highway" and "hw_" in path[-1]
            assert float(np.abs(_np(b)).max()) == 0.0
            continue
        _close(a.numpy(), _np(b), dtype, convert.path_key(path))
    _close(xt.grad.numpy(), _np(g_j[1]), dtype, "dx")


def test_recurrent_dropout_draw():
    """The port's own draw (``_rd_masks``): two [B, H] masks a layer, even
    for one direction, of 0 and 1/keep, from the step's generator; none for
    GRU cells, eval, a rate of 0 or no generator; a masked train step
    launches nothing on the CPU and differs from an unmasked one."""
    cfg = TEncoderConfig(hidden_units=(16,), bidirectional=False, recurrent_dropout_rate=0.25,
                         dropout_rate=0.0)
    layer = tenc.encoder_init(torch.Generator().manual_seed(1), cfg, D, "cpu")["layers"][0]
    gen = torch.Generator().manual_seed(2)
    masks = tenc._rd_masks(layer, cfg, 5, True, gen)
    assert len(masks) == 2 and all(tuple(m.shape) == (5, 16) for m in masks)
    vals = torch.unique(torch.cat(masks))
    assert vals.tolist() == [0.0, float(np.float32(1.0) / np.float32(0.75))]
    assert not torch.equal(masks[0], masks[1])
    for c, train, g in ((dataclasses.replace(cfg, cell_type="gru"), True, gen),
                        (cfg, False, gen), (dataclasses.replace(cfg, recurrent_dropout_rate=0.0),
                                            True, gen), (cfg, True, None)):
        assert tenc._rd_masks(layer, c, 5, train, g) is None
    x = torch.randn((T, B, D), generator=torch.Generator().manual_seed(3))
    params = {"layers": [layer]}
    lengths = torch.from_numpy(LENGTHS)
    a, _ = tenc.encoder_apply(params, cfg, x, lengths, torch.bfloat16, train=True,
                              generator=torch.Generator().manual_seed(4))
    b, _ = tenc.encoder_apply(params, cfg, x, lengths, torch.bfloat16, train=False)
    assert not torch.equal(a, b)


def test_layer_norm_still_raises_naming_the_next_slice():
    """LN-LSTM cells were the last encoder option to raise (naming K13, the
    kernel they waited for); they are ported now: the stack initialises
    with the LN leaves and runs (``test_torch_ln_lstm.py`` holds them
    against the reference), and an unknown cell type still raises."""
    cfg = TEncoderConfig(hidden_units=(16,), layer_norm=True)
    params = tenc.encoder_init(torch.Generator(), cfg, D, "cpu")
    assert set(trnn.LN_KEYS) <= set(params["layers"][0]["fwd"])
    out, _ = tenc.encoder_apply(params, cfg, torch.zeros(2, 1, D),
                                torch.ones(1, dtype=torch.long), torch.float32)
    assert tuple(out.shape) == (2, 1, 32)
    cell = trnn.cell_init("lstm", torch.Generator(), D, 16, "cpu", layer_norm=True)
    ys, _ = trnn.rnn_scan("lstm", cell, torch.zeros(2, 1, D))
    assert tuple(ys.shape) == (2, 1, 16)
    with pytest.raises(ValueError, match="unknown cell type"):
        tenc.encoder_init(torch.Generator(), TEncoderConfig(hidden_units=(16,), cell_type="rnn"),
                          D, "cpu")
