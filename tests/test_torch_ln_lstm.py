"""LN-LSTM encoders (K13's plain twins) against ``avsr_tpu``: the cell, the
scans, the bidirectional layer, the encoder stack with the residual and
highway wrappers, a small ``lrs2_av_align_ln`` model, and its tree through
the port's conversions, checkpoints, serving artifact and the ``AVSR`` API.

On CPU tensors ``LNLSTMScanCore`` runs its plain twins
(``ln_lstm_scan_core_fwd_plain`` / ``_bwd_plain``), so these tests hold the
hand-written backward against ``jax.vjp`` of the reference's plain LN scan
(the reference takes autodiff there), under ``jax.jit``.  The recurrent
dropout masks are injected into both packages (``_rd_masks`` patched, or
passed to the scans).  Inputs come from seeded numpy (H = 16, T = 10, B = 3
with a row of length 0), the LN leaves perturbed from their init so that
gamma and beta matter.  Tolerances as ``test_torch_encoder_options.py``'s:
fp32 at atol / rtol 1e-4, bf16 at 3e-2 of the largest reference value; the
model's loss at rtol 1e-4, every gradient leaf at a relative norm error of
1e-4 (``MODEL_GRAD_REL_TOL``), beam ids and steps equal; the trees
bit-exact.  Two bounds follow the reference's own conditioning, which
``tests/ln_conditioning.py`` measures (fp32, CPU):

- A gradient of a 3-layer stack is held with atol 1e-4 of its largest value
  where that exceeds 1 (``_close_grad``; the gradients reach 18-58): one
  part in 1e7 of noise on the input moves JAX's own gradients of the
  highway stack past the unscaled bound (1.28e-4 over rtol; the port's
  difference from JAX is 1.15e-4 there), the layer norms dividing by each
  block's standard deviation.
- The model is held at 1e-4 against JAX given the port's audio features
  (the input of the audio encoder).  Against JAX on its own features it is
  held at ``FEATURE_GRAD_REL_TOL`` = 1e-3: the two frontends' fp32 features
  differ by 6.9e-7 (relative norm), and that difference alone moves JAX's
  own audio-encoder gradient leaves by up to 2.95e-4 in this LN model
  (3.5e-6 in the same model without LN).  The port's hand-written
  backward agrees with autograd of its own forward at 9.1e-7.
"""

import contextlib
import dataclasses
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu import serve as jserve
from avsr_tpu.configs import EncoderConfig
from avsr_tpu.data.units import builtin_unit_dict
from avsr_tpu.decode.beam import beam_search as jbeam
from avsr_tpu.models import encoder as jenc
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu.ops import rnn as jrnn
from avsr_tpu_torch import configs as tconfigs
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch import serve as tserve
from avsr_tpu_torch.avsr import AVSR
from avsr_tpu_torch.configs import EncoderConfig as TEncoderConfig
from avsr_tpu_torch.data.units import builtin_unit_dict as tbuiltin
from avsr_tpu_torch.models import encoder as tenc
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.ops import rnn as trnn
from avsr_tpu_torch.serve import Predictor
from avsr_tpu_torch.train import optim as toptim
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.train.checkpoint import CheckpointManager, params_to_numpy
from avsr_tpu_torch.utils.params import tree_leaves, tree_map
from test_torch_align_slice import small_align_cfg
from test_torch_encoder_options import (DTYPES, _close, _inject, _np, _port, _port_grads, _rd,
                                        _t, _through)
from test_torch_slice import _request
from test_torch_train import _by_path, _jbatch, batch_arrays
from test_torch_trainer import synth

T, B, D, H = 10, 3, 6, 16
LENGTHS = np.array([10, 6, 0])
LOSS_RTOL = 1e-4
MODEL_GRAD_REL_TOL = 1e-4
FEATURE_GRAD_REL_TOL = 1e-3  # against JAX on its own audio features (the docstring)
# chip_smoke.ln_cfg()'s options on the lrs2_av_align preset
LN = {"audio_encoder.layer_norm": True, "video_encoder.layer_norm": True,
      "video_encoder.recurrent_dropout_rate": 0.2}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _perturbed(tree, seed):
    """The LN leaves moved off their init (gamma 1 +- 0.2, beta +- 0.2), the
    other leaves as they are."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "ln_" in name:
            return x + jnp.asarray(0.2 * rng.standard_normal(x.shape).astype(np.float32))
        return x
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _ln_params(seed, n=1):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return [_perturbed(jrnn.lstm_init(k, D, H, layer_norm=True), seed + i)
            for i, k in enumerate(keys)]


def _close_grad(got, want, dtype, what=""):
    """``_close``, with the fp32 atol scaled by the leaf's largest value."""
    if dtype == "float32":
        scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
        np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                                   atol=1e-4 * scale, rtol=1e-4, err_msg=what)
    else:
        _close(got, want, dtype, what)


def _inputs(seed, width):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    mask = (np.arange(T)[:, None] < LENGTHS[None, :]).astype(np.float32)
    return rng, x, mask, rng.standard_normal((T, B, width)).astype(np.float32)


# ---------------------------------------------------------------------------
# the cell and the scans
# ---------------------------------------------------------------------------


def test_ln_init_leaves():
    """``lstm_init(layer_norm=True)``: the reference's three fp32 leaves
    (gamma ones, beta zeros), sorted after the LSTM's own in the flatten
    order; ``cell_init`` threads the flag, and GRU cells ignore it."""
    p = trnn.lstm_init(torch.Generator().manual_seed(0), D, H, "cpu", layer_norm=True)
    j = jrnn.lstm_init(jax.random.PRNGKey(0), D, H, layer_norm=True)
    keys = lambda t: [(convert.path_key(k), tuple(np.shape(x)))  # noqa: E731
                      for k, x in convert.jax_order_leaves(t)]
    assert keys(convert.to_jax_numpy(p)) == keys(j)
    assert [k for k, _ in keys(j)] == ["b", "ln_cell_beta", "ln_cell_gamma", "ln_gamma", "wh",
                                       "wx"]
    assert all(p[k].dtype == torch.float32 for k in trnn.LN_KEYS)
    assert torch.equal(p["ln_gamma"], torch.ones(4 * H))
    assert torch.equal(p["ln_cell_beta"], torch.zeros(H))
    c = trnn.cell_init("lstm", torch.Generator(), D, H, "cpu", layer_norm=True)
    assert set(trnn.LN_KEYS) <= set(c)
    assert set(trnn.cell_init("gru", torch.Generator(), D, H, "cpu", layer_norm=True)) == \
        {"wx", "wh", "b"}


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "rd"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ln_lstm_step_matches_jax(dtype, masked):
    """One LN ``lstm_step`` (from the input, on h or on h * rd as the
    scans feed it) against the reference's: the new state and its
    gradients."""
    jdt, tdt = DTYPES[dtype]
    (params,) = _ln_params(1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, D)).astype(np.float32)
    h = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    c = rng.standard_normal((B, H)).astype(np.float32)
    if masked:
        h = h * _rd(rng)
    w = rng.standard_normal((2, B, H)).astype(np.float32)

    def loss_j(p, x, h, c):
        (h2, c2), _ = jrnn.lstm_step(p, x, (h, c), compute_dtype=jdt)
        return jnp.sum(h2 * w[0]) + jnp.sum(c2 * w[1]), (h2, c2)

    (_, outs_j), g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3), has_aux=True))(
        params, *map(jnp.asarray, (x, h, c)))
    tp = _port(params)
    xt, ht, ct = (_t(a).requires_grad_(True) for a in (x, h, c))
    (h2, c2), out = trnn.lstm_step(tp, xt, (ht, ct), tdt)
    assert out is h2
    for a, b_, n in zip((h2, c2), outs_j, ("h", "c")):
        _close(a.detach().numpy(), _np(b_), dtype, n)
    (torch.sum(h2 * _t(w[0])) + torch.sum(c2 * _t(w[1]))).backward()
    for a, b_ in zip(_port_grads(tp), jax.tree_util.tree_leaves(g_j[0])):
        _close(a.numpy(), _np(b_), dtype)
    for a, b_ in zip((xt, ht, ct), g_j[1:]):
        _close(a.grad.numpy(), _np(b_), dtype)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "rd"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ln_lstm_scan_matches_jax(dtype, reverse, masked):
    """``lstm_scan`` with LN cells (K13 at G = 1) against the reference's
    plain LN scan: outputs and final state, and the gradients of the
    parameters (the LN leaves among them), the input and a nonzero initial
    state against ``jax.vjp``; the length-0 row keeps (h0, c0), emits zeros
    and passes (dhT, dcT) through unchanged."""
    jdt, tdt = DTYPES[dtype]
    (params,) = _ln_params(2 + reverse)
    rng, x, mask, w = _inputs(2 + reverse, H)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    c0 = rng.standard_normal((B, H)).astype(np.float32)
    rd = _rd(rng) if masked else None

    def loss_j(p, x, h0, c0):
        ys, (hT, cT) = jrnn.lstm_scan(p, x, jnp.asarray(mask), (h0, c0), reverse=reverse,
                                      compute_dtype=jdt,
                                      recurrent_dropout_mask=None if rd is None else
                                      jnp.asarray(rd))
        return (jnp.sum(ys.astype(jnp.float32) * w) + jnp.sum(hT * 0.7) + jnp.sum(cT * 0.3),
                (ys, hT, cT))

    (_, outs_j), g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3), has_aux=True))(
        params, *map(jnp.asarray, (x, h0, c0)))
    tp = _port(params)
    xt, h0t, c0t = (_t(a).requires_grad_(True) for a in (x, h0, c0))
    before = dict(kernels.LAUNCHES)
    ys, (hT, cT) = trnn.lstm_scan(tp, xt, _t(mask), (h0t, c0t), reverse=reverse, cdt=tdt,
                                  recurrent_dropout_mask=None if rd is None else _t(rd))
    assert _through(ys, "LNLSTMScanCore")
    assert ys.dtype == tdt and tuple(ys.shape) == (T, B, H)
    for a, b_, n in zip((ys, hT, cT), outs_j, ("ys", "hT", "cT")):
        _close(a.detach().float().numpy(), _np(b_), dtype, n)
    assert float(ys.detach()[:, 2].abs().max()) == 0.0
    assert torch.equal(hT[2], h0t[2]) and torch.equal(cT[2], c0t[2])
    (torch.sum(ys.float() * _t(w)) + torch.sum(hT * 0.7) + torch.sum(cT * 0.3)).backward()
    for (path, _), a, b_ in zip(convert.jax_order_leaves(tp), _port_grads(tp),
                                jax.tree_util.tree_leaves(g_j[0])):
        _close(a.numpy(), _np(b_), dtype, convert.path_key(path))
    for a, b_, n in zip((xt, h0t, c0t), g_j[1:], ("dx", "dh0", "dc0")):
        _close(a.grad.numpy(), _np(b_), dtype, n)
    assert torch.equal(h0t.grad[2], torch.full((H,), 0.7))
    assert torch.equal(c0t.grad[2], torch.full((H,), 0.3))
    assert kernels.LAUNCHES == before  # CPU tensors: the plain twins, nothing launched


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "rd"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bidirectional_ln_lstm_matches_jax(dtype, masked):
    """A bidirectional LN layer: the port's one direction-batched K13 scan
    (G = 2, the backward stream flipped) against the reference's two
    scans, forward and ``jax.vjp``, with and without recurrent-dropout
    masks."""
    jdt, tdt = DTYPES[dtype]
    pf, pb = _ln_params(4, 2)
    params = {"fwd": pf, "bwd": pb}
    rng, x, mask, w = _inputs(4, 2 * H)
    masks = (_rd(rng), _rd(rng)) if masked else None

    def loss_j(p, x):
        out, ((hf, cf), (hb, cb)) = jrnn.bidirectional_scan(
            "lstm", p["fwd"], p["bwd"], x, jnp.asarray(mask), compute_dtype=jdt,
            recurrent_dropout_masks=None if masks is None else tuple(map(jnp.asarray, masks)))
        st = hf + 2 * cf - hb - cb
        return jnp.sum(out.astype(jnp.float32) * w) + jnp.sum(st * 0.3), (out, st)

    (_, outs_j), g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    tp = _port(params)
    xt = _t(x).requires_grad_(True)
    out, ((hf, cf), (hb, cb)) = trnn.bidirectional_scan(
        "lstm", tp["fwd"], tp["bwd"], xt, _t(mask), tdt,
        recurrent_dropout_masks=None if masks is None else tuple(map(_t, masks)))
    assert _through(out, "LNLSTMScanCore")
    st = hf + 2 * cf - hb - cb
    for a, b_, n in zip((out, st), outs_j, ("out", "state")):
        _close(a.detach().float().numpy(), _np(b_), dtype, n)
    (torch.sum(out.float() * _t(w)) + torch.sum(st * 0.3)).backward()
    for (path, _), a, b_ in zip(convert.jax_order_leaves(tp), _port_grads(tp),
                                jax.tree_util.tree_leaves(g_j[0])):
        _close(a.numpy(), _np(b_), dtype, convert.path_key(path))
    _close(xt.grad.numpy(), _np(g_j[1]), dtype, "dx")


def test_ln_twins_save_only_for_grads_and_hold_padding():
    """``ln_lstm_scan_core`` saves (h_res, c_res, z) only when a gradient is
    wanted; the twin backward passes the 0-length row's cotangents through
    exactly and gives it zero dxw; the masked forward's saved operand is
    bf16(h * rd)."""
    G, Tn, Bn = 2, 7, 3
    g = torch.Generator().manual_seed(9)
    wh = torch.randn((G, H, 4 * H), generator=g) / 4
    b, lng = 0.1 * torch.randn((G, 4 * H), generator=g), 1 + 0.1 * torch.randn((G, 4 * H),
                                                                              generator=g)
    lncg, lncb = 1 + 0.1 * torch.randn((G, H), generator=g), 0.1 * torch.randn((G, H),
                                                                               generator=g)
    xw = torch.randn((Tn, G, Bn, 4 * H), generator=g).to(torch.bfloat16)
    mask = torch.ones((Tn, G, Bn))
    mask[:, :, 1] = 0
    h0, c0 = torch.randn((G, Bn, H), generator=g), torch.randn((G, Bn, H), generator=g)
    rd = (torch.rand((G, Bn, H), generator=g) < 0.8).float() / 0.8
    args = (wh, b, lng, lncg, lncb, xw, mask, h0, c0)
    (ys, hT, cT), res = trnn.ln_lstm_scan_core_fwd_plain(*args, torch.bfloat16, True, rd)
    h_res, c_res, z = res
    assert h_res.dtype == torch.bfloat16 and c_res.dtype == z.dtype == torch.float32
    assert torch.equal(h_res[0], (h0 * rd).to(torch.bfloat16))
    assert torch.equal(c_res[0], c0) and tuple(z.shape) == (Tn, G, Bn, 4 * H)
    assert torch.equal(hT[:, 1], h0[:, 1]) and torch.equal(cT[:, 1], c0[:, 1])
    assert float(ys[:, :, 1].float().abs().max()) == 0.0
    dys = torch.randn((Tn, G, Bn, H), generator=g).to(torch.bfloat16)
    dhT, dcT = torch.randn((G, Bn, H), generator=g), torch.randn((G, Bn, H), generator=g)
    grads = trnn.ln_lstm_scan_core_bwd_plain(wh, b, lng, lncg, lncb, mask, *res, dys, dhT, dcT,
                                             torch.bfloat16, rd)
    dxw, dh0, dc0 = grads[5:]
    assert float(dxw[:, :, 1].float().abs().max()) == 0.0
    assert torch.equal(dh0[:, 1], dhT[:, 1]) and torch.equal(dc0[:, 1], dcT[:, 1])
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x) or x, lambda x: x):
        trnn.ln_lstm_scan_core(*args, torch.bfloat16, rd)
        assert not saved  # no input wants a gradient: the forward wrapper alone
        trnn.ln_lstm_scan_core(wh.requires_grad_(True), *args[1:], torch.bfloat16, rd)
    assert any(tuple(x.shape) == (Tn, G, Bn, 4 * H) for x in saved)


def test_k13_wrappers_count_apart_and_route_by_shape():
    """K13's launches count under their own names (the block route apart);
    its route is "cluster" at the presets' H = 256, "block" at the other
    multiples of 4 up to 512 (its backward's block fits); the wrappers
    refuse CPU tensors before building or counting anything."""
    for name in ("ln_lstm_scan_fwd", "ln_lstm_scan_bwd", "ln_lstm_scan_uni_fwd",
                 "ln_lstm_scan_uni_bwd", "ln_lstm_scan_rd_fwd", "ln_lstm_scan_rd_bwd",
                 "ln_lstm_scan_uni_rd_fwd", "ln_lstm_scan_uni_rd_bwd",
                 "ln_lstm_scan_block_fwd", "ln_lstm_scan_block_bwd"):
        assert name in kernels.LAUNCHES
    assert kernels._lstm_counter("ln_lstm_scan_fwd", 1, rd=torch.ones(1)) == \
        "ln_lstm_scan_uni_rd_fwd"
    for Hs in (4, 16, 80, 256, 260, 512):
        for Bs in (1, 8, 128):
            assert kernels.ln_lstm_family(2, Bs, Hs) == ("cluster" if Hs == 256 else "block")
        assert kernels.ln_lstm_smem(Hs, True) <= kernels.SMEM_LIMIT
    assert kernels.ln_lstm_smem(256, False) == 4 * 4 * (8 * 256 + 11)
    for bad in (0, 2, 81, 516):
        with pytest.raises(ValueError, match="ln_lstm scan"):
            kernels.ln_lstm_family(2, 8, bad)
    bf = torch.bfloat16
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.ln_lstm_scan_fwd(torch.zeros(1, 16, 64, dtype=bf), torch.zeros(1, 64),
                                 torch.ones(1, 64), torch.ones(1, 16), torch.zeros(1, 16),
                                 torch.zeros(2, 1, 1, 64, dtype=bf), torch.ones(2, 1, 1),
                                 torch.zeros(1, 1, 16), torch.zeros(1, 1, 16))
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.ln_lstm_scan_bwd(torch.zeros(1, 16, 64, dtype=bf), torch.zeros(1, 64),
                                 torch.ones(1, 64), torch.ones(1, 16), torch.zeros(1, 16),
                                 torch.ones(2, 1, 1), torch.zeros(2, 1, 1, 16),
                                 torch.zeros(2, 1, 1, 64), torch.zeros(2, 1, 1, 16, dtype=bf),
                                 torch.zeros(1, 1, 16), torch.zeros(1, 1, 16))
    assert kernels.LAUNCHES == before


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

ENCODERS = {
    # name: (EncoderConfig overrides, train)
    "ln": (dict(), False),
    "ln_residual": (dict(residual=True), False),
    "ln_highway": (dict(highway=True), False),
    "ln_rd": (dict(recurrent_dropout_rate=0.2), True),
    "ln_rd_uni": (dict(recurrent_dropout_rate=0.2, bidirectional=False), True),
}
ENCODER_CASES = [(n, d) for n in sorted(ENCODERS) for d in sorted(DTYPES)
                 if d == "float32" or n in ("ln", "ln_rd")]


@pytest.mark.parametrize("name,dtype", ENCODER_CASES, ids=[f"{n}-{d}" for n, d in ENCODER_CASES])
def test_ln_encoder_matches_jax(name, dtype):
    """A 3-layer LN stack (6 -> 32, then 32 -> 32: the wrappers apply to
    layers 1 and 2) against ``avsr_tpu.models.encoder``: the tree, the
    outputs and final state and every gradient, the recurrent-dropout masks
    injected into both."""
    jdt, tdt = DTYPES[dtype]
    over, train = ENCODERS[name]
    cfg = EncoderConfig(hidden_units=(16, 16, 16), dropout_rate=0.0, layer_norm=True, **over)
    tcfg = TEncoderConfig(**dataclasses.asdict(cfg))
    jp = _perturbed(jenc.encoder_init(jax.random.PRNGKey(6), cfg, D), 6)
    tp0 = tenc.encoder_init(torch.Generator().manual_seed(0), tcfg, D, "cpu")
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(convert.to_jax_numpy(tp0)) == shapes(jp)
    width = 32 if cfg.bidirectional else 16
    _, x, _, w = _inputs(6, width)
    rng = np.random.default_rng(60)
    masks = [(_rd(rng), _rd(rng)) for _ in range(3)]
    lengths = np.array([10, 6, 0], np.int32)

    def loss_j(p, x):
        out, st = jenc.encoder_apply(p, cfg, x, jnp.asarray(lengths), train=train,
                                     dropout_rng=jax.random.PRNGKey(0), compute_dtype=jdt)
        return jnp.sum(out * w) + sum(jnp.sum(s) for s in jax.tree_util.tree_leaves(st)), out

    pj, pt = _inject(masks)
    with pj, pt:
        (_, out_j), g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
            jp, jnp.asarray(x))
        tp = _port(jp)
        xt = _t(x).requires_grad_(True)
        out, st = tenc.encoder_apply(tp, tcfg, xt, torch.from_numpy(lengths), tdt, train=train,
                                     generator=torch.Generator().manual_seed(0))
    _close(out.detach().numpy(), _np(out_j), dtype, "out")
    loss = torch.sum(out * _t(w)) + sum(torch.sum(s) for s in jax.tree_util.tree_leaves(st))
    loss.backward()
    for (path, _), a, b_ in zip(convert.jax_order_leaves(tp), _port_grads(tp),
                                jax.tree_util.tree_leaves(g_j[0])):
        _close_grad(a.numpy(), _np(b_), dtype, convert.path_key(path))
    _close_grad(xt.grad.numpy(), _np(g_j[1]), dtype, "dx")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model():
    base = small_align_cfg().override(LN)
    nodrop = lambda c: dataclasses.replace(c, dropout_rate=0.0)  # noqa: E731
    cfg = base.replace(audio_encoder=nodrop(base.audio_encoder),
                       video_encoder=nodrop(base.video_encoder),
                       decoder=dataclasses.replace(base.decoder, dropout_rate=0.0,
                                                   sampling_probability=0.0))
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    jparams = _perturbed(jseq.model_init(jax.random.PRNGKey(21), cfg, V), 21)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return dict(cfg=cfg, V=V, jparams=jparams, tparams=tparams,
                tcfg=tconfigs.ExperimentConfig.from_dict(cfg.to_dict()))


def test_ln_model_tree_matches_the_jax_init():
    """The port's own init of ``lrs2_av_align_ln`` gives the JAX init's tree:
    the three LN leaves in every encoder direction, in the flatten order."""
    m = _model()
    mine = tseq.model_init(m["tcfg"], m["V"], torch.Generator().manual_seed(0), "cpu")
    keys = lambda tree: [(convert.path_key(p), tuple(np.shape(x)))  # noqa: E731
                         for p, x in convert.jax_order_leaves(tree)]
    assert keys(convert.to_jax_numpy(mine)) == keys(m["jparams"])
    names = [k for k, _ in keys(m["jparams"])]
    assert sum("ln_" in n for n in names) == 3 * 2 * (3 + 1)


def test_ln_model_loss_and_gradients_match_jax():
    """The train-mode loss and every gradient leaf (the LN leaves among
    them) against JAX's on the same batch, the recurrent-dropout masks
    injected into both: each leaf at ``MODEL_GRAD_REL_TOL`` against JAX
    given the port's audio features, and at ``FEATURE_GRAD_REL_TOL``
    against JAX on its own."""
    m = _model()
    arrays = batch_arrays(0, m["V"])
    rng = np.random.default_rng(22)
    masks = [tuple(((rng.uniform(size=(4, 32)) < 0.8) / 0.8).astype(np.float32)
                   for _ in range(2))]
    feats, real_t, real_j = {}, tenc.encoder_apply, jenc.encoder_apply

    def t_apply(params, cfg, x, *args, **kw):
        if cfg == m["tcfg"].audio_encoder:
            feats["port"] = x.detach().numpy()
        return real_t(params, cfg, x, *args, **kw)

    def j_apply(params, cfg, x, *args, **kw):
        if cfg == m["cfg"].audio_encoder:
            x = jnp.asarray(feats["port"])
            feats["given"] = True
        return real_j(params, cfg, x, *args, **kw)

    def jax_grads(*patches):
        pj, _ = _inject(masks)
        with pj, contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            lf = lambda p, b: jseq.loss_fn(p, m["cfg"], b, train=True,  # noqa: E731
                                           rng=jax.random.PRNGKey(0))
            (_, m_j), g_j = jax.jit(jax.value_and_grad(lf, has_aux=True))(m["jparams"],
                                                                         _jbatch(arrays))
        return float(m_j["loss"]), _by_path(g_j)

    _, pt = _inject(masks)
    with pt, mock.patch.object(tenc, "encoder_apply", t_apply):
        opt, _ = toptim.build_optimizer(m["tcfg"].train)
        state = tstep.train_state_from_params(m["tparams"], opt)
        m_t, g_t = tstep.loss_and_grads(state.params, tseq.batch_to_device(arrays, "cpu"),
                                        cfg=m["tcfg"], generator=torch.Generator().manual_seed(0))
    loss_j, want = jax_grads()
    _, given = jax_grads(mock.patch.object(jenc, "encoder_apply", j_apply))
    assert feats.get("given")
    np.testing.assert_allclose(float(m_t["loss"]), loss_j, rtol=LOSS_RTOL)
    it = iter(g_t)
    grads = dict(tree_leaves(convert.to_jax_numpy(tree_map(lambda _: next(it), state.params))))
    assert set(grads) == set(want) == set(given)
    assert sum("ln_" in "/".join(map(str, k)) for k in want) == 24
    for k, w in want.items():
        assert np.any(grads[k] != 0), k
        err = np.linalg.norm(grads[k] - given[k]) / np.linalg.norm(given[k])
        assert err < MODEL_GRAD_REL_TOL, (k, err)
        err = np.linalg.norm(grads[k] - w) / np.linalg.norm(w)
        assert err < FEATURE_GRAD_REL_TOL, (k, err)


def test_ln_model_beam_matches_jax():
    """Serving (eval mode: no recurrent dropout) through the port's
    ``Predictor``: the beam's ids and steps equal JAX's."""
    m = _model()
    pred = Predictor(m["tparams"], m["tcfg"], tbuiltin(m["tcfg"].data.unit), device="cpu",
                     batch_size=2, audio_seconds=1.0)
    audio, video = _request(np.random.default_rng(23), 2)
    arrays, _ = pred.assemble(audio, video)
    res_t = pred.beam(pred.encode(arrays))
    cfg = m["cfg"]
    enc_j = jseq.encode(m["jparams"], cfg, _jbatch(arrays))
    res_j = jbeam(m["jparams"]["decoder"], cfg.decoder, enc_j.memories,
                  cfg.decode.max_decode_length, beam_width=cfg.decode.beam_width,
                  compute_dtype=jnp.float32)
    np.testing.assert_array_equal(res_t.ids.numpy(), np.asarray(res_j.ids))
    assert res_t.steps == int(res_j.steps)


def test_ln_tree_round_trips(tmp_path):
    """The LN tree: ``convert`` both ways (and ``from_jax_leaves``) bit-exact;
    a checkpoint's save, restore and average; the serving artifact's
    ``params.npz`` byte-equal to the JAX package's; ``Predictor.load``."""
    m = _model()
    cfg, tcfg, jparams, V = m["cfg"], m["tcfg"], m["jparams"], m["V"]
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jparams)]
    template = tseq.model_init(tcfg, V, torch.Generator(), device="meta")
    via_leaves = convert.from_jax_leaves(template, jleaves, device="cpu")
    back = [x for _, x in convert.jax_order_leaves(convert.to_jax_numpy(via_leaves))]
    assert len(back) == len(jleaves)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(back, jleaves))
    tparams = m["tparams"]
    opt, _ = toptim.build_optimizer(tcfg.train)
    state = tstep.train_state_from_params(tree_map(torch.clone, tparams), opt)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=5)
    mgr.save(1, state._replace(step=1))
    with torch.no_grad():
        for _, t in tree_leaves(state.params):
            t.add_(1.0)
    mgr.save(2, state._replace(step=2))
    fresh = tstep.train_state_from_params(
        tseq.model_init(tcfg, V, torch.Generator().manual_seed(5), "cpu"), opt)
    want = dict(tree_leaves(tparams))
    restored, _, _ = mgr.restore(fresh, step=1)
    for p, a in tree_leaves(restored.params):
        assert torch.equal(a, want[p]), p
    avg, used = mgr.average(fresh, last_n=2)
    assert used == [1, 2]
    for p, a in tree_leaves(avg.params):
        torch.testing.assert_close(a, want[p] + 0.5, rtol=0, atol=1e-6, msg=str(p))
    assert "video_encoder/layers/0/fwd/ln_cell_beta" in params_to_numpy(avg.params)
    kw = dict(use_beam=True, batch_size=2, audio_seconds=0.5, transfer="compact")
    units = builtin_unit_dict(cfg.data.unit)
    jdir = jserve.save_artifact(str(tmp_path / "jax"),
                                *jserve.export_decode(jparams, cfg, platforms=("cpu",), **kw),
                                units)
    tdir = tserve.save_artifact(str(tmp_path / "port"), *tserve.export_decode(tparams, tcfg, **kw),
                                tbuiltin(tcfg.data.unit))
    with np.load(os.path.join(jdir, "params.npz")) as j, \
            np.load(os.path.join(tdir, "params.npz")) as t:
        assert sorted(t.files) == sorted(j.files) and j.files
        for k in j.files:
            assert (j[k].dtype, j[k].shape) == (t[k].dtype, t[k].shape), k
            assert j[k].tobytes() == t[k].tobytes(), k
    loaded = Predictor.load(tdir, device="cpu")
    for p, a in tree_leaves(loaded.params):
        assert torch.equal(a, want[p]), p


def test_avsr_ln_trains_checkpoints_restores_and_predicts(tmp_path):
    """``AVSR`` with LN-LSTM encoders (and recurrent dropout) on the CPU: two
    train steps with a checkpoint, a new ``AVSR`` over the run directory that
    restores it, and a prediction."""
    data = synth(n=8)
    kw = dict(architecture="audio", encoder_units_per_layer=(16,),
              decoder_units_per_layer=(16,), embedding_size=8, batch_size=4,
              max_label_length=6, compute_dtype="float32", beam_width=3,
              train_utterances=data, eval_utterances=data, device="cpu")
    cfg = AVSR(**kw).config.override({"audio_encoder.layer_norm": True,
                                      "audio_encoder.recurrent_dropout_rate": 0.2})
    run = str(tmp_path / "run")
    a = AVSR(config=cfg, run_dir=run, **kw)
    assert set(trnn.LN_KEYS) <= set(a.trainer.state.params["audio_encoder"]["layers"][0]["fwd"])
    a.train(num_epochs=1)
    step = int(a.trainer.state.step)
    assert step >= 2 and a.trainer.ckpt.latest_step() == step
    b = AVSR(config=cfg, run_dir=run, **kw)
    assert b.trainer.restore_checkpoint() == step
    for (p, x), (_, y) in zip(tree_leaves(a.trainer.state.params),
                              tree_leaves(b.trainer.state.params)):
        assert torch.equal(x, y), p
    out = b.predict(data[:2])
    assert [u for u, _ in out] == [u.uid for u in data[:2]]
    assert all(isinstance(text, str) for _, text in out)
