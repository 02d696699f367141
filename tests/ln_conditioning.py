"""Measures how far the reference's own LN-LSTM gradients move under fp32
noise, beside the port's distance from them: the readings behind the
bounds of ``test_torch_ln_lstm.py`` (its module docstring).

    JAX_PLATFORMS=cpu python tests/ln_conditioning.py

Prints, on the CPU in fp32:

- the small ``lrs2_av_align_ln`` model of ``test_ln_model_*`` (and the
  same model without LN): the relative norm of the difference between the
  port's and JAX's audio features; JAX's gradient leaves given the port's
  audio features against JAX's own (the reference's spread under that
  difference alone); the port against JAX given the same features; the
  port's hand-written backward against autograd of its own forward;
- the 3-layer stacks of ``test_ln_encoder_matches_jax``: by how much the
  port's gradients, and JAX's own under one part in 1e7 of sign noise on the
  input, exceed the unscaled bound |a - b| <= 1e-4 + 1e-4 |b|.
"""

import contextlib
import dataclasses
import os
import statistics
import sys
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_ln_lstm as t  # noqa: E402
from test_torch_train import _by_path, _jbatch, batch_arrays  # noqa: E402
from avsr_tpu_torch import convert  # noqa: E402
from avsr_tpu_torch.ops import rnn as trnn  # noqa: E402
from avsr_tpu_torch.train import optim as toptim, step as tstep  # noqa: E402
from avsr_tpu_torch.utils.params import tree_leaves, tree_map  # noqa: E402


def rel(a, b):
    return {k: float(np.linalg.norm(np.asarray(a[k]) - np.asarray(b[k]))
                     / np.linalg.norm(np.asarray(b[k]))) for k in b}


def spread(r, prefix=None):
    v = [x for k, x in r.items() if prefix is None or k[0] == prefix]
    return f"max {max(v):.3e} median {statistics.median(v):.3e}"


def model_readings(ln):
    t._model.cache_clear()
    t.LN = ({"audio_encoder.layer_norm": True, "video_encoder.layer_norm": True} if ln else {})
    t.LN["video_encoder.recurrent_dropout_rate"] = 0.2
    m = t._model()
    arrays = batch_arrays(0, m["V"])
    rng = np.random.default_rng(22)
    masks = [tuple(((rng.uniform(size=(4, 32)) < 0.8) / 0.8).astype(np.float32)
                   for _ in range(2))]
    feats, real_t, real_j = {}, t.tenc.encoder_apply, t.jenc.encoder_apply

    def t_apply(params, cfg, x, *args, **kw):
        if cfg == m["tcfg"].audio_encoder:
            feats["port"] = x.detach().numpy()
        return real_t(params, cfg, x, *args, **kw)

    def j_apply(params, cfg, x, *args, substitute, **kw):
        if cfg == m["cfg"].audio_encoder:
            feats["jax"] = x
            if substitute:
                x = jnp.asarray(feats["port"])
        return real_j(params, cfg, x, *args, **kw)

    def jax_grads(substitute):
        pj, _ = t._inject(masks)
        apply = lambda *a, **kw: j_apply(*a, substitute=substitute, **kw)  # noqa: E731
        with pj, mock.patch.object(t.jenc, "encoder_apply", apply):
            def lf(p, b):
                loss, metrics = t.jseq.loss_fn(p, m["cfg"], b, train=True,
                                               rng=jax.random.PRNGKey(0))
                return loss, feats["jax"]
            (_, x), g = jax.jit(jax.value_and_grad(lf, has_aux=True))(m["jparams"],
                                                                     _jbatch(arrays))
        return np.asarray(x), _by_path(g)

    def port_grads(core=None):
        _, pt = t._inject(masks)
        with pt, mock.patch.object(t.tenc, "encoder_apply", t_apply), \
                (mock.patch.object(trnn, "ln_lstm_scan_core", core) if core
                 else contextlib.nullcontext()):
            opt, _ = toptim.build_optimizer(m["tcfg"].train)
            state = tstep.train_state_from_params(m["tparams"], opt)
            _, g = tstep.loss_and_grads(state.params, t.tseq.batch_to_device(arrays, "cpu"),
                                        cfg=m["tcfg"], generator=torch.Generator().manual_seed(0))
        it = iter(g)
        return dict(tree_leaves(convert.to_jax_numpy(tree_map(lambda _: next(it),
                                                                 state.params))))

    def autograd_core(wh, b, lng, lncg, lncb, xw, mask, h0, c0, cdt, rd=None):
        (ys, hT, cT), _ = trnn.ln_lstm_scan_core_fwd_plain(wh, b, lng, lncg, lncb, xw, mask,
                                                           h0, c0, cdt, False, rd)
        return ys, hT, cT

    g_port = port_grads()
    x_jax, g_own = jax_grads(False)
    _, g_given = jax_grads(True)
    name = "lrs2_av_align_ln" if ln else "lrs2_av_align (no LN)"
    fx = float(np.linalg.norm(feats["port"] - x_jax) / np.linalg.norm(x_jax))
    print(f"{name}: audio features, port against JAX: relative norm {fx:.3e}")
    print(f"  JAX given the port's features against JAX: audio encoder leaves "
          f"{spread(rel(g_given, g_own), 'audio_encoder')}; all leaves {spread(rel(g_given, g_own))}")
    print(f"  port against JAX given the same features: all leaves {spread(rel(g_port, g_given))}")
    print(f"  port against JAX on its own features: all leaves {spread(rel(g_port, g_own))}")
    if ln:
        g_auto = port_grads(autograd_core)
        print(f"  the port's K13 backward against autograd of its forward: all leaves "
              f"{spread(rel(g_port, g_auto))}")


def excess(a, b):
    """The largest |a - b| - 1e-4 |b|: at most 1e-4 passes the unscaled bound."""
    return max(float(np.max(np.abs(x - y) - 1e-4 * np.abs(y))) for x, y in zip(a, b))


def stack_readings(name):
    over, train = t.ENCODERS[name]
    cfg = t.EncoderConfig(hidden_units=(16, 16, 16), dropout_rate=0.0, layer_norm=True, **over)
    tcfg = t.TEncoderConfig(**dataclasses.asdict(cfg))
    jp = t._perturbed(t.jenc.encoder_init(jax.random.PRNGKey(6), cfg, t.D), 6)
    _, x, _, w = t._inputs(6, 32 if cfg.bidirectional else 16)
    rng = np.random.default_rng(60)
    masks = [(t._rd(rng), t._rd(rng)) for _ in range(3)]
    lengths = np.array([10, 6, 0], np.int32)

    def loss_j(p, x):
        out, st = t.jenc.encoder_apply(p, cfg, x, jnp.asarray(lengths), train=train,
                                       dropout_rng=jax.random.PRNGKey(0),
                                       compute_dtype=jnp.float32)
        return jnp.sum(out * w) + sum(jnp.sum(s) for s in jax.tree_util.tree_leaves(st)), out

    def jax_grads(xin):
        _, g = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
            jp, jnp.asarray(xin))
        return [np.asarray(a) for a in jax.tree_util.tree_leaves(g[0])] + [np.asarray(g[1])]

    noisy = (x * (1 + 1e-7 * np.random.default_rng(1).choice([-1, 1], size=x.shape))
             ).astype(np.float32)
    pj, pt = t._inject(masks)
    with pj, pt:
        want, moved = jax_grads(x), jax_grads(noisy)
        tp = t._port(jp)
        xt = t._t(x).requires_grad_(True)
        out, st = t.tenc.encoder_apply(tp, tcfg, xt, torch.from_numpy(lengths), torch.float32,
                                       train=train, generator=torch.Generator().manual_seed(0))
    (torch.sum(out * t._t(w)) + sum(torch.sum(s) for s in
                                    jax.tree_util.tree_leaves(st))).backward()
    got = [a.numpy() for a in t._port_grads(tp)] + [xt.grad.numpy()]
    big = max(float(np.abs(y).max()) for y in want)
    print(f"stack {name}: largest |gradient| {big:.2f}; over the unscaled bound: port "
          f"{excess(got, want):.3e}, JAX under 1e-7 input noise {excess(moved, want):.3e}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    model_readings(True)
    model_readings(False)
    for n in sorted(t.ENCODERS):
        stack_readings(n)
