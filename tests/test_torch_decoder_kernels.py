"""The decoder's kernels K5 and K6 on the CPU: their plain twins against
``avsr_tpu.models.transformer_decoder``.

K5 (teacher-forced attention): the plain forward and backward twins
against ``jax.vjp`` of the reference's self- and cross-attention core
lines (the forward's residual is the softmax's row statistics, from which
the weights and the backward are recomputed), and every gradient of
``teacher_forced_logits`` (decoder leaves and the memory) against
``jax.grad``; on CPU tensors ``DecoderAttention`` runs both twins and saves
no [B, nh, Q, S] tensor; the routing of head widths to the tensor-core or
the CUDA-core kernels.  K6 (decode attention): ``decode_step`` over several positions
with a memory of length 0, and the twin's uniform weights there.  The CUDA
launchers refuse CPU tensors without counting a launch.

Tolerances: fp32 at atol 1e-5 / rtol 1e-4 (JAX matmuls at "highest"
precision, only summation order differs).  Under the bf16 policy both sides
round scores, weights and products to bf16 at the same points; a value
within one ulp of a rounding boundary can land 2^-8 relative apart after
another summation order, so outputs are held at atol/rtol 2e-2 and
gradients at 3e-2 of the largest reference value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import DecoderConfig
from avsr_tpu.models import transformer_decoder as jtd
from avsr_tpu.ops import attention as jattn
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.decode.beam import step_buffers
from avsr_tpu_torch.models import transformer_decoder as ttd
from avsr_tpu_torch.ops import attention as tattn

DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}
CFG = dataclasses.replace(DecoderConfig(), decoder_type="transformer", hidden_units=(32,),
                          num_heads=4, attention_units=8, embedding_dim=16,
                          sampling_probability=0.0)
V, M = 20, 24


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, out=False):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    elif out:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    else:
        np.testing.assert_allclose(got, want, atol=3e-2 * float(np.abs(want).max()), rtol=0)


def _jax_core(q, k, v, bias, dk, jdt):
    """The reference's core lines: transformer_decoder.py:346-350 (bias
    None, causal) and :366-372 (the memory bias)."""
    Q, S = q.shape[1], k.shape[1]
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k).astype(jnp.float32) / np.sqrt(dk)
    if bias is None:
        causal = (jnp.arange(S)[None, :] <= jnp.arange(Q)[:, None]).astype(jnp.float32)
        s = s + (1.0 - causal)[None, None] * -1e9
    else:
        s = s + bias[:, None, None, :]
    w = jax.nn.softmax(s, axis=-1).astype(jdt)
    return jnp.einsum("bhqk,bkhd->bqhd", w, v)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["self", "cross"])
def test_k5_twins_match_jax_core_vjp(mode, dtype):
    """ctx, then dq, dk, dv for a random cotangent; the cross case has a
    memory of length 0 (every key at -1e30: uniform weights)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    B, Q, nh = 3, 6, 2
    S, dk, dv = (Q, 8, 8) if mode == "self" else (5, 8, 16)
    q, k, v, dctx = (rng.standard_normal(s).astype(np.float32)
                     for s in ((B, Q, nh, dk), (B, S, nh, dk), (B, S, nh, dv), (B, Q, nh, dv)))
    bias = None
    if mode == "cross":
        lens = np.array([5, 2, 0])
        bias = ((1.0 - (np.arange(S)[None, :] < lens[:, None])) * -1e30).astype(np.float32)
    prim = tuple(jnp.asarray(x).astype(jdt) for x in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    ctx_j, vjp = jax.vjp(lambda a, b, c: _jax_core(a, b, c, jb, dk, jdt), *prim)
    g_j = vjp(jnp.asarray(dctx).astype(jdt))

    qt, kt, vt, dt = (torch.from_numpy(x).to(tdt) for x in (q, k, v, dctx))
    tb = None if bias is None else torch.from_numpy(bias)
    ctx_t, (row_max, row_sum) = ttd.decoder_attention_fwd_plain(qt, kt, vt, tb, save=True)
    w_t = ttd.decoder_attention_weights(qt, kt, tb, row_max, row_sum)
    assert ctx_t.dtype == tdt and w_t.dtype == row_max.dtype == row_sum.dtype == torch.float32
    _close(ctx_t.float().numpy(), _np(ctx_j), dtype, out=True)
    if mode == "self":  # no weight above the diagonal
        assert float(torch.triu(w_t, diagonal=1).abs().max()) == 0.0
    else:
        np.testing.assert_allclose(w_t[2].numpy(), 1.0 / S, rtol=1e-6)
    g_t = ttd.decoder_attention_bwd_plain(qt, kt, vt, tb, row_max, row_sum, dt)
    for a, b in zip(g_t, g_j):
        assert a.dtype == tdt
        _close(a.float().numpy(), _np(b), dtype)


def _k5_operands(mode, tdt, seed, B=3, Q=6, nh=2, S=5, dk=8, dv=16):
    """q, k, v in ``tdt`` and the key bias (None: causal, S = Q); the bias
    masks a ragged tail and every key of the last row."""
    rng = np.random.default_rng(seed)
    S, dv = (Q, dk) if mode == "self" else (S, dv)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(tdt)
               for s in ((B, Q, nh, dk), (B, S, nh, dk), (B, S, nh, dv)))
    bias = None
    if mode == "cross":
        lens = np.array([S] + [int(x) for x in rng.integers(1, S + 1, B - 2)] + [0])
        bias = torch.from_numpy(((1.0 - (np.arange(S)[None, :] < lens[:, None])) * -1e30)
                                .astype(np.float32))
    return q, k, v, bias


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["self", "cross"])
def test_k5_weights_from_saved_statistics(mode, dtype):
    """The weights rebuilt from the forward's saved row statistics are the
    ones the forward's context was summed from, bit for bit; the serving
    forward (nothing saved) gives the same context; each row sums to one."""
    _, tdt = DTYPES[dtype]
    q, k, v, bias = _k5_operands(mode, tdt, seed=7)
    ctx, (row_max, row_sum) = ttd.decoder_attention_fwd(q, k, v, bias, save=True)
    B, Q, nh, _ = q.shape
    assert tuple(row_max.shape) == tuple(row_sum.shape) == (B, nh, Q)
    w = ttd.decoder_attention_weights(q, k, bias, row_max, row_sum)
    assert torch.equal(torch.einsum("bhqk,bkhd->bqhd", w.to(tdt), v), ctx)
    ctx_serve, none = ttd.decoder_attention_fwd(q, k, v, bias)
    assert none is None and torch.equal(ctx_serve, ctx)
    np.testing.assert_allclose(w.sum(dim=-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("S", [1, 5, 9])
def test_k5_length_zero_memory_row_is_uniform(S):
    """A memory of length 0 (-1e30 on every key) gets the reference's
    uniform softmax over all S keys: every weight 1/S, its context the mean
    of its values, and its values' gradient the mean of the cotangent."""
    q, k, v, _ = _k5_operands("cross", torch.float32, seed=S, S=S)
    bias = torch.zeros((q.shape[0], S))
    bias[-1] = -1e30
    ctx, (row_max, row_sum) = ttd.decoder_attention_fwd(q, k, v, bias, save=True)
    w = ttd.decoder_attention_weights(q, k, bias, row_max, row_sum)
    np.testing.assert_allclose(w[-1].numpy(), 1.0 / S, rtol=1e-6)
    np.testing.assert_allclose(ctx[-1].numpy(), v[-1].mean(dim=0, keepdim=True)
                               .expand_as(ctx[-1]).numpy(), atol=1e-6, rtol=1e-5)
    dctx = torch.ones_like(ctx)
    _, _, dv = ttd.decoder_attention_bwd(q, k, v, bias, row_max, row_sum, dctx)
    np.testing.assert_allclose(dv[-1].numpy(), q.shape[1] / S, rtol=1e-5)


def _setup(seed, jdt, tdt, m_len=(7, 4, 0), S=7):
    params = jax.tree_util.tree_map(
        np.asarray, jtd.transformer_decoder_init(jax.random.PRNGKey(seed), CFG, [M], V))
    rng = np.random.default_rng(seed)
    memory = rng.standard_normal((len(m_len), S, M)).astype(np.float32)
    m_len = np.array(m_len, np.int32)
    return params, memory, m_len, rng


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_teacher_forced_gradients_match_jax_grad(dtype):
    """Every decoder leaf and the memory values, through K5's plain twins
    inside ``DecoderAttention`` (causal self attention and cross attention
    with a memory of length 0), against jax.grad of the JAX
    ``teacher_forced_logits`` for a random cotangent of the logits."""
    jdt, tdt = DTYPES[dtype]
    params, memory, m_len, rng = _setup(0, jdt, tdt)
    targets = rng.integers(3, V, (3, 6)).astype(np.int32)
    t_len = np.array([6, 3, 1], np.int32)
    r = rng.standard_normal((3, 6, V)).astype(np.float32)

    def loss_j(p, mem):
        m = jattn.prepare_memory("value_only", p["atts"][0], mem, jnp.asarray(m_len),
                                 compute_dtype=jdt)
        lg = jtd.teacher_forced_logits(p, CFG, jnp.asarray(targets), jnp.asarray(t_len), [m],
                                       compute_dtype=jdt)
        return jnp.sum(lg * r)

    g_pj, g_mj = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(memory))

    tp = convert.from_jax(params, device="cpu")
    for leaf in jax.tree_util.tree_leaves(tp):
        leaf.requires_grad_(True)
    mem_t = torch.from_numpy(memory).requires_grad_(True)
    m = tattn.prepare_memory("value_only", tp["atts"][0], mem_t, torch.from_numpy(m_len), tdt)
    lg = ttd.teacher_forced_logits(tp, CFG, torch.from_numpy(targets), torch.from_numpy(t_len),
                                   [m], tdt)
    (lg * torch.from_numpy(r)).sum().backward()

    flat_j = jax.tree_util.tree_leaves(g_pj)
    flat_t = jax.tree_util.tree_leaves(tp)
    assert len(flat_j) == len(flat_t) == 23  # 6 top-level + 17 of the one layer
    for a, b in zip(flat_t, flat_j):
        _close(a.grad.numpy(), _np(b), dtype)
    _close(mem_t.grad.numpy(), _np(g_mj), dtype)


def test_teacher_forced_gradients_match_jax_grad_two_layers():
    """Two decoder layers over one memory whose rows are full, ragged and of
    length 0, labels of lengths 5, 2 and 4: every decoder leaf and the
    memory values through K5's twins inside ``DecoderAttention`` (the row
    statistics saved, the weights recomputed in the backward) against
    jax.grad of the JAX ``teacher_forced_logits``, under the bf16 policy."""
    jdt, tdt = DTYPES["bfloat16"]
    cfg = dataclasses.replace(CFG, hidden_units=(32, 32))
    params = jax.tree_util.tree_map(
        np.asarray, jtd.transformer_decoder_init(jax.random.PRNGKey(3), cfg, [M], V))
    rng = np.random.default_rng(3)
    memory = rng.standard_normal((3, 9, M)).astype(np.float32)
    m_len = np.array([9, 0, 4], np.int32)
    targets = rng.integers(3, V, (3, 5)).astype(np.int32)
    t_len = np.array([5, 2, 4], np.int32)
    r = rng.standard_normal((3, 5, V)).astype(np.float32)

    def loss_j(p, mem):
        m = jattn.prepare_memory("value_only", p["atts"][0], mem, jnp.asarray(m_len),
                                 compute_dtype=jdt)
        lg = jtd.teacher_forced_logits(p, cfg, jnp.asarray(targets), jnp.asarray(t_len), [m],
                                       compute_dtype=jdt)
        return jnp.sum(lg * r)

    g_pj, g_mj = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(memory))
    tp = convert.from_jax(params, device="cpu")
    for leaf in jax.tree_util.tree_leaves(tp):
        leaf.requires_grad_(True)
    mem_t = torch.from_numpy(memory).requires_grad_(True)
    m = tattn.prepare_memory("value_only", tp["atts"][0], mem_t, torch.from_numpy(m_len), tdt)
    lg = ttd.teacher_forced_logits(tp, cfg, torch.from_numpy(targets), torch.from_numpy(t_len),
                                   [m], tdt)
    (lg * torch.from_numpy(r)).sum().backward()
    flat_j = jax.tree_util.tree_leaves(g_pj)
    flat_t = jax.tree_util.tree_leaves(tp)
    assert len(flat_j) == len(flat_t) == 40  # 6 top-level + 17 per layer
    for a, b in zip(flat_t, flat_j):
        _close(a.grad.numpy(), _np(b), "bfloat16")
    _close(mem_t.grad.numpy(), _np(g_mj), "bfloat16")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_teacher_forced_pass_saves_no_weights(dtype):
    """A teacher-forced pass with ``requires_grad`` parameters keeps no
    tensor of the attention weights' [B, nh, Q, S] shape for its backward
    (neither the self attention's [B, nh, Q, Q] nor the cross attention's
    [B, nh, Q, S]): ``DecoderAttention`` saves the operands, the bias and
    the row statistics [B, nh, Q]."""
    jdt, tdt = DTYPES[dtype]
    params, memory, m_len, rng = _setup(5, jdt, tdt, S=9, m_len=(9, 3, 0))
    targets = torch.from_numpy(rng.integers(3, V, (3, 6)).astype(np.int64))
    tp = convert.from_jax(params, device="cpu")
    for leaf in jax.tree_util.tree_leaves(tp):
        leaf.requires_grad_(True)
    saved = []

    def pack(x):
        saved.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        m = tattn.prepare_memory("value_only", tp["atts"][0], torch.from_numpy(memory),
                                 torch.from_numpy(m_len), tdt)
        lg = ttd.teacher_forced_logits(tp, CFG, targets, torch.tensor([6, 3, 1]), [m], tdt)
    B, Q, S, nh = 3, 6, 9, CFG.num_heads
    assert saved and (B, nh, Q) in saved  # the row statistics
    assert (B, nh, Q, Q) not in saved and (B, nh, Q, S) not in saved
    lg.sum().backward()
    assert all(leaf.grad is not None for leaf in jax.tree_util.tree_leaves(tp))


@pytest.mark.parametrize("kernel", ["K4", "K5 self", "K5 cross", "K11"])
def test_core_route_functions_save_weights(kernel, monkeypatch):
    """On the CUDA-core route (a head width with no tensor-core instance)
    each autograd Function saves the forward's fp32 weights in place of the
    row statistics and takes its backward from them: with the forward
    wrapper made to return that residual, the saved tensors hold the
    weights' shape and the gradients equal the statistics route's."""
    from avsr_tpu_torch.models import fusion as tfus
    from avsr_tpu_torch.models import transformer as ttfm

    rng = np.random.default_rng(11)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    B, T, nh = 2, 5, 2
    if kernel == "K11":
        qkv, lens = t(B, T, 3, nh, 8), torch.tensor([5, 0], dtype=torch.int32)
        ops, wshape = (qkv,), (B, nh, T, T)

        def run(x):
            return ttfm.EncoderSelfAttention.apply(x, lens)

        def fwd(x, lengths, *, save):
            ctx, st = ttfm.encoder_self_attention_fwd_plain(x, lengths, save=save)
            return ctx, ((ttfm.encoder_self_attention_weights(x, lengths, *st),) if save
                         else None)
        patch = (ttfm, "encoder_self_attention_fwd", fwd)
    elif kernel == "K4":
        ops, vl = (t(B, T, nh, 8), t(B, 7, nh, 8), t(B, 7, nh, 16)), torch.tensor([7, 0])
        wshape = (B, nh, T, 7)

        def run(q, k, v):
            return tfus.FusionAttention.apply(q, k, v, vl)[0]

        def fwd(q, k, v, lengths, *, save=False):
            ctx, w, _ = tfus.fusion_attention_fwd_plain(q, k, v, lengths)
            return ctx, w, ((w,) if save else None)
        patch = (tfus, "fusion_attention_fwd", fwd)
    else:
        S = T if kernel == "K5 self" else 6
        ops = (t(B, T, nh, 8), t(B, S, nh, 8), t(B, S, nh, 16))
        bias = None if kernel == "K5 self" else torch.tensor([[0.0] * 6, [-1e30] * 6])
        wshape = (B, nh, T, S)

        def run(q, k, v):
            return ttd.DecoderAttention.apply(q, k, v, bias)

        def fwd(q, k, v, b, *, save=False):
            ctx, st = ttd.decoder_attention_fwd_plain(q, k, v, b, save=save)
            return ctx, ((ttd.decoder_attention_weights(q, k, b, *st),) if save else None)
        patch = (ttd, "decoder_attention_fwd", fwd)

    def grads():
        xs = [x.clone().requires_grad_(True) for x in ops]
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x.shape) or x,
                                                      lambda x: x):
            out = run(*xs)
        out.backward(torch.ones_like(out))
        return [x.grad for x in xs], saved

    want, saved_stats = grads()
    monkeypatch.setattr(*patch)
    got, saved_weights = grads()
    assert wshape not in saved_stats and wshape in saved_weights
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_attention_family_routing_table():
    """The head widths each attention kernel runs on the tensor cores (K5's
    cross attention at (128, 256) on kernels of its own, "cross"); every
    other pair of multiples of 8 takes the CUDA-core family, and a width
    that is not a multiple of 8 (or not positive) is refused."""
    fam = kernels.attention_family
    assert fam("decoder_self_attention", 64, 64) == "mma"
    assert fam("decoder_cross_attention", 128, 256) == "cross"
    assert fam("decoder_self_attention", 32, 32) == "core"
    assert fam("decoder_cross_attention", 64, 128) == "core"
    assert fam("decoder_self_attention", 128, 256) == "core"
    assert fam("decoder_cross_attention", 64, 64) == "core"
    assert fam("fusion_attention", 128, 128) == fam("fusion_attention", 128, 64) == "mma"
    assert fam("fusion_attention", 64, 64) == fam("fusion_attention", 64, 128) == "core"
    assert fam("encoder_attention", 64, 64) == "mma"
    assert fam("encoder_attention", 32, 32) == fam("encoder_attention", 128, 128) == "core"
    assert fam("encoder_attention", 8, 8) == "core"
    for dk, dv in ((12, 12), (64, 20), (0, 64), (-8, 8)):
        with pytest.raises(ValueError, match="multiples of 8"):
            fam("decoder_cross_attention", dk, dv)
    with pytest.raises(KeyError):
        fam("decode_attention", 64, 64)


def test_decoder_attention_function_returns_no_bias_gradient():
    """The autograd Function gives q, k and v their gradients and the key
    bias none; without a gradient to record it runs the forward alone."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_(True)
               for s in ((2, 3, 2, 8), (2, 4, 2, 8), (2, 4, 2, 8)))
    bias = torch.zeros((2, 4), requires_grad=False)
    out = ttd.decoder_attention(q, k, v, bias)
    assert out.grad_fn is not None and "DecoderAttention" in type(out.grad_fn).__name__
    out.sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in (q, k, v))
    with torch.no_grad():
        assert ttd.decoder_attention(q, k, v, bias).grad_fn is None
    assert ttd.decoder_attention_fwd(q, k, v, None)[1] is None  # no residual unless saved


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_step_with_empty_memory_matches_jax(dtype):
    """``decode_step`` (K6's two reads per layer) over six positions, with
    a memory of length 0 in the batch, logits and caches against JAX."""
    jdt, tdt = DTYPES[dtype]
    params, memory, m_len, rng = _setup(2, jdt, tdt, m_len=(7, 0, 3))
    tol = dict(atol=1e-5, rtol=1e-4) if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    tparams = convert.from_jax(params, device="cpu")
    mem_j = jattn.prepare_memory("value_only", params["atts"][0], jnp.asarray(memory),
                                 jnp.asarray(m_len), compute_dtype=jdt)
    mem_t = tattn.prepare_memory("value_only", tparams["atts"][0], torch.from_numpy(memory),
                                 torch.from_numpy(m_len), tdt)
    cross_j = jtd.prepare_cross(params, CFG, [mem_j], compute_dtype=jdt)
    cross_t = ttd.prepare_cross(tparams, CFG, [mem_t], tdt)
    L = 6
    state_j = jtd.initial_cache(CFG, 3, L, dtype=jdt)
    state_t = ttd.initial_cache(CFG, 3, L, tdt, "cpu")
    for _ in range(L):
        tokens = rng.integers(0, V, (3,)).astype(np.int32)
        state_j, logits_j = jtd.decode_step(params, CFG, jnp.asarray(tokens), state_j,
                                            [mem_j], cross_j, compute_dtype=jdt)
        state_t, logits_t = ttd.decode_step(tparams, CFG, torch.from_numpy(tokens).long(),
                                            state_t, [mem_t], cross_t, tdt)
        np.testing.assert_allclose(logits_t.numpy(), _np(logits_j), **tol)
    for (kt, vt), (kj, vj) in zip(state_t.caches, state_j.caches):
        np.testing.assert_allclose(kt.float().numpy(), _np(kj), **tol)
        np.testing.assert_allclose(vt.float().numpy(), _np(vj), **tol)


@pytest.mark.parametrize("n_keys", [1, 4, 6])
def test_decode_attention_twin_matches_jax_rows(n_keys):
    """The K6 twin against the reference's single-query lines: self
    attention at position n_keys - 1 over a cache whose later rows hold
    junk, and cross attention with a length-0 row (uniform weights)."""
    rng = np.random.default_rng(n_keys)
    N, L, nh, dk, dv = 3, 6, 2, 8, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((N, nh, dk), (N, L, nh, dk), (N, L, nh, dv)))
    pos = n_keys - 1
    s = jnp.einsum("nhd,nlhd->nhl", q, k).astype(jnp.float32) / np.sqrt(dk)
    causal = (jnp.arange(L)[None, :] <= pos).astype(jnp.float32)
    want = jnp.einsum("nhl,nlhd->nhd", jax.nn.softmax(s + (1.0 - causal)[:, None, :] * -1e9,
                                                      axis=-1), v)
    got = ttd.decode_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), None, n_keys)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)

    lens = np.array([L, 2, 0])
    bias = ((1.0 - (np.arange(L)[None, :] < lens[:, None])) * -1e30).astype(np.float32)
    want = jnp.einsum("nhl,nlhd->nhd", jax.nn.softmax(s + bias[:, None, :], axis=-1), v)
    got = ttd.decode_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                     torch.from_numpy(bias), L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), v[2].mean(axis=0), atol=1e-5, rtol=1e-4)


def test_decoder_launchers_reject_cpu_tensors():
    """The CUDA side of K5, K6 and K7 never computes on the CPU: each
    launcher checks the device before building or launching, and counts no
    launch.  K5 at both masks, the tensor-core and the CUDA-core widths."""
    bf = torch.bfloat16
    q = torch.zeros(1, 3, 2, 8, dtype=bf)
    kv = torch.zeros(1, 3, 2, 8, dtype=bf)
    stats = torch.zeros(1, 2, 3), torch.ones(1, 2, 3)
    before = dict(kernels.LAUNCHES)
    for bias in (None, torch.zeros(1, 3)):
        with pytest.raises(ValueError, match="expected a tensor on"):
            kernels.decoder_attention_fwd(q, kv, kv, bias, save=True)
        with pytest.raises(ValueError, match="expected a tensor on"):
            kernels.decoder_attention_bwd(q, kv, kv, bias, *stats, q)
    q64, kv64 = torch.zeros(1, 3, 2, 64, dtype=bf), torch.zeros(1, 3, 2, 64, dtype=bf)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.decoder_attention_fwd(q64, kv64, kv64, None, save=True)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.decoder_attention_bwd(q64, kv64, kv64, None, *stats, q64)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.attention_bwd_core("decoder_attention", q, kv, kv, torch.zeros(1, 2, 3, 3), q)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.decode_attention(q[:, 0], kv, kv, None, 2)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.beam_step(torch.zeros(6, 5), torch.zeros(2, 3),
                          torch.zeros(2, 3, dtype=torch.int32),
                          torch.zeros(2, 3, dtype=torch.bool), torch.ones(4),
                          torch.zeros(2, 3, dtype=torch.int64),
                          torch.zeros(2, 3, dtype=torch.int64), step_buffers(2, 3, "cpu"))
    assert kernels.LAUNCHES == before
