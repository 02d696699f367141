"""The backward of the attention read (K10, ``BahdanauAttend``, with the
Bahdanau and the Luong score) and of the AV-Align fusion scan (K8,
``AVAlignScan``, either score) against ``jax.vjp`` of
``avsr_tpu.ops.attention.attend`` and ``avsr_tpu.models.fusion.av_align_apply``.

On CPU tensors both run their plain versions (K10's read loop its mirror
``read_step_bwd_plain`` / ``read_loop_sums_plain``, a read outside a loop
being a loop of one step; K8 ``av_align_scan_bwd_plain``), so these tests
hold the hand-derived backward to JAX's autodiff.  Inputs and cotangents come
from seeded numpy, weights from the JAX package's init, converted with
``convert.from_jax``; ragged lengths include a length-0 memory row (K10),
and a length-0 audio row and a length-0 video row (K8).

Tolerances, as the relative error of each gradient's norm against JAX's:
fp32 1e-5 (K8: 25 recurrent steps of fp32 sums in another order; the
weight gradients are one product over all steps where the reference sums
per-step products; seen: 6e-7); the bf16 policy 1e-2 (both sides round the
same operands and cotangents to bf16, but an energy, a gate input or a
cotangent on a rounding boundary can flip by one ulp, 2^-8 relative, and
the recurrence carries it on; the reference also rounds each step's weight
gradient to bf16 before summing, the port sums the steps first; seen:
3.2e-3 on dv).  The empty rows' gradients are exactly zero on both sides.
Luong's tolerances are the same: its bf16 roundings (q before the dot, the
cotangents dq and dkeys of the two casts) are the reference's, and the
transposed products return bf16 on both sides (JAX's CPU backend and the
port both sum them in fp32 here and round once: the bf16 cases agree to
the last bit at these sizes, the fp32 ones to 2e-7).  A Luong memory
without ``wv`` is one tensor as keys and values: its gradient is the sum
of both paths, which the memory-level test below holds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import FusionConfig
from avsr_tpu.models import fusion as jfus
from avsr_tpu.ops import attention as jattn
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.configs import FusionConfig as TFusionConfig
from avsr_tpu_torch.models import fusion as tfus
from avsr_tpu_torch.ops import attention as tattn

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


# ---- K10: the Bahdanau read -------------------------------------------------


def _attend_case(dtype, seed=0, lengths=(7, 3, 0, 5), S=7, H=6, Q=5, A=8):
    jdt, tdt = DT[dtype]
    rng = np.random.default_rng(seed)
    N = len(lengths)
    params = jattn.attention_init("bahdanau", jax.random.PRNGKey(seed), Q, H, A)
    memory = rng.standard_normal((N, S, H)).astype(np.float32)
    query = rng.standard_normal((N, Q)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    dctx = rng.standard_normal((N, H)).astype(np.float32)
    mem = jattn.prepare_memory("bahdanau", params, jnp.asarray(memory), jnp.asarray(lens),
                               compute_dtype=jdt)

    def f(query, wq, v, keys, values):
        m = mem._replace(keys=keys, values=values)
        return jattn.attend("bahdanau", dict(params, wq=wq, v=v), query, m, compute_dtype=jdt)

    (ctx_j, w_j), vjp = jax.vjp(f, jnp.asarray(query), params["wq"], params["v"], mem.keys,
                                mem.values)
    want = vjp((jnp.asarray(dctx), jnp.zeros_like(w_j)))
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    leaves = [_leaf(torch.from_numpy(np.array(x, np.float32)))
              for x in (query, params["wq"], params["v"], mem.keys, mem.values)]
    tmem = tattn.AttentionMemory(values=leaves[4], keys=leaves[3],
                                 mask=torch.from_numpy(np.asarray(mem.mask)),
                                 bias=torch.from_numpy(np.asarray(mem.bias)))
    ctx_t, w_t = tattn.attend("bahdanau", dict(tp, wq=leaves[1], v=leaves[2]), leaves[0], tmem,
                              tdt)
    got = torch.autograd.grad(ctx_t, leaves, torch.from_numpy(dctx))
    return ctx_t, w_t, got, want, ctx_j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_gradients_match_jax(dtype):
    """dquery, dwq, dv, dkeys, dvalues over a batch with full, ragged and
    empty memories."""
    ctx_t, _, got, want, ctx_j = _attend_case(dtype)
    np.testing.assert_allclose(ctx_t.detach().numpy(), np.asarray(ctx_j),
                               atol=1e-5 if dtype == "float32" else 1e-2)
    for name, g, w in zip(("dquery", "dwq", "dv", "dkeys", "dvalues"), got, want):
        assert tuple(g.shape) == w.shape, name
        assert _rel(g.numpy(), w) < TOL[dtype], (name, _rel(g.numpy(), w))
    # row 2's memory is empty: its query, keys and values get exactly nothing
    for g in (got[0], got[3], got[4]):
        assert float(g[2].abs().max()) == 0.0
    # padded positions of row 1 (length 3) get no key or value gradient
    assert float(got[3][1, 3:].abs().max()) == 0.0 and float(got[4][1, 3:].abs().max()) == 0.0


def test_attend_returns_outputs_with_a_grad_fn():
    """The repaired fault: on a grad-requiring input ``attend`` goes through
    ``BahdanauAttend`` (on a GPU its forward is the ctypes kernel, whose
    raw outputs carry no grad_fn); the weights are marked
    non-differentiable."""
    ctx_t, w_t, _, _, _ = _attend_case("float32")
    assert ctx_t.grad_fn is not None and "BahdanauAttend" in type(ctx_t.grad_fn).__name__
    assert not w_t.requires_grad
    with torch.no_grad():
        _, tp, _, query, _, mem = _plain_setup()
        ctx, _ = tattn.attend("bahdanau", tp, query, mem, torch.float32)
    assert ctx.grad_fn is None


def _plain_setup(seed=1, N=3, S=5, H=6, Q=4, A=8, attention_type="bahdanau"):
    gen = torch.Generator().manual_seed(seed)
    tp = tattn.attention_init(attention_type, gen, Q, H, A, "cpu")
    memory = torch.randn((N, S, H), generator=gen)
    query = torch.randn((N, Q), generator=gen)
    mem = tattn.prepare_memory(attention_type, tp, memory, torch.tensor([S, 2, 0]),
                               torch.float32)
    return gen, tp, memory, query, S, mem


@pytest.mark.parametrize("attention_type", ["bahdanau", "luong"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_bwd_twin_matches_autograd_of_the_forward_twin(dtype, attention_type):
    """The hand-derived twin against torch's autodiff of ``attend_plain``
    (whose casts round the cotangents as JAX's do): dquery and the memory
    gradients per call, and the weight gradients from the per-row factors."""
    _, tdt = DT[dtype]
    gen, tp, memory, query, S, _ = _plain_setup(attention_type=attention_type)
    tp = {k: _leaf(v) for k, v in tp.items()}
    q = _leaf(query)
    mem = tattn.prepare_memory(attention_type, tp, memory, torch.tensor([S, 2, 0]), tdt)
    keys, values = _leaf(mem.keys), _leaf(mem.values)
    mem = mem._replace(keys=keys, values=values)
    ctx, w = tattn.attend_plain(attention_type, tp, q, mem, tdt)
    dctx = torch.randn(ctx.shape, generator=gen)
    names = ["dquery", "dwq", "dv", "dkeys", "dvalues"]
    leaves = [q, tp["wq"], tp.get("v"), keys, values]
    if attention_type == "luong":  # no v
        del names[2], leaves[2]
    auto = torch.autograd.grad(ctx, leaves, dctx)
    dquery, dq, dv_rows, dkeys, dvalues = tattn.attend_bwd_plain(
        attention_type, tp, q.detach(), mem, w.detach(), dctx, tdt)
    dwq, dv = tattn.attention_weight_grads(q.detach(), dq, dv_rows, tdt)
    assert (dv is None) == (attention_type == "luong")
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, a, b in zip(names, [x for x in (dquery, dwq, dv, dkeys, dvalues) if x is not None],
                          auto):
        assert _rel(a.detach().numpy(), b.numpy()) < tol, name


@pytest.mark.parametrize("value_dim", [None, 4], ids=["keys-are-values", "value-projection"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_luong_attend_gradients_match_jax(dtype, value_dim):
    """The Luong read from the raw memory up: dquery, dwq (and dwv) and the
    memory's gradient against ``jax.vjp`` through ``prepare_memory`` and
    ``attend``; without ``wv`` the memory is the keys and the values, so its
    gradient is the sum of both paths.  Row 2's memory is empty."""
    jdt, tdt = DT[dtype]
    rng = np.random.default_rng(3)
    lens = np.asarray([7, 3, 0, 5], np.int32)
    N, S, H, Q = 4, 7, 6, 5
    params = jattn.attention_init("luong", jax.random.PRNGKey(3), Q, H, 0, value_dim=value_dim)
    memory = (2.0 * rng.standard_normal((N, S, H))).astype(np.float32)
    query = rng.standard_normal((N, Q)).astype(np.float32)
    dctx = rng.standard_normal((N, value_dim or H)).astype(np.float32)

    def f(params, query, memory):
        mem = jattn.prepare_memory("luong", params, memory, jnp.asarray(lens), compute_dtype=jdt)
        return jattn.attend("luong", params, query, mem, compute_dtype=jdt)

    (ctx_j, w_j), vjp = jax.vjp(f, params, jnp.asarray(query), jnp.asarray(memory))
    g_params, g_query, g_memory = vjp((jnp.asarray(dctx), jnp.zeros_like(w_j)))
    tp = {k: _leaf(v) for k, v in convert.from_jax(jax.tree_util.tree_map(np.asarray, params),
                                                   device="cpu").items()}
    q, m = _leaf(torch.from_numpy(query)), _leaf(torch.from_numpy(memory))
    mem = tattn.prepare_memory("luong", tp, m, torch.from_numpy(lens), tdt)
    ctx_t, w_t = tattn.attend("luong", tp, q, mem, tdt)
    assert "BahdanauAttend" in type(ctx_t.grad_fn).__name__
    np.testing.assert_allclose(ctx_t.detach().numpy(), np.asarray(ctx_j),
                               atol=1e-5 if dtype == "float32" else 1e-2)
    keys = sorted(tp)
    got = torch.autograd.grad(ctx_t, [q, m] + [tp[k] for k in keys], torch.from_numpy(dctx))
    want = [g_query, g_memory] + [g_params[k] for k in keys]
    for name, g, w in zip(["dquery", "dmemory"] + keys, got, want):
        assert tuple(g.shape) == w.shape, name
        assert _rel(g.numpy(), w) < TOL[dtype], (name, _rel(g.numpy(), w))
    for g in got[:2]:  # the empty row's query and memory get exactly nothing
        assert float(g[2].abs().max()) == 0.0
    assert float(got[1][1, 3:].abs().max()) == 0.0


def test_attend_weights_take_no_gradient():
    _, tp, _, query, _, mem = _plain_setup()
    q = _leaf(query)
    _, w = tattn.attend("bahdanau", tp, q, mem, torch.float32)
    with pytest.raises(RuntimeError):
        w.sum().backward()


def test_attend_bwd_kernel_rejects_cpu_tensors():
    """K10's per-step backward kernel (a read loop's step) refuses CPU
    tensors for either read and counts no launch."""
    N, S, A, Dv, Hq = 2, 5, 8, 16, 4
    f32, bf = torch.float32, torch.bfloat16
    z = torch.zeros
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.attend_step_bwd(z(N, Hq), z(Hq, A, dtype=bf), z(A, dtype=bf), z(N, S, A),
                                z(N, S, Dv, dtype=bf), z(N, S, dtype=f32), z(N, Dv), z(N, S),
                                z(N, Dv), z(N, A), z(N, A), z(N, A))
    with pytest.raises(ValueError, match="expected a tensor on"):  # the Luong read: no v
        kernels.attend_step_bwd(z(N, Hq), z(Hq, A, dtype=bf), None, z(N, S, A, dtype=bf),
                                z(N, S, Dv, dtype=bf), z(N, S, dtype=f32), z(N, Dv), z(N, S),
                                z(N, Dv), z(N, A), z(N, A), None)
    assert kernels.LAUNCHES == before


# ---- K8: the AV-Align fusion scan ------------------------------------------

T_A, B, D, H, T_V, H_V = 25, 4, 24, 32, 11, 20
A_LEN = [25, 17, 0, 9]
V_LEN = [11, 0, 6, 3]


def _fusion_case(dtype, seed=0, **kw):
    jdt, tdt = DT[dtype]
    cfg = FusionConfig(attention_units=8, au_loss_weight=1.0, au_dim=2, **kw)
    params = jfus.av_align_init(jax.random.PRNGKey(seed), cfg, D, H, H_V)
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((T_A, B, D)).astype(np.float32)
    video = rng.standard_normal((B, T_V, H_V)).astype(np.float32)
    a_len, v_len = np.asarray(A_LEN, np.int32), np.asarray(V_LEN, np.int32)
    ctx_dim = cfg.memory_value_dim or H_V
    d_fused = rng.standard_normal((T_A, B, H + ctx_dim)).astype(np.float32)
    d_au = rng.standard_normal((T_A, B, 2)).astype(np.float32)

    def f(params, audio, video):
        out = jfus.av_align_apply(params, cfg, audio, jnp.asarray(a_len), video,
                                  jnp.asarray(v_len), compute_dtype=jdt)
        return out.fused, out.au_predictions

    _, vjp = jax.vjp(f, params, jnp.asarray(audio), jnp.asarray(video))
    want = vjp((jnp.asarray(d_fused), jnp.asarray(d_au)))
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tparams = jax.tree_util.tree_map(_leaf, tparams)
    t_audio, t_video = _leaf(torch.from_numpy(audio)), _leaf(torch.from_numpy(video))
    out = tfus.av_align_apply(tparams, TFusionConfig(**dataclasses.asdict(cfg)), t_audio,
                              torch.from_numpy(a_len), t_video, torch.from_numpy(v_len), tdt)
    leaves = jax.tree_util.tree_leaves(tparams)
    got = torch.autograd.grad([out.fused, out.au_predictions], leaves + [t_audio, t_video],
                              [torch.from_numpy(d_fused), torch.from_numpy(d_au)])
    want_leaves = jax.tree_util.tree_leaves(convert.from_jax(
        jax.tree_util.tree_map(np.asarray, want[0]), device="cpu"))
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tparams)[0]]
    return (names + ["audio", "video"], got, want_leaves + [torch.from_numpy(np.asarray(
        want[1], np.float32)), torch.from_numpy(np.asarray(want[2], np.float32))], out)


@pytest.mark.parametrize("dtype, kw", [
    ("float32", {}),
    ("bfloat16", {}),
    ("float32", {"input_feeding": False}),
    ("float32", {"memory_value_dim": 12}),
    ("float32", {"attention_type": "luong"}),
    ("bfloat16", {"attention_type": "luong"}),
    ("float32", {"attention_type": "luong", "memory_value_dim": 12}),
], ids=["fp32", "bf16", "fp32-no-input-feeding", "fp32-value-projection", "fp32-luong",
        "bf16-luong", "fp32-luong-value-projection"])
def test_av_align_gradients_match_jax(dtype, kw):
    """Every parameter's gradient and those of the audio input and the
    video memory, through the fused memory and the AU head."""
    names, got, want, out = _fusion_case(dtype, **kw)
    assert out.fused.grad_fn is not None and not out.alignments.requires_grad
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        err = _rel(g.numpy(), w.numpy())
        assert err < TOL[dtype], (name, err)
    audio_g, video_g = got[-2], got[-1]
    # row 2 has no audio step, row 1 no video frame: their inputs get nothing
    assert float(audio_g[:, 2].abs().max()) == 0.0
    assert float(video_g[1].abs().max()) == 0.0
    assert float(audio_g[A_LEN[3]:, 3].abs().max()) == 0.0
    assert float(video_g[3, V_LEN[3]:].abs().max()) == 0.0


@pytest.mark.parametrize("attention_type", ["bahdanau", "luong"])
def test_av_align_final_carry_cotangents(attention_type):
    """The scan's final carries take a gradient too (the reference's scan
    carries h, c, ctx): dhT, dcT, dctxT through the Function against
    torch's autodiff of the plain forward twin."""
    cfg = TFusionConfig(attention_units=8, attention_type=attention_type)
    gen = torch.Generator().manual_seed(3)
    p = tfus.av_align_init(gen, cfg, D, H, H_V, "cpu")
    mem = tattn.prepare_memory(attention_type, p["att"], torch.randn(B, T_V, H_V, generator=gen),
                               torch.tensor(V_LEN), torch.float32)
    xw = torch.randn(8, B, 4 * H, generator=gen)
    mask = (torch.arange(8)[:, None] < torch.tensor([8, 5, 0, 3])[None, :]).float()
    cot = [torch.randn(s, generator=gen) for s in ((8, B, H), (8, B, H_V), (B, H), (B, H),
                                                    (B, H_V))]

    def grads(fn):
        leaves = [_leaf(x) for x in (p["cell"]["wh"], p["ctx_proj"], p["att"]["wq"], xw,
                                     mem.keys, mem.values)]
        cell = dict(p["cell"], wh=leaves[0])
        att = dict(p["att"], wq=leaves[2])
        m = mem._replace(keys=leaves[4], values=leaves[5])
        hs, ctxs, _, (hT, cT, ctxT) = fn(cell, att, leaves[1], leaves[3], mask, m,
                                         torch.float32, attention_type=attention_type)
        return torch.autograd.grad([hs, ctxs, hT, cT, ctxT], leaves, cot)

    for a, b in zip(grads(tfus.av_align_scan), grads(tfus.av_align_scan_plain)):
        assert _rel(a.numpy(), b.numpy()) < 1e-4


def test_av_align_alignments_take_no_gradient():
    cfg = TFusionConfig(attention_units=8)
    gen = torch.Generator().manual_seed(4)
    p = tfus.av_align_init(gen, cfg, D, H, H_V, "cpu")
    mem = tattn.prepare_memory("bahdanau", p["att"], torch.randn(B, T_V, H_V, generator=gen),
                               torch.tensor(V_LEN), torch.float32)
    xw = _leaf(torch.randn(3, B, 4 * H, generator=gen))
    _, _, aligns, _ = tfus.av_align_scan(p["cell"], p["att"], p["ctx_proj"], xw,
                                         torch.ones(3, B), mem, torch.float32)
    assert not aligns.requires_grad
    with pytest.raises(RuntimeError):
        aligns.sum().backward()


def test_av_align_bwd_kernel_rejects_cpu_tensors():
    f32, bf = torch.float32, torch.bfloat16
    T, Bn, Hn, S, A, Dv = 3, 2, 16, 5, 8, 16
    z = torch.zeros
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.av_align_scan_bwd(
            z(Hn, 4 * Hn, dtype=bf), z(4 * Hn), None, z(Hn, A, dtype=bf), z(A, dtype=bf),
            z(T, Bn, 4 * Hn), z(T, Bn), z(Bn, S, A), z(Bn, S, Dv, dtype=bf), z(T, Bn, S),
            z(T, Bn, Hn), z(T, Bn, Hn), z(T, Bn, Dv), z(T, Bn, Hn), z(T, Bn, Dv), z(Bn, Hn),
            z(Bn, Hn), z(Bn, Dv, dtype=f32))
