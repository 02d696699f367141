"""Gradient of the port's cross-attention fusion (K4) against
``avsr_tpu.models.fusion``.

On CPU tensors ``FusionAttention`` runs the plain forward and backward
twins (``fusion_attention_fwd_plain`` / ``fusion_attention_bwd_plain``);
these tests hold them, inside the whole fusion block, against ``jax.vjp``
of ``cross_attention_fusion_apply`` on the same seeded numpy inputs and
weights, with a video row of length 0 (the reference's uniform softmax).
The backward's residual is the softmax's row statistics, not the weights:
the weights rebuilt from them are the forward's, and ``FusionAttention``
saves no [B, nh, T_a, T_v] tensor.

Tolerances: fp32 at atol 1e-5 / rtol 1e-4 (JAX matmuls at "highest"
precision, only summation order differs).  Under the bf16 policy both
sides round the scores, the weights and the products to bf16 at the same
points; a value within one ulp of a rounding boundary can land 2^-8
relative apart after another summation order, so gradients are held at
3e-2 of the largest reference value and outputs at atol/rtol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import FusionConfig
from avsr_tpu.models import fusion as jfus
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.models import fusion as tfus

DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}
CFG = FusionConfig(fusion_type="cross_attention", num_heads=4, attention_units=8,
                   au_loss_weight=10.0)


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


def _inputs(seed=0, Da=16, Dv=24):
    params = jax.tree_util.tree_map(
        np.asarray, jfus.cross_attention_fusion_init(jax.random.PRNGKey(seed), CFG, Da, Dv))
    rng = np.random.default_rng(seed)
    return dict(
        params=params,
        audio=rng.standard_normal((6, 3, Da)).astype(np.float32),
        video=rng.standard_normal((3, 9, Dv)).astype(np.float32),
        a_len=np.array([6, 4, 2], np.int32),
        v_len=np.array([9, 5, 0], np.int32),
        r_fused=rng.standard_normal((6, 3, Da + Dv)).astype(np.float32),
        r_au=rng.standard_normal((6, 3, CFG.au_dim)).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fusion_grads_match_jax_vjp(dtype):
    """Gradients of every fusion parameter and of both inputs, through the
    fused memory and the AU head, with a 0-length video row."""
    jdt, tdt = DTYPES[dtype]
    d = _inputs()

    def loss_j(params, audio, video):
        o = jfus.cross_attention_fusion_apply(
            params, CFG, audio, jnp.asarray(d["a_len"]), video, jnp.asarray(d["v_len"]),
            compute_dtype=jdt)
        return jnp.sum(o.fused * d["r_fused"]) + jnp.sum(o.au_predictions * d["r_au"]), o

    (l_j, o_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2), has_aux=True)(
        d["params"], jnp.asarray(d["audio"]), jnp.asarray(d["video"]))

    params = {k: v.requires_grad_(True)
              for k, v in convert.from_jax(d["params"], device="cpu").items()}
    audio = torch.from_numpy(d["audio"]).requires_grad_(True)
    video = torch.from_numpy(d["video"]).requires_grad_(True)
    o_t = tfus.cross_attention_fusion_apply(
        params, CFG, audio, torch.from_numpy(d["a_len"]), video, torch.from_numpy(d["v_len"]),
        tdt)
    loss = (torch.sum(o_t.fused * torch.from_numpy(d["r_fused"]))
            + torch.sum(o_t.au_predictions * torch.from_numpy(d["r_au"])))
    loss.backward()
    for a, b in zip(o_t, o_j):
        _close(a.detach().numpy(), _np(b), dtype, out=True)
    for k in params:
        _close(params[k].grad.numpy(), _np(g_j[0][k]), dtype)
    _close(audio.grad.numpy(), _np(g_j[1]), dtype)
    _close(video.grad.numpy(), _np(g_j[2]), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_core_twins_match_jax_core_vjp(dtype):
    """The plain forward and backward twins against jax.vjp of the
    reference's core lines (fusion.py:226-235) on the same q, k, v."""
    jdt, tdt = DTYPES[dtype]
    B, Ta, Tv, nh, A = 2, 5, 7, 2, 8
    rng = np.random.default_rng(1)
    q, k, v, dctx = (rng.standard_normal(s).astype(np.float32)
                     for s in ((B, Ta, nh, A), (B, Tv, nh, A), (B, Tv, nh, A), (B, Ta, nh, A)))
    v_len = np.array([7, 0], np.int32)

    def core(q, k, v):
        s = jnp.einsum("bqha,bkha->bhqk", q, k).astype(jnp.float32) / jnp.sqrt(jnp.float32(A))
        valid = (jnp.arange(Tv)[None, :] < v_len[:, None]).astype(jnp.float32)
        w = jax.nn.softmax(s + (1.0 - valid)[:, None, None, :] * -1e9, axis=-1)
        return jnp.einsum("bhqk,bkhd->bqhd", w.astype(jdt), v), w

    prim = tuple(jnp.asarray(x).astype(jdt) for x in (q, k, v))
    (ctx_j, w_j), vjp = jax.vjp(core, *prim)
    g_j = vjp((jnp.asarray(dctx).astype(jdt), jnp.zeros_like(w_j)))
    qt, kt, vt, dt = (torch.from_numpy(x).to(tdt) for x in (q, k, v, dctx))
    vl = torch.from_numpy(v_len)
    ctx_t, w_t, stats = tfus.fusion_attention_fwd_plain(qt, kt, vt, vl, save=True)
    _close(ctx_t.float().numpy(), _np(ctx_j), dtype, out=True)
    _close(w_t.numpy(), _np(w_j), dtype, out=True)
    np.testing.assert_allclose(w_t[1].numpy(), 1.0 / Tv, rtol=1e-6)  # no video: uniform
    g_t = tfus.fusion_attention_bwd_plain(qt, kt, vt, vl, *stats, dt)
    for a, b in zip(g_t, g_j):
        assert a.dtype == tdt
        _close(a.float().numpy(), _np(b), dtype)


def test_alignment_weights_take_no_gradient():
    d = _inputs(2)
    params = {k: v.requires_grad_(True)
              for k, v in convert.from_jax(d["params"], device="cpu").items()}
    o = tfus.cross_attention_fusion_apply(
        params, CFG, torch.from_numpy(d["audio"]), torch.from_numpy(d["a_len"]),
        torch.from_numpy(d["video"]), torch.from_numpy(d["v_len"]), torch.float32)
    assert o.fused.requires_grad and not o.alignments.requires_grad
    with pytest.raises(RuntimeError, match="take no gradient"):
        tfus.FusionAttention.backward(None, None, torch.ones(1))


def test_au_regression_loss_matches_jax():
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((7, 4, 2)).astype(np.float32)
    tgt = rng.standard_normal((7, 4, 2)).astype(np.float32)
    lengths = np.array([7, 3, 0, 5], np.int32)
    rows = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    for rw in (None, rows):
        want = jfus.au_regression_loss(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(lengths),
                                       row_weights=None if rw is None else jnp.asarray(rw))
        got = tfus.au_regression_loss(torch.from_numpy(pred), torch.from_numpy(tgt),
                                      torch.from_numpy(lengths),
                                      row_weights=None if rw is None else torch.from_numpy(rw))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_fusion_launchers_reject_cpu_tensors():
    """The CUDA side of K4 never computes on the CPU: it checks the device
    before building or launching, and counts no launch."""
    bf = torch.bfloat16
    q = torch.zeros(1, 3, 2, 8, dtype=bf)
    kv = torch.zeros(1, 4, 2, 8, dtype=bf)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.fusion_attention_fwd(q, kv, kv, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.fusion_attention_bwd(q, kv, kv, torch.ones(1, dtype=torch.int32),
                                     torch.zeros(1, 2, 3), torch.ones(1, 2, 3), q)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fusion_weights_from_saved_statistics(dtype):
    """The weights rebuilt from the forward's saved row statistics are the
    forward's own, bit for bit, with T_a != T_v and a video row of length
    0; the serving forward (nothing saved) gives the same context and
    weights."""
    _, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    B, Ta, Tv, nh, A, dv = 3, 6, 11, 2, 8, 16
    q, k = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(tdt)
            for s in ((B, Ta, nh, A), (B, Tv, nh, A)))
    v = torch.from_numpy(rng.standard_normal((B, Tv, nh, dv)).astype(np.float32)).to(tdt)
    vl = torch.tensor([11, 0, 4], dtype=torch.int32)
    ctx, w, (row_max, row_sum) = tfus.fusion_attention_fwd(q, k, v, vl, save=True)
    assert tuple(row_max.shape) == tuple(row_sum.shape) == (B, nh, Ta)
    assert row_max.dtype == row_sum.dtype == torch.float32
    assert torch.equal(tfus.fusion_attention_weights(q, k, vl, row_max, row_sum), w)
    ctx_serve, w_serve, none = tfus.fusion_attention_fwd(q, k, v, vl)
    assert none is None and torch.equal(ctx_serve, ctx) and torch.equal(w_serve, w)
    np.testing.assert_allclose(w[1].numpy(), 1.0 / Tv, rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 5, 7, 2, 8, 8), (3, 9, 4, 4, 16, 8)])
def test_fusion_attention_saves_no_weights(shape):
    """``FusionAttention`` keeps for its backward the operands, the video
    lengths and the softmax's row statistics [B, nh, T_a]: no tensor of the
    weights' [B, nh, T_a, T_v] shape, and nothing of T_a x T_v elements per
    head; the weights it returns still carry no gradient."""
    B, Ta, Tv, nh, A, dv = shape
    rng = np.random.default_rng(Ta)
    q, k = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_(True)
            for s in ((B, Ta, nh, A), (B, Tv, nh, A)))
    v = torch.from_numpy(rng.standard_normal((B, Tv, nh, dv)).astype(np.float32))
    v.requires_grad_(True)
    vl = torch.from_numpy(rng.integers(0, Tv + 1, size=B).astype(np.int32))
    saved = []

    def pack(x):
        saved.append(x)
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out, w = tfus.FusionAttention.apply(q, k, v, vl)
    assert [tuple(x.shape) for x in saved] == [(B, Ta, nh, A), (B, Tv, nh, A), (B, Tv, nh, dv),
                                               (B,), (B, nh, Ta), (B, nh, Ta)]
    assert saved[0] is q and saved[1] is k and saved[2] is v and saved[3] is vl
    assert all(x.numel() < B * nh * Ta * Tv or x is q or x is k or x is v for x in saved)
    assert not w.requires_grad
    out.backward(torch.ones_like(out))
    assert all(x.grad is not None and x.grad.shape == x.shape for x in (q, k, v))
