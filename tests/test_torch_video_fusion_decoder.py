"""Video CNN, cross-attention fusion and the decoder's KV-cache step of the
PyTorch port against their ``avsr_tpu`` counterparts.

Tolerances: fp32 at atol 1e-5 / rtol 1e-4 (JAX matmuls at "highest"
precision; only summation order differs).  Under the bf16 policy the two
frameworks round intermediate products to bf16 at the same places, but a
value within one ulp of a rounding boundary can round differently after a
different summation order, which moves it by 2^-8 relative; outputs of
order one are therefore held at atol/rtol 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import DecoderConfig, FusionConfig, VideoFrontendConfig
from avsr_tpu.models import fusion as jfus
from avsr_tpu.models import transformer_decoder as jtd
from avsr_tpu.models import video_cnn as jvc
from avsr_tpu.ops import attention as jattn
from avsr_tpu_torch import convert
from avsr_tpu_torch.models import fusion as tfus
from avsr_tpu_torch.models import transformer_decoder as ttd
from avsr_tpu_torch.models import video_cnn as tvc
from avsr_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

DTYPES = {
    "float32": (jnp.float32, torch.float32, dict(atol=1e-5, rtol=1e-4)),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2)),
}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(p):
    return jax.tree_util.tree_map(np.asarray, p)


def test_same_padding_matches_xla():
    assert [tvc.same_pads(s, 3, 2) for s in (36, 18, 9)] == [(0, 1), (0, 1), (1, 1)]
    assert [tuple(p) for p in jax.lax.padtype_to_pads((36, 18, 9), (3, 3, 3), (2, 2, 2), "SAME")] \
        == [(0, 1), (0, 1), (1, 1)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_video_cnn_matches_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    cfg = VideoFrontendConfig()  # 36x36x1, conv 8/16/32 stride 2, proj 128
    params = _params(jvc.video_cnn_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 1, (2, 5, 36, 36, 1)).astype(np.float32)
    lengths = np.array([5, 3], np.int32)
    ej, _ = jvc.video_cnn_apply(params, cfg, jnp.asarray(frames), jnp.asarray(lengths),
                                compute_dtype=jdt)
    et, _ = tvc.video_cnn_apply(convert.from_jax(params), cfg, torch.from_numpy(frames),
                                torch.from_numpy(lengths), tdt)
    assert tuple(et.shape) == (2, 5, 128) and et.dtype == torch.float32
    np.testing.assert_allclose(et.numpy(), _np(ej), **tol)
    assert torch.all(et[1, 3:] == 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cross_attention_fusion_matches_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    cfg = FusionConfig(fusion_type="cross_attention", num_heads=4, attention_units=8,
                       au_loss_weight=10.0)
    Da, Dv = 16, 24
    params = _params(jfus.cross_attention_fusion_init(jax.random.PRNGKey(1), cfg, Da, Dv))
    rng = np.random.default_rng(1)
    audio = rng.standard_normal((6, 2, Da)).astype(np.float32)
    video = rng.standard_normal((2, 9, Dv)).astype(np.float32)
    a_len, v_len = np.array([6, 4], np.int32), np.array([9, 5], np.int32)
    oj = jfus.cross_attention_fusion_apply(
        params, cfg, jnp.asarray(audio), jnp.asarray(a_len), jnp.asarray(video),
        jnp.asarray(v_len), compute_dtype=jdt)
    ot = tfus.cross_attention_fusion_apply(
        convert.from_jax(params), cfg, torch.from_numpy(audio), torch.from_numpy(a_len),
        torch.from_numpy(video), torch.from_numpy(v_len), tdt)
    for a, b in zip(ot, oj):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), _np(b), **tol)
    assert torch.all(ot.fused[4:, 1] == 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_step_matches_jax_over_several_positions(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    cfg = dataclasses.replace(
        DecoderConfig(), decoder_type="transformer", hidden_units=(32,), num_heads=4,
        attention_units=8, embedding_dim=16)
    N, S, M, V, L = 3, 7, 24, 20, 6
    params = _params(jtd.transformer_decoder_init(jax.random.PRNGKey(2), cfg, [M], V))
    tparams = convert.from_jax(params)
    rng = np.random.default_rng(2)
    memory = rng.standard_normal((N, S, M)).astype(np.float32)
    m_len = np.array([7, 4, 2], np.int32)
    mem_j = jattn.prepare_memory("value_only", params["atts"][0], jnp.asarray(memory),
                                 jnp.asarray(m_len), compute_dtype=jdt)
    mem_t = tattn.prepare_memory("value_only", tparams["atts"][0], torch.from_numpy(memory),
                                 torch.from_numpy(m_len), tdt)
    np.testing.assert_array_equal(mem_t.bias.numpy(), np.asarray(mem_j.bias))
    cross_j = jtd.prepare_cross(params, cfg, [mem_j], compute_dtype=jdt)
    cross_t = ttd.prepare_cross(tparams, cfg, [mem_t], tdt)
    state_j = jtd.initial_cache(cfg, N, L, dtype=jdt)
    state_t = ttd.initial_cache(cfg, N, L, tdt, "cpu")
    for _ in range(4):
        tokens = rng.integers(0, V, (N,)).astype(np.int32)
        state_j, logits_j = jtd.decode_step(params, cfg, jnp.asarray(tokens), state_j,
                                            [mem_j], cross_j, compute_dtype=jdt)
        state_t, logits_t = ttd.decode_step(tparams, cfg, torch.from_numpy(tokens).long(),
                                            state_t, [mem_t], cross_t, tdt)
        assert logits_t.dtype == torch.float32
        np.testing.assert_allclose(logits_t.numpy(), _np(logits_j), **tol)
    assert state_t.step == int(state_j.step[0]) == 4
    for (kt, vt), (kj, vj) in zip(state_t.caches, state_j.caches):
        np.testing.assert_allclose(kt.float().numpy(), _np(kj), **tol)
        np.testing.assert_allclose(vt.float().numpy(), _np(vj), **tol)
