"""Training-side decoder pieces of the port against ``avsr_tpu``:
teacher-forced logits of the transformer decoder, the sequence loss with
label smoothing, the AU-target pooling, and the decoder's dropout.

Tolerances: fp32 at atol 1e-5 / rtol 1e-4 (JAX matmuls at "highest"
precision, only summation order differs); bf16 logits at atol/rtol 2e-2
(bf16 operands rounded at the same points, one-ulp flips after another
summation order move a value by 2^-8 relative).  The parallel ==
sequential mirror holds the port against itself at 1e-4, as the JAX test
does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import DecoderConfig
from avsr_tpu.data.units import GO_ID
from avsr_tpu.models import decoder as jdec
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu.ops import attention as jattn
from avsr_tpu_torch import convert
from avsr_tpu_torch.models import decoder as tdec
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.models import transformer_decoder as ttd
from avsr_tpu_torch.ops import attention as tattn

CFG = dataclasses.replace(DecoderConfig(), decoder_type="transformer", hidden_units=(32,),
                          num_heads=4, attention_units=8, embedding_dim=16,
                          sampling_probability=0.0)
V, M = 20, 24
DTYPES = {
    "float32": (jnp.float32, torch.float32, dict(atol=1e-5, rtol=1e-4)),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _setup(seed, jdt, tdt, N=3, S=7):
    params = jax.tree_util.tree_map(
        np.asarray, jdec.decoder_init(jax.random.PRNGKey(seed), CFG, [M], V))
    rng = np.random.default_rng(seed)
    memory = rng.standard_normal((N, S, M)).astype(np.float32)
    m_len = np.array([7, 4, 1][:N], np.int32)
    mem_j = jattn.prepare_memory("value_only", params["atts"][0], jnp.asarray(memory),
                                 jnp.asarray(m_len), compute_dtype=jdt)
    tparams = convert.from_jax(params)
    mem_t = tattn.prepare_memory("value_only", tparams["atts"][0], torch.from_numpy(memory),
                                 torch.from_numpy(m_len), tdt)
    return params, tparams, mem_j, mem_t, rng


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_teacher_forced_logits_match_jax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    params, tparams, mem_j, mem_t, rng = _setup(0, jdt, tdt)
    targets = rng.integers(3, V, (3, 6)).astype(np.int32)
    t_len = np.array([6, 3, 1], np.int32)
    lj = jdec.teacher_forced_logits(params, CFG, jnp.asarray(targets), jnp.asarray(t_len),
                                    [mem_j], compute_dtype=jdt)
    lt = tdec.teacher_forced_logits(tparams, CFG, torch.from_numpy(targets),
                                    torch.from_numpy(t_len), [mem_t], tdt)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == lj.shape
    np.testing.assert_allclose(lt.numpy(), _np(lj), **tol)


def test_parallel_teacher_forcing_equals_sequential_decode():
    """The port's parallel causal pass and its KV-cache decode step give the
    same logits position for position on the same tokens (the mirror of
    tests/test_transformer_decoder.py's invariant)."""
    _, tparams, _, mem, _ = _setup(1, jnp.float32, torch.float32, N=2)
    targets = torch.tensor([[3, 4, 2], [4, 2, 0]])
    par = tdec.teacher_forced_logits(tparams, CFG, targets, torch.tensor([3, 2]), [mem],
                                     torch.float32)
    state = tdec.initial_state(CFG, 2, 3, torch.float32, "cpu")
    cross = tdec.prepare_cross(tparams, CFG, [mem], torch.float32)
    shifted = torch.cat([torch.full((2, 1), GO_ID), targets[:, :-1]], dim=1)
    seq = []
    for k in range(3):
        state, logits = tdec.decoder_step(tparams, CFG, shifted[:, k], state, [mem], cross,
                                          torch.float32)
        seq.append(logits)
    torch.testing.assert_close(par, torch.stack(seq, dim=1), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_sequence_loss_matches_jax(smoothing):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 5, V)).astype(np.float32) * 3
    targets = rng.integers(0, V, (3, 5)).astype(np.int32)
    t_len = np.array([5, 2, 0], np.int32)
    want = jdec.sequence_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(t_len),
                              label_smoothing=smoothing)
    got = tdec.sequence_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                             torch.from_numpy(t_len), label_smoothing=smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_pool_time_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((10, 3, 2)).astype(np.float32)
    lengths = np.array([10, 5, 0], np.int32)
    want = jseq._pool_time(jnp.asarray(x), jnp.asarray(lengths), 4)
    got = tseq._pool_time(torch.from_numpy(x), torch.from_numpy(lengths), 4)
    assert tuple(got.shape) == (3, 3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_decoder_dropout_is_seeded_inverted_dropout():
    """Train-mode logits differ from eval-mode ones, repeat for the same
    generator seed, and the mask keeps ~(1 - rate) of the entries scaled
    by 1/(1 - rate)."""
    _, tparams, _, mem, rng = _setup(4, jnp.float32, torch.float32)
    cfg = dataclasses.replace(CFG, dropout_rate=0.3)
    targets = torch.from_numpy(rng.integers(3, V, (3, 6)))
    t_len = torch.tensor([6, 3, 1])

    def run(seed, dropout=True):
        return tdec.teacher_forced_logits(tparams, cfg, targets, t_len, [mem], torch.float32,
                                          generator=torch.Generator().manual_seed(seed),
                                          dropout=dropout)

    assert torch.equal(run(0), run(0))
    assert not torch.allclose(run(0), run(1))
    torch.testing.assert_close(run(0, dropout=False),
                               tdec.teacher_forced_logits(tparams, cfg, targets, t_len, [mem],
                                                          torch.float32))
    x = torch.ones(200_000)
    y = ttd._dropout(x, 0.3, torch.Generator().manual_seed(5))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 5e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
