"""Fixed-SNR eval mixing (``ops/noise.py:mix_fixed_snr``) against the JAX
package's: the per-utterance (row, offset) draws bit for bit, the mixed
waveforms, and the noisy-eval memories.

The port draws on the host with ``utils/rng.py``'s numpy threefry2x32;
JAX draws with ``fold_in(PRNGKey(seed), h) -> split -> randint`` on its
device.  Both are uint32 arithmetic, so the draws must be equal: 240 random
(seed, hash, rows, span) cases, hashes at and above 2^31, spans above
65,536 (where ``randint``'s multiplier wraps to 0 in uint32) and at 1, and
the batch-position draw when no hashes are given (``jax.vmap``'d in the
reference).  The mixed waveforms agree within 1e-6 (fp32 powers summed in
another order); the noisy memories of a small ``audio_tcdtimit`` and
``av_align_noisy`` model (``encode(..., eval_snr=...)``, babble and cafe
banks) at the clean path's atol / rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu import configs
from avsr_tpu.configs import DecodeConfig
from avsr_tpu.data.units import builtin_unit_dict
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu.ops import noise as jnoise
from avsr_tpu_torch import convert
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.ops import noise as tnoise
from avsr_tpu_torch.utils import rng as trng
from tests.test_torch_slice import _request


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cases(n=240, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = int(rng.integers(0, 2 ** 31)) if i % 7 else int(rng.integers(-2 ** 31, 0))
        h = int(rng.integers(2 ** 31, 2 ** 32)) if i % 2 else int(rng.integers(0, 2 ** 31))
        N = int(rng.integers(1, 200))
        span = [int(rng.integers(65537, 2 ** 24)), int(rng.integers(2, 65537)), 1,
                65536, 65537][i % 5]
        out.append((s, h, N, span))
    return out


@jax.jit
def _jax_draw(key, h, N, span):
    k_idx, k_off = jax.random.split(jax.random.fold_in(key, h))
    return jax.random.randint(k_idx, (), 0, N), jax.random.randint(k_off, (), 0, span)


def test_draws_equal_jax_bit_for_bit():
    cases = _cases()
    got_i, got_o, want_i, want_o = [], [], [], []
    for s, h, N, span in cases:
        i, o = trng.fixed_snr_draws(s, np.array([h], np.uint32), N, span)
        got_i.append(int(i[0]))
        got_o.append(int(o[0]))
        a, b = _jax_draw(jax.random.PRNGKey(s), jnp.uint32(h), N, span)
        want_i.append(int(a))
        want_o.append(int(b))
    assert got_i == want_i and got_o == want_o
    assert all(0 <= o < c[3] for o, c in zip(got_o, cases))
    assert len({o for o, c in zip(got_o, cases) if c[3] > 65536}) > 40  # spread, not stuck


@pytest.mark.parametrize("hashes", ["uids", "positions"])
def test_vmapped_draws_equal_jax(hashes):
    """The draw of a whole batch, as ``mix_fixed_snr`` vmaps it: by uid hash,
    or by batch position (``arange(B)``) when no hashes are given."""
    rng = np.random.default_rng(3)
    B, N, span = 24, 9, 200_001
    hs = (rng.integers(0, 2 ** 32, B).astype(np.uint32) if hashes == "uids"
          else np.arange(B, dtype=np.uint32))
    base = jax.random.PRNGKey(5)

    def draw(h):
        k_idx, k_off = jax.random.split(jax.random.fold_in(base, h))
        return jax.random.randint(k_idx, (), 0, N), jax.random.randint(k_off, (), 0, span)

    wi, wo = jax.vmap(draw)(jnp.asarray(hs))
    i, o = trng.fixed_snr_draws(5, hs, N, span)
    np.testing.assert_array_equal(i, np.asarray(wi))
    np.testing.assert_array_equal(o, np.asarray(wo))


def test_threefry_block_matches_jax():
    """The bare block: jax's ``threefry_2x32`` on random keys and counters."""
    from jax._src import prng

    rng = np.random.default_rng(4)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 64), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(prng.threefry_2x32(jnp.asarray(k), jnp.asarray(x.ravel())))
    y0, y1 = trng.threefry2x32(k[0], k[1], x[0], x[1])
    np.testing.assert_array_equal(np.concatenate([y0, y1]), want)


def _bank(rng, rows=5, length=24000):
    t = np.arange(length) / 16000.0
    babble = sum(np.sin(2 * np.pi * rng.uniform(100, 400, (rows, 1)) * t[None, :])
                 for _ in range(3))
    return {"babble": (0.1 * babble).astype(np.float32),
            "cafe": (0.05 * rng.standard_normal((rows, length))).astype(np.float32)}


@pytest.mark.parametrize("noise_type", ["babble", "cafe"])
@pytest.mark.parametrize("with_hashes", [True, False])
@pytest.mark.parametrize("snr", [-5.0, 0.0, 20.0])
def test_mixed_waveforms_match_jax(noise_type, with_hashes, snr):
    rng = np.random.default_rng(6)
    B, S = 4, 16000
    wav = (0.3 * rng.standard_normal((B, S))).astype(np.float32)
    lengths = np.array([S, 12000, 401, 0], np.int32)
    wav *= np.arange(S)[None, :] < lengths[:, None]
    bank = _bank(rng)
    hashes = rng.integers(0, 2 ** 32, B).astype(np.uint32) if with_hashes else None
    want = jnoise.mix_fixed_snr(jnp.asarray(wav), jnp.asarray(lengths), bank, snr,
                                noise_type=noise_type, seed=2,
                                uid_hashes=None if hashes is None else jnp.asarray(hashes))
    got = tnoise.mix_fixed_snr(torch.from_numpy(wav), torch.from_numpy(lengths), bank,
                               torch.tensor(snr), noise_type=noise_type, seed=2,
                               uid_hashes=hashes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert not np.any(got.numpy()[3])  # an empty utterance stays zero


def test_short_bank_raises():
    wav = torch.zeros((2, 100))
    with pytest.raises(ValueError, match="shorter than waveform"):
        tnoise.mix_fixed_snr(wav, torch.tensor([100, 50]), np.zeros((2, 99), np.float32), 0.0)


def _noisy_cfg(name, snr, ntype):
    base = configs.PRESETS[name]()
    return base.replace(
        audio_encoder=dataclasses.replace(base.audio_encoder, hidden_units=(32, 32)),
        video_encoder=dataclasses.replace(base.video_encoder, hidden_units=(32,)),
        fusion=dataclasses.replace(base.fusion, attention_units=8),
        decoder=dataclasses.replace(base.decoder, hidden_units=(32,), embedding_dim=16,
                                    attention_units=8, max_label_length=12),
        decode=DecodeConfig(beam_width=3, max_decode_length=12),
        noise=dataclasses.replace(base.noise, eval_snr_db=snr, eval_noise_type=ntype),
        train=dataclasses.replace(base.train, compute_dtype="float32"),
    )


@pytest.mark.parametrize("name,ntype,snr,eval_snr", [
    ("audio_tcdtimit", "babble", 0.0, None), ("audio_tcdtimit", "cafe", 20.0, -5.0),
    ("av_align_noisy", "cafe", -5.0, None), ("av_align_noisy", "babble", 10.0, 0.0)])
def test_noisy_eval_memories_match_jax(name, ntype, snr, eval_snr):
    """``encode(..., noise_bank=, eval_snr=)`` in eval mode: the fixed
    condition is mixed (the memory moves away from the clean one) and the
    memories equal JAX's; ``eval_snr`` overrides ``eval_snr_db``."""
    cfg = _noisy_cfg(name, snr, ntype)
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    jparams = jseq.model_init(jax.random.PRNGKey(8), cfg, V)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(8)
    audio, video = _request(rng, 2)
    arrays = {"audio": np.zeros((2, 16000), np.float32), "audio_lengths": np.zeros(2, np.int32),
              "video": np.zeros((2, 25, 36, 36, 1), np.float32),
              "video_lengths": np.zeros(2, np.int32),
              "uid_hashes": np.array([0x9E3779B9, 17], np.uint32)}
    for i, (a, v) in enumerate(zip(audio, video)):
        arrays["audio"][i, :len(a)] = a
        arrays["audio_lengths"][i] = len(a)
        arrays["video"][i, :len(v)] = v
        arrays["video_lengths"][i] = len(v)
    bank = _bank(rng)
    jb = jseq.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ev = None if eval_snr is None else jnp.float32(eval_snr)
    mj = jseq.encode(jparams, cfg, jb, noise_bank=jnoise.NoiseBank.create(bank),
                     eval_snr=ev).memories
    tb = tseq.batch_to_device(arrays, "cpu")
    assert tb.uid_hashes.device.type == "cpu"
    with torch.no_grad():
        mt = tseq.encode(tparams, cfg, tb, noise_bank=tnoise.NoiseBank.create(bank),
                         eval_snr=None if eval_snr is None else torch.tensor(eval_snr)).memories
        clean = tseq.encode(tparams, cfg, tb).memories
    for a, b, c in zip(mt, mj, clean):
        np.testing.assert_allclose(a.values.numpy(), np.asarray(b.values), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(a.keys.numpy(), np.asarray(b.keys), atol=1e-4, rtol=1e-4)
        assert float((a.values - c.values).abs().max()) > 1e-2
