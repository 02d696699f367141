"""The AV-Align fusion (``avsr_tpu_torch/models/fusion.py`` ``av_align_init``
/ ``av_align_apply`` / ``av_align_scan``) against ``avsr_tpu.models.fusion``.

A small fusion: audio encoder output [T_a=25, B=4, 24], fusion hidden 32,
A=8, a video memory [4, T_v=11, 20], ragged audio lengths with a 0-length
row and ragged video lengths with a 0-length row, AU head on.  The same
seeded numpy inputs and converted weights go through both packages.
Tolerances: fp32 at atol / rtol 1e-4 (25 recurrent steps of fp32 sums in
another order); the bf16 policy at atol 1e-2 (both round the same operands
to bf16; a value on a rounding boundary can land one ulp, 2^-8 relative,
apart and the recurrence carries it on).  Padded steps and empty rows are
exactly zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import FusionConfig
from avsr_tpu.models import fusion as jfus
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.configs import FusionConfig as TFusionConfig
from avsr_tpu_torch.models import fusion as tfus
from avsr_tpu_torch.ops import attention as tattn

T_A, B, D, H, T_V, H_V = 25, 4, 24, 32, 11, 20
A_LEN = [25, 17, 0, 9]
V_LEN = [11, 0, 6, 3]
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _fusion_cfg(**kw):
    return FusionConfig(attention_units=8, au_loss_weight=1.0, au_dim=2, **kw)


def _run(cfg, dtype, seed=0):
    jdt, tdt = DT[dtype]
    params = jfus.av_align_init(jax.random.PRNGKey(seed), cfg, D, H, H_V)
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((T_A, B, D)).astype(np.float32)
    video = rng.standard_normal((B, T_V, H_V)).astype(np.float32)
    a_len, v_len = np.asarray(A_LEN, np.int32), np.asarray(V_LEN, np.int32)
    out_j = jfus.av_align_apply(params, cfg, jnp.asarray(audio), jnp.asarray(a_len),
                                jnp.asarray(video), jnp.asarray(v_len), compute_dtype=jdt)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tcfg = TFusionConfig(**dataclasses.asdict(cfg))
    out_t = tfus.av_align_apply(tparams, tcfg, torch.from_numpy(audio), torch.from_numpy(a_len),
                                torch.from_numpy(video), torch.from_numpy(v_len), tdt)
    return out_j, out_t


@pytest.mark.parametrize("dtype, kw", [
    ("float32", {}),
    ("bfloat16", {}),
    ("float32", {"input_feeding": False}),
    ("float32", {"memory_value_dim": 12}),
], ids=["fp32", "bf16", "fp32-no-input-feeding", "fp32-value-projection"])
def test_av_align_apply_matches_jax(dtype, kw):
    out_j, out_t = _run(_fusion_cfg(**kw), dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=1e-2, rtol=0)
    assert tuple(out_t.fused.shape) == out_j.fused.shape
    np.testing.assert_allclose(out_t.fused.numpy(), np.asarray(out_j.fused), **tol)
    np.testing.assert_allclose(out_t.alignments.numpy(), np.asarray(out_j.alignments), **tol)
    np.testing.assert_allclose(out_t.au_predictions.numpy(), np.asarray(out_j.au_predictions),
                               **tol)
    # row 2 has no audio; row 1 no video: exact zeros where the reference has them
    assert float(out_t.fused[:, 2].abs().max()) == 0.0
    assert float(out_t.alignments[:, 1].abs().max()) == 0.0
    assert float(out_t.fused[:, 1, H:].abs().max()) == 0.0
    assert float(out_t.fused[A_LEN[3]:, 3].abs().max()) == 0.0


def test_scan_wrapper_on_cpu_is_the_plain_twin():
    cfg = TFusionConfig(attention_units=8)
    gen = torch.Generator().manual_seed(1)
    p = tfus.av_align_init(gen, cfg, D, H, H_V, "cpu")
    mem = tattn.prepare_memory("bahdanau", p["att"], torch.randn(B, T_V, H_V, generator=gen),
                               torch.tensor(V_LEN), torch.float32)
    xw = torch.randn(T_A, B, 4 * H, generator=gen)
    mask = (torch.arange(T_A)[:, None] < torch.tensor(A_LEN)[None, :]).float()
    out_w = tfus.av_align_scan(p["cell"], p["att"], p["ctx_proj"], xw, mask, mem, torch.float32)
    out_p = tfus.av_align_scan_plain(p["cell"], p["att"], p["ctx_proj"], xw, mask, mem,
                                     torch.float32)
    for a, b in zip(out_w[:3] + out_w[3], out_p[:3] + out_p[3]):
        assert torch.equal(a, b)
    hs, ctxs, aligns, (hT, cT, ctxT) = out_p
    # the final carries are those of each row's last valid step
    assert torch.equal(hT[0], hs[-1, 0]) and torch.equal(ctxT[3], ctxs[A_LEN[3] - 1, 3])
    assert float(hT[2].abs().max()) == 0.0 and float(ctxT[2].abs().max()) == 0.0


def test_scan_refuses_a_gradient():
    """K8 has a backward now: a gradient asked of the scan goes through
    ``AVAlignScan`` and reaches Wh (it used to raise); the alignments still
    refuse one (``test_torch_align_grad.py`` holds the gradients to JAX)."""
    cfg = TFusionConfig(attention_units=8)
    gen = torch.Generator().manual_seed(2)
    p = tfus.av_align_init(gen, cfg, D, H, H_V, "cpu")
    p["cell"]["wh"].requires_grad_(True)
    mem = tattn.prepare_memory("bahdanau", p["att"], torch.randn(B, T_V, H_V, generator=gen),
                               torch.tensor(V_LEN), torch.float32)
    hs, ctxs, aligns, _ = tfus.av_align_scan(p["cell"], p["att"], p["ctx_proj"],
                                             torch.randn(3, B, 4 * H), torch.ones(3, B), mem,
                                             torch.float32)
    (dwh,) = torch.autograd.grad(hs.sum() + ctxs.sum(), [p["cell"]["wh"]])
    assert tuple(dwh.shape) == (H, 4 * H) and bool(torch.isfinite(dwh).all())
    assert float(dwh.abs().max()) > 0.0
    assert "AVAlignScan" in type(hs.grad_fn).__name__ and not aligns.requires_grad


def test_av_align_init_matches_jax_tree():
    for kw in ({}, {"input_feeding": False, "au_loss_weight": 0.0}, {"memory_value_dim": 12}):
        cfg = _fusion_cfg(**kw) if "au_loss_weight" not in kw else FusionConfig(
            attention_units=8, **kw)
        jp = jfus.av_align_init(jax.random.PRNGKey(0), cfg, D, H, H_V)
        tp = tfus.av_align_init(torch.Generator().manual_seed(0),
                                TFusionConfig(**dataclasses.asdict(cfg)), D, H, H_V, "cpu")
        shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
        assert jax.tree_util.tree_map(lambda x: tuple(x.shape), convert.to_jax_numpy(tp)) == shapes


def test_kernel_rejects_cpu_tensors():
    f32, bf = torch.float32, torch.bfloat16
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.av_align_scan(torch.zeros(16, 64, dtype=bf), torch.zeros(64), None,
                              torch.zeros(16, 8, dtype=bf), torch.zeros(8, dtype=bf),
                              torch.zeros(3, 2, 64), torch.zeros(3, 2), torch.zeros(2, 5, 8),
                              torch.zeros(2, 5, 16, dtype=bf), torch.zeros(2, 5, dtype=f32),
                              torch.zeros(2, 5, dtype=f32))
