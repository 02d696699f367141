"""The decomposition of K8's backward (``csrc/av_align_bwd.cuh``), mirrored
in plain PyTorch by ``av_align_scan_bwd_split_plain``: a reverse scan that
saves the scores' cotangent dsc, the read's cotangent dctx' and q and never
touches the memory's gradients, then dkeys and dvalues as sums over the
steps after the scan.  It is held against the plain twin
``av_align_scan_bwd_plain`` (which adds each step's memory gradient inside
the scan) and, through ``AVAlignScan``, against ``jax.vjp`` of
``avsr_tpu.models.fusion.av_align_apply``, for both reads, fp32 and bf16,
with and without input feeding and value projection, on ragged lengths with
a 0-length audio row and a 0-length video row, and at the 16 s limits of
the kernels (T_a = 531, T_v = 400) on narrow widths.

Tolerances, as the relative error of each output's norm:
- against the twin, fp32 1e-5: the same arithmetic, the memory's
  gradients summed over the steps in another order (seen: 3e-7);
- against the twin, bf16 1e-2: the twin rounds each step's dvalues (and
  Luong's dkeys) term to bf16 as the reference's transposed casts do, the
  mirror sums the exact terms; the mirror's carry products take
  bf16(dgates), the twin's the fp32 dgates; a cotangent on a rounding
  boundary flips by one bf16 ulp (2^-8 relative) and the recurrence
  carries it on (seen: 3.5e-3);
- against JAX, ``test_torch_align_grad.py``'s: 1e-5 fp32, 1e-2 bf16 (the
  reference also rounds each step's weight gradient to bf16 before summing).
The empty rows' gradients are exactly zero on every side: a masked step and
a key of zero weight add exactly 0 to every sum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import FusionConfig
from avsr_tpu.models import fusion as jfus
from avsr_tpu_torch import convert
from avsr_tpu_torch.configs import FusionConfig as TFusionConfig
from avsr_tpu_torch.models import fusion as tfus
from avsr_tpu_torch.ops import attention as tattn

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
NAMES = ("dxw", "db", "dq", "dv_rows", "dkeys", "dvalues", "hnew")

# the ragged case of test_torch_align_grad.py: row 2 has no audio step, row 1 no video frame
T_A, B, D, H, T_V, H_V = 25, 4, 24, 32, 11, 20
A_LEN = [25, 17, 0, 9]
V_LEN = [11, 0, 6, 3]


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


def _scan_case(dtype, seed=0, T=T_A, S=T_V, a_len=A_LEN, v_len=V_LEN, Hc=H, Hv=H_V, **kw):
    """The scan's operands at the port's level, from seeded numpy: the
    fusion's parameters, the input product, the prepared memory, the plain
    forward's alignments and saved carries, and cotangents of every output
    and final carry."""
    cdt = DT[dtype][1]
    cfg = TFusionConfig(attention_units=8, **kw)
    p = tfus.av_align_init(torch.Generator().manual_seed(seed), cfg, D, Hc, Hv, "cpu")
    rng = np.random.default_rng(seed)
    Bn = len(a_len)
    video = torch.from_numpy(rng.standard_normal((Bn, S, Hv)).astype(np.float32))
    mem = tattn.prepare_memory(cfg.attention_type, p["att"], video, torch.tensor(v_len), cdt)
    xw = torch.from_numpy(rng.standard_normal((T, Bn, 4 * Hc)).astype(np.float32))
    mask = (torch.arange(T)[:, None] < torch.tensor(a_len)[None, :]).float()
    ctx_proj = p.get("ctx_proj")
    (_, _, aligns, *_), res = tfus.av_align_scan_fwd_plain(
        p["cell"], p["att"], ctx_proj, xw, mask, mem, cdt, save=True,
        attention_type=cfg.attention_type)
    Dv = mem.values.shape[-1]
    cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((T, Bn, Hc), (T, Bn, Dv), (Bn, Hc), (Bn, Hc), (Bn, Dv))]
    return ([p["cell"], p["att"], ctx_proj, xw, mask, mem, aligns, res, *cot, cdt],
            cfg.attention_type)


def _check_against_twin(args, attention_type, tol, empty_audio, empty_video):
    got = tfus.av_align_scan_bwd_split_plain(*args, attention_type=attention_type)
    want = tfus.av_align_scan_bwd_plain(*args, attention_type=attention_type)
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == tuple(w.shape), name
        assert _rel(g.numpy(), w.numpy()) < tol, (name, _rel(g.numpy(), w.numpy()))
    dxw, _, dq, _, dkeys, dvalues, _ = got
    # the empty audio row's steps and the empty video row's memory: exactly 0
    assert float(dxw[:, empty_audio].abs().max()) == 0.0
    assert float(dq[:, empty_audio].abs().max()) == 0.0
    assert float(dkeys[empty_video].abs().max()) == 0.0
    assert float(dvalues[empty_video].abs().max()) == 0.0
    return got


@pytest.mark.parametrize("dtype, kw", [
    ("float32", {}),
    ("bfloat16", {}),
    ("float32", {"input_feeding": False}),
    ("bfloat16", {"input_feeding": False}),
    ("float32", {"memory_value_dim": 12}),
    ("float32", {"attention_type": "luong"}),
    ("bfloat16", {"attention_type": "luong"}),
    ("bfloat16", {"attention_type": "luong", "input_feeding": False}),
    ("float32", {"attention_type": "luong", "memory_value_dim": 12}),
], ids=["fp32", "bf16", "fp32-no-input-feeding", "bf16-no-input-feeding",
        "fp32-value-projection", "fp32-luong", "bf16-luong", "bf16-luong-no-input-feeding",
        "fp32-luong-value-projection"])
def test_split_mirror_matches_twin(dtype, kw):
    """Every output of the mirror against the twin on the same operands."""
    args, attention_type = _scan_case(dtype, seed=5, **kw)
    _check_against_twin(args, attention_type, TOL[dtype], empty_audio=2, empty_video=1)


def test_split_mirror_padded_keys_get_nothing():
    """Keys past a row's video length carry weight 0: no dkeys, dvalues."""
    args, attention_type = _scan_case("bfloat16", seed=6)
    _, _, _, _, dkeys, dvalues, _ = tfus.av_align_scan_bwd_split_plain(
        *args, attention_type=attention_type)
    for row, n in enumerate(V_LEN):
        assert int(torch.count_nonzero(dkeys[row, n:])) == 0
        assert int(torch.count_nonzero(dvalues[row, n:])) == 0


@pytest.mark.parametrize("attention_type", ["bahdanau", "luong"])
def test_split_mirror_at_16s_lengths(attention_type):
    """T_a = 531 audio steps and T_v = 400 video frames (the kernels'
    limits: 16 s at 100 / 3 and 25 fps) on narrow widths, ragged with a
    0-length audio row and a 0-length video row, in bf16."""
    args, _ = _scan_case("bfloat16", seed=7, T=531, S=400, a_len=[531, 0, 260],
                         v_len=[0, 400, 133], Hc=8, Hv=8, attention_type=attention_type)
    _check_against_twin(args, attention_type, TOL["bfloat16"], empty_audio=1, empty_video=0)


def _fusion_grads_against_jax(dtype, seed=0, **kw):
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
    return (names + ["audio", "video"], got,
            want_leaves + [torch.from_numpy(np.array(w, np.float32)) for w in want[1:]])


@pytest.mark.parametrize("dtype, kw", [
    ("float32", {}),
    ("bfloat16", {}),
    ("bfloat16", {"input_feeding": False}),
    ("float32", {"memory_value_dim": 12}),
    ("float32", {"attention_type": "luong"}),
    ("bfloat16", {"attention_type": "luong"}),
    ("bfloat16", {"attention_type": "luong", "memory_value_dim": 12}),
], ids=["fp32", "bf16", "bf16-no-input-feeding", "fp32-value-projection", "fp32-luong",
        "bf16-luong", "bf16-luong-value-projection"])
def test_split_mirror_gradients_match_jax(monkeypatch, dtype, kw):
    """``AVAlignScan``'s backward running the mirror: every parameter's
    gradient and those of the audio input and the video memory against
    ``jax.vjp`` of the reference, through the fused memory and the AU head."""
    calls = []

    def mirror(*args, **kwargs):
        calls.append(kwargs.get("attention_type"))
        return tfus.av_align_scan_bwd_split_plain(*args, **kwargs)

    monkeypatch.setattr(tfus, "av_align_scan_bwd", mirror)
    names, got, want = _fusion_grads_against_jax(dtype, **kw)
    assert calls == [kw.get("attention_type", "bahdanau")]
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        err = _rel(g.numpy(), w.numpy())
        assert err < TOL[dtype], (name, err)
    audio_g, video_g = got[-2], got[-1]
    assert float(audio_g[:, 2].abs().max()) == 0.0
    assert float(video_g[1].abs().max()) == 0.0
    assert float(audio_g[A_LEN[3]:, 3].abs().max()) == 0.0
    assert float(video_g[3, V_LEN[3]:].abs().max()) == 0.0
