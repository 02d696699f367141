"""K8's backward takes every width its forward takes.

The forward (``kernels.av_align_family``) runs H and Dv that are multiples
of 16 and A a multiple of 8 (up to 512; Dv up to 2048; T_v up to 401): one
cluster launch at the presets' widths, the per-step kernels elsewhere.  The
backward's cluster recurrence (``csrc/av_align_bwd.cuh``) takes a narrower
set; ``kernels.av_align_bwd_family`` sends every other shape to the
per-step backward (``csrc/av_align_step_bwd.cuh``), whose plain counterpart
is ``fusion.av_align_scan_bwd_plain`` (the per-step twin: each step's
memory gradients added inside the scan, as those kernels add them).  The
kernels themselves run only on the card (chip_smoke phase 37 trains at two
such widths); here:

- over grids of widths, both reads, with and without input feeding: the
  backward raises exactly where the forward raises, and every shape the
  forward takes gets a route whose own limits (the cluster's shared
  memory; the step kernels' widths and row launch) it meets;
- the presets take the cluster route, widths the cluster recurrence refuses
  (Bahdanau A = 72, Luong Hk = Dv = 192, H = 48) the step route, chosen by
  shape alone (the library is never loaded) and with two rows a CTA only
  where they fit;
- the step route's plain counterpart, through ``AVAlignScan`` (on CPU
  tensors its backward is ``av_align_scan_bwd_plain``), against
  ``jax.vjp`` of ``avsr_tpu.models.fusion.av_align_apply`` at those
  widths: every parameter's gradient and those of the audio input and the
  video memory, relative error of each norm within 1e-5 in fp32 (25
  recurrent steps of fp32 sums in another order; seen ~1e-6) and 1e-2
  under the bf16 policy (a rounding boundary flips one ulp, 2^-8, and the
  recurrence carries it on: ``test_torch_align_grad.py``'s tolerances).
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

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _route(H, Dc, A, S, Dv, dot):
    """(the forward's family or its error, the backward's family or its error)."""
    out = []
    for fn, args in ((kernels.av_align_family, (H, Dc, A, S, Dv)),
                     (kernels.av_align_bwd_family, (H, Dc, A, S, Dv, dot))):
        try:
            out.append(fn(*args))
        except ValueError:
            out.append(None)
    return tuple(out)


def _check_route(H, Dc, A, S, Dv, dot):
    fwd, bwd = _route(H, Dc, A, S, Dv, dot)
    assert (fwd is None) == (bwd is None), (H, Dc, A, S, Dv, dot, fwd, bwd)
    if bwd == "cluster":
        assert H % (128 if dot else 64) == 0 and H <= 512 and (H + Dc) % 128 == 0
        assert H + Dc <= 1024 and A % 64 == 0 and Dv % 64 == 0
        assert kernels.av_align_bwd_smem(H, Dc, A, S, Dv, dot, 1) <= kernels.SMEM_LIMIT
    elif bwd == "step":
        assert H % 16 == 0 and Dv % 16 == 0 and Dc in (0, Dv) and A % 8 == 0 and A <= 512
        assert Dv <= 2048 and kernels.av_align_step_bwd_smem(H, A, S, Dv) <= kernels.SMEM_LIMIT
    else:
        assert bwd is None
    return bwd


CASES = [(dot, feed) for dot in (False, True) for feed in (False, True)]
IDS = [f"{'luong' if d else 'bahdanau'}-{'feed' if f else 'no-feed'}" for d, f in CASES]


@pytest.mark.parametrize("dot, feed", CASES, ids=IDS)
def test_every_forward_width_gets_a_backward_route_over_A_and_Dv(dot, feed):
    """A in steps of 8 to past 512 and Dv in steps of 16 to past 2048, at
    H from the smallest to past the cluster's 512, T_v 60 and 400."""
    routes = set()
    for H in (16, 48, 128, 192, 256, 512, 1440):
        for S in (60, 400):
            for A in range(8, 528, 8):
                for Dv in range(16, 2080, 16):
                    routes.add(_check_route(H, Dv if feed else 0, A, S, Dv, dot))
    assert {"cluster", "step", None} <= routes


@pytest.mark.parametrize("dot, feed", CASES, ids=IDS)
def test_every_forward_width_gets_a_backward_route_over_H(dot, feed):
    """H in steps of 16 up to where the forward's gate launch no longer
    fits, at A and Dv on and off the cluster's multiples of 64, and the
    lengths past the forward's limits."""
    routes = set()
    for H in range(16, 1632, 16):
        for A in (8, 64, 72, 128, 512, 520):
            for Dv in (16, 64, 80, 192, 512, 2048):
                for S in (1, 150, 400, 401, 402):
                    routes.add(_check_route(H, Dv if feed else 0, A, S, Dv, dot))
    assert {"cluster", "step", None} <= routes
    assert _route(8, 0, 64, 150, 64, dot) == (None, None)  # H below a unit tile


@pytest.mark.parametrize("widths, dot", [
    ((256, 512, 128, 150, 512), False),  # lrs2_full: Bahdanau, H=256, video memory 512
    ((256, 256, 256, 150, 256), True),   # the uni-Luong variant: Hk = Dv = 256
    ((256, 512, 128, 400, 512), False),  # 16 s at 25 fps
    ((256, 256, 256, 400, 256), True),
    ((256, 512, 128, 401, 512), False),  # the largest bucket's video frames
    ((256, 256, 256, 401, 256), True),
])
def test_presets_take_the_cluster_backward(widths, dot):
    assert kernels.av_align_family(*widths) == "cluster"
    assert kernels.av_align_bwd_family(*widths, dot) == "cluster"


@pytest.mark.parametrize("widths, dot", [
    ((256, 512, 72, 60, 512), False),   # A not a multiple of 64
    ((256, 192, 192, 60, 192), True),   # H + Dc = 448: not a multiple of 128
    ((48, 80, 64, 40, 80), False),      # H, Dv not multiples of 64
    ((256, 1024, 128, 150, 1024), False),  # H + Dc past the cluster's 1024
    ((640, 0, 128, 150, 128), False),   # H past the cluster's 512
    ((128, 128, 128, 150, 128), True),  # Luong at H = 128: the cluster's fine
])
def test_widths_the_cluster_refuses_take_the_step_route(widths, dot):
    want = "cluster" if widths == (128, 128, 128, 150, 128) else "step"
    assert kernels.av_align_bwd_family(*widths, dot) == want


def test_backward_family_is_a_function_of_the_shape_alone(monkeypatch):
    """No library, no device: the route comes from the widths alone (and
    the same on a second call)."""
    def refuse():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "_load", refuse)
    shapes = [((256, 512, 128, 150, 512), False), ((256, 512, 72, 60, 512), False),
              ((256, 192, 192, 60, 192), True), ((256, 256, 256, 150, 256), True)]
    first = [kernels.av_align_bwd_family(*w, d) for w, d in shapes]
    assert first == ["cluster", "step", "step", "cluster"]
    assert [kernels.av_align_bwd_family(*w, d) for w, d in shapes] == first


def test_backward_family_raises_with_the_forwards_numbers():
    with pytest.raises(ValueError, match="A=12"):
        kernels.av_align_bwd_family(256, 512, 12, 150, 512, False)
    with pytest.raises(ValueError, match=f"T_v={kernels.FUSION_MAX_TV + 1}"):
        kernels.av_align_bwd_family(256, 512, 128, kernels.FUSION_MAX_TV + 1, 512, False)


def test_two_rows_a_cta_only_where_they_fit(monkeypatch):
    """Rows a CTA of the recurrence: 2 when one row a CTA leaves clusters
    waiting, unless two rows do not fit a CTA's shared memory."""
    monkeypatch.setattr(kernels, "_bwd_max_active", lambda *a: 7)
    assert kernels.av_align_bwd_rows_per_cta(128, 256, 512, 128, 150, 512, False) == 2
    assert kernels.av_align_bwd_rows_per_cta(112, 256, 512, 128, 150, 512, False) == 1
    wide = (256, 512, 512, 150, 512, True)  # Luong with A = 512: 2 rows need 252 KB
    assert kernels.av_align_bwd_family(*wide) == "cluster"
    assert kernels.av_align_bwd_smem(*wide, 2) > kernels.SMEM_LIMIT
    assert kernels.av_align_bwd_rows_per_cta(128, *wide) == 1


def test_step_route_stages_refuse_cpu_tensors():
    """The stage launcher checks devices before any route runs: CPU tensors
    are refused with no launch counted."""
    T, B, H, S, A, Dv = 3, 2, 48, 5, 72, 80
    z = torch.zeros
    bf = torch.bfloat16
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.av_align_scan_bwd(
            z(H, 4 * H, dtype=bf), z(4 * H), z(Dv, 4 * H, dtype=bf), z(H, A, dtype=bf),
            z(A, dtype=bf), z(T, B, 4 * H), z(T, B), z(B, S, A), z(B, S, Dv, dtype=bf),
            z(T, B, S), z(T, B, H), z(T, B, H), z(T, B, Dv), z(T, B, H), z(T, B, Dv), z(B, H),
            z(B, H), z(B, Dv))
    assert kernels.LAUNCHES == before


# ---- the step route's plain counterpart against JAX ------------------------

T_A, B, D, H = 25, 4, 24, 32
A_LEN = [25, 17, 0, 9]
V_LEN = [11, 0, 6, 3]
T_V = 11


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _fusion_case(dtype, h_v, seed=0, **kw):
    """Every gradient of ``av_align_apply`` (the fused memory and the AU
    head) through the port and through ``jax.vjp`` of the reference."""
    jdt, tdt = DT[dtype]
    cfg = FusionConfig(au_loss_weight=1.0, au_dim=2, **kw)
    params = jfus.av_align_init(jax.random.PRNGKey(seed), cfg, D, H, h_v)
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((T_A, B, D)).astype(np.float32)
    video = rng.standard_normal((B, T_V, h_v)).astype(np.float32)
    a_len, v_len = np.asarray(A_LEN, np.int32), np.asarray(V_LEN, np.int32)
    d_fused = rng.standard_normal((T_A, B, H + h_v)).astype(np.float32)
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
    want_all = want_leaves + [torch.from_numpy(np.array(w, np.float32)) for w in want[1:]]
    return names + ["audio", "video"], got, want_all, out


STEP_WIDTHS = [
    # Bahdanau with A = 72 (the cluster takes multiples of 64), a 48-wide memory
    ("bahdanau-A72", 48, {"attention_units": 72}),
    # Luong with Hk = Dv = 192: the keys are the memory (H + Dc = 224 for this H)
    ("luong-Hk192", 192, {"attention_type": "luong"}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label, h_v, kw", STEP_WIDTHS, ids=[w[0] for w in STEP_WIDTHS])
def test_step_route_plain_twin_matches_jax(label, h_v, kw, dtype):
    """At widths the cluster recurrence refuses, the step route's plain
    counterpart gives JAX's gradients; the empty rows' are exactly 0."""
    attention_type = kw.get("attention_type", "bahdanau")
    A = h_v if attention_type == "luong" else kw["attention_units"]
    assert kernels.av_align_bwd_family(H, h_v, A, T_V, h_v, attention_type == "luong") == "step"
    names, got, want, out = _fusion_case(dtype, h_v, **kw)
    assert out.fused.grad_fn is not None and not out.alignments.requires_grad
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        err = _rel(g.numpy(), w.numpy())
        assert err < TOL[dtype], (name, err)
    audio_g, video_g = got[-2], got[-1]
    assert float(audio_g[:, 2].abs().max()) == 0.0  # row 2 has no audio step
    assert float(video_g[1].abs().max()) == 0.0     # row 1 no video frame
