"""The cluster route of K8's forward (the AV-Align fusion scan) on the CPU.

The cluster kernel (``avsr_tpu_torch/csrc/av_align_fwd.cuh``) runs only on
the card; here we hold what surrounds it: ``kernels.av_align_family``,
which routes a scan to the cluster kernel or to the per-step kernels by its
shape alone; ``kernels.av_align_fwd_smem``, which the card's build is
checked against; ``kernels.av_align_fwd_rows_per_cta``, which takes two
rows a CTA only where the card cannot hold every 16-row cluster at once;
the weight layout the kernel reads (``kernels.cluster_align_weights``); the
launcher's refusal of CPU tensors; and the plain twin, the oracle the
kernel is held to on the card, against ``avsr_tpu.models.fusion
.av_align_apply`` at the kernel's 16 s limits (T_a = 531, T_v = 400).

The kernel keeps every rounding point of the reference (bf16 h and ctx into
the gate products, the sum ((xw + ctx.cp) + h.Wh) + b, bf16 q for the dot
score), so the twin stays its oracle and no mirror of its step order is
needed.  Tolerances against JAX: fp32 atol / rtol 1e-4 (531 recurrent steps
of fp32 sums in another order); bf16 atol 2e-2 (both round the same
operands to bf16; a value on a rounding boundary lands one ulp, 2^-8
relative, apart and 531 steps of the recurrence carry it on; 1e-2 at 25
steps in ``test_torch_av_align.py``).  Empty rows are exactly zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import FusionConfig
from avsr_tpu.models import fusion as jfus
from avsr_tpu_torch import configs, convert, kernels
from avsr_tpu_torch.configs import FusionConfig as TFusionConfig
from avsr_tpu_torch.models import fusion as tfus
from avsr_tpu_torch.models import seq2seq

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
UNI_LUONG = {"audio_encoder.bidirectional": False, "video_encoder.bidirectional": False,
             "fusion.attention_type": "luong", "decoder.attention_type": "luong"}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _preset_widths(variant):
    """(H, Dc, A, Dv) of the full-width fusion of ``lrs2_av_align``
    (``configs.lrs2_full``) or its uni-Luong variant, from its parameters."""
    cfg = configs.lrs2_full()
    if variant == "uni_luong":
        cfg = cfg.override(UNI_LUONG)
    fus = seq2seq.model_init(cfg, 40, torch.Generator().manual_seed(0), device="cpu")["fusion"]
    H, A = fus["att"]["wq"].shape
    Dc, Dv = fus["ctx_proj"].shape[0], fus["ctx_proj"].shape[0]
    return H, Dc, A, Dv


@pytest.mark.parametrize("variant", ["bahdanau", "uni_luong"])
@pytest.mark.parametrize("S", [150, 400, 1])
def test_preset_widths_take_the_cluster_route(variant, S):
    """Both presets' fusions, at 6 s (T_v = 150), at the 16 s limit and at
    one frame, run on the cluster kernel."""
    H, Dc, A, Dv = _preset_widths(variant)
    assert (H, Dc, A, Dv) == ((256, 512, 128, 512) if variant == "bahdanau"
                              else (256, 256, 256, 256))
    assert kernels.av_align_family(H, Dc, A, S, Dv) == "cluster"


@pytest.mark.parametrize("H,Dc,A,S,Dv,family", [
    (128, 64, 128, 50, 64, "cluster"),      # the narrowest widths the layout takes
    (128, 1024, 512, 400, 1024, "cluster"),
    (256, 768, 128, 150, 768, "cluster"),   # one row a CTA fits, two do not
    (256, 0, 128, 150, 512, "step"),        # no input feeding
    (256, 0, 256, 150, 256, "step"),
    (256, 512, 64, 150, 512, "step"),       # A not a multiple of 128
    (256, 512, 200, 150, 512, "step"),
    (512, 512, 128, 150, 512, "step"),      # a [1024, 128] slice does not fit a CTA
    (192, 512, 128, 150, 512, "step"),      # not one or two groups of 8 units a CTA
    (256, 96, 128, 150, 96, "step"),        # a ctx tile row of 12 chunks
    (256, 1024, 128, 150, 1024, "step"),    # the slice and the tiles exceed a CTA
    (64, 32, 8, 400, 32, "step"),
])
def test_av_align_family_routes_by_shape(H, Dc, A, S, Dv, family):
    assert kernels.av_align_family(H, Dc, A, S, Dv) == family


@pytest.mark.parametrize("H,Dc,A,S,Dv", [
    (100, 512, 128, 150, 512),   # H not a multiple of 16
    (256, 512, 128, 402, 512),   # past the largest bucket's 401 video frames
    (256, 512, 128, 0, 512),
    (256, 512, 520, 150, 512),   # A past 512
    (256, 256, 128, 150, 512),   # Dc neither 0 nor Dv
    (256, 2048, 128, 150, 2048),  # no kernel's shared memory holds it
])
def test_av_align_family_rejects_shapes_no_kernel_takes(H, Dc, A, S, Dv):
    with pytest.raises(ValueError, match="av_align scan"):
        kernels.av_align_family(H, Dc, A, S, Dv)


def test_av_align_family_is_a_function_of_the_shape_alone(monkeypatch):
    """The route never depends on the library or on a launch that failed:
    with the library and the occupancy query unloadable the answers are the
    same."""
    shapes = [(H, Dc, A, S, Dv) for H in (128, 192, 256, 512) for Dv in (64, 256, 512, 768)
              for Dc in (0, Dv) for A in (64, 128, 256) for S in (1, 150, 400)]
    before = [kernels.av_align_family(*s) for s in shapes]

    def no_library(*args):
        raise RuntimeError("no library")

    monkeypatch.setattr(kernels, "_load", no_library)
    monkeypatch.setattr(kernels, "_fwd_max_active", no_library)
    assert [kernels.av_align_family(*s) for s in shapes] == before
    assert before.count("cluster") and before.count("step")


@pytest.mark.parametrize("B,resident,rows", [
    (8, 7, 1), (112, 7, 1), (113, 7, 2), (128, 7, 2), (128, 8, 1), (64, 3, 2), (17, 1, 2)])
def test_rows_per_cta_follow_occupancy(monkeypatch, B, resident, rows):
    """Two rows a CTA exactly when the 16-row clusters of one row a CTA
    outnumber the clusters the card holds at once."""
    monkeypatch.setattr(kernels, "_fwd_max_active", lambda *args: resident)
    assert kernels.av_align_fwd_rows_per_cta(B, 256, 512, 128, 150, 512, False) == rows


def test_rows_per_cta_stay_one_where_two_do_not_fit(monkeypatch):
    monkeypatch.setattr(kernels, "_fwd_max_active", lambda *args: 1)
    assert kernels.av_align_fwd_smem(256, 768, 128, 150, 768, 2) > kernels.SMEM_LIMIT
    assert kernels.av_align_fwd_rows_per_cta(128, 256, 768, 128, 150, 768, False) == 1


def test_cluster_shared_memory_at_the_presets_widths():
    """The layout's bytes at lrs2_av_align's widths, one row a CTA: the
    96 KB slice, wq's 8 columns (4 KB), two 8 KB h tiles, the 16 KB ctx
    tile, 8 KB of partials, 4 KB of the next step's xw, one row's 12,928 B of
    read scratch and staged context, 4 mbarriers; two rows a CTA double the
    tiles, the xw slots and the rows, need no partials (each gate warp takes
    all of k) and still fit; uni-Luong's 64 KB slice and 8 KB of wq
    columns."""
    row = (2 * 128 + 512 + 152 + 8 + 2048) * 4 + 2 * 512
    assert row == 12928
    one = 98304 + 4096 + 2 * 8192 + 16384 + 8192 + 4096 + row + 4 * 8
    assert kernels.av_align_fwd_smem(256, 512, 128, 150, 512, 1) == one
    assert kernels.av_align_fwd_smem(256, 512, 128, 150, 512, 2) == (
        one + 2 * 8192 + 16384 - 8192 + 4096 + row + 8)
    assert kernels.av_align_fwd_smem(256, 512, 128, 400, 512, 2) <= kernels.SMEM_LIMIT
    luong_row = (2 * 256 + 256 + 152 + 8 + 2048) * 4 + 2 * 256
    assert kernels.av_align_fwd_smem(256, 256, 256, 150, 256, 1) == (
        65536 + 8192 + 2 * 8192 + 8192 + 8192 + 4096 + luong_row + 4 * 8)


@pytest.mark.parametrize("H,Dc", [(256, 512), (256, 256), (128, 64)])
def test_cluster_weight_layout_keeps_every_weight(H, Dc):
    """Unpacking ``cluster_align_weights`` gives [Wh ; ctx_proj] back:
    [r, g, k, 8q + j] = W[k, q*H + r*H/16 + 8g + j]."""
    g = torch.Generator().manual_seed(H + Dc)
    wh = torch.randn((H, 4 * H), generator=g).to(torch.bfloat16)
    cp = torch.randn((Dc, 4 * H), generator=g).to(torch.bfloat16)
    w = kernels.cluster_align_weights(wh, cp)
    C, NW, K = kernels.ALIGN_CLUSTER, H // 128, H + Dc
    assert tuple(w.shape) == (C, NW, K, 32) and w.is_contiguous()
    r, gg, q, j = torch.meshgrid(torch.arange(C), torch.arange(NW), torch.arange(4),
                                 torch.arange(8), indexing="ij")
    cols = (q * H + r * (H // C) + 8 * gg + j)          # [C, NW, 4, 8]
    unpacked = torch.empty((K, 4 * H), dtype=torch.bfloat16)
    unpacked[:, cols.reshape(-1)] = w.view(C, NW, K, 4, 8).permute(2, 0, 1, 3, 4).reshape(K, -1)
    assert torch.equal(unpacked, torch.cat([wh, cp], dim=0))
    assert sorted(cols.reshape(-1).tolist()) == list(range(4 * H))  # each column once


@pytest.mark.parametrize("luong", [False, True])
def test_cluster_launcher_rejects_cpu_tensors(luong):
    """At widths the cluster route takes, a CPU tensor raises before any
    launch and counts none."""
    f32, bf = torch.float32, torch.bfloat16
    T, B, H, S, Dv = 3, 2, 128, 5, 128
    A = Dv if luong else 128
    assert kernels.av_align_family(H, Dv, A, S, Dv) == "cluster"
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.av_align_scan(
            torch.zeros(H, 4 * H, dtype=bf), torch.zeros(4 * H), torch.zeros(Dv, 4 * H, dtype=bf),
            torch.zeros(H, A, dtype=bf), None if luong else torch.zeros(A, dtype=bf),
            torch.zeros(T, B, 4 * H), torch.ones(T, B),
            torch.zeros(B, S, A, dtype=bf if luong else f32), torch.zeros(B, S, Dv, dtype=bf),
            torch.zeros(B, S), torch.ones(B, S), save=True)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention_type", ["bahdanau", "luong"])
def test_forward_at_16s_lengths_matches_jax(attention_type, dtype):
    """The port's fusion (the plain twin on the CPU) against
    ``av_align_apply`` at T_a = 531 audio steps and T_v = 400 video frames,
    narrow widths, ragged with a 0-length audio row (1) and a 0-length video
    row (0): the fused memory and the alignments; the empty rows and the
    padded steps exactly zero."""
    jdt, tdt = DT[dtype]
    T_A, T_V, D, H, H_V = 531, 400, 8, 16, 16
    a_len = np.asarray([531, 0, 260], np.int32)
    v_len = np.asarray([0, 400, 133], np.int32)
    cfg = FusionConfig(attention_units=8, attention_type=attention_type)
    params = jfus.av_align_init(jax.random.PRNGKey(3), cfg, D, H, H_V)
    rng = np.random.default_rng(3)
    audio = rng.standard_normal((T_A, 3, D)).astype(np.float32)
    video = rng.standard_normal((3, T_V, H_V)).astype(np.float32)
    out_j = jfus.av_align_apply(params, cfg, jnp.asarray(audio), jnp.asarray(a_len),
                                jnp.asarray(video), jnp.asarray(v_len), compute_dtype=jdt)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    out_t = tfus.av_align_apply(tparams, TFusionConfig(**dataclasses.asdict(cfg)),
                                torch.from_numpy(audio), torch.from_numpy(a_len),
                                torch.from_numpy(video), torch.from_numpy(v_len), tdt)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=2e-2, rtol=0)
    np.testing.assert_allclose(out_t.fused.numpy(), np.asarray(out_j.fused, np.float32), **tol)
    np.testing.assert_allclose(out_t.alignments.numpy(),
                               np.asarray(out_j.alignments, np.float32), **tol)
    assert float(out_t.fused[:, 1].abs().max()) == 0.0        # no audio step
    assert float(out_t.alignments[:, 0].abs().max()) == 0.0   # no video frame
    assert float(out_t.fused[:, 0, H:].abs().max()) == 0.0
    assert float(out_t.fused[260:, 2].abs().max()) == 0.0     # padded steps
    assert float(out_t.alignments[:, 2, 133:].abs().max()) == 0.0
