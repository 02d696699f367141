"""The fp32 compute policy (``train.compute_dtype="float32"``) on the card's
kernels, as far as the CPU can see it.

* The wrappers of the families with an fp32 instance (K1 without a
  recurrent-dropout mask, K4, K5, K6; K8 and K10 in
  ``tests/test_torch_fp32_align.py``) hand their kernels the caller's fp32
  operands as they are: no cast to bf16 (the tensors reach the kernel
  function unchanged, so their dtype and values are the plain twin's).
  The wrappers run on ``meta`` tensors here, whose device is not the CPU,
  with the ``kernels`` functions replaced by recorders.
* Every family whose fp32 instance is still to be ported (K1 rd, K2, the
  Luong reads of K8 and K10, K9, K11, K12, K13) raises a ``ValueError``
  naming it, never falls back; the bf16 policy still reaches every
  kernel.
* The routes: fp32 operands take K1's per-step kernels (H <= 272), the
  CUDA-core attention family for K4 and K5 and K6's general kernel, and
  the CUDA-core family's shared memory holds the presets' 16 s limits.
* ``numerics.full_precision`` pins fp32 products and cuDNN convolutions to
  full precision under the fp32 policy and puts the process's flags back.
"""

from unittest import mock

import pytest
import torch

from avsr_tpu_torch import kernels
from avsr_tpu_torch.models import fusion, transformer
from avsr_tpu_torch.models import transformer_decoder as tdec
from avsr_tpu_torch.ops import attention, rnn
from avsr_tpu_torch.utils import numerics

F32, BF16 = torch.float32, torch.bfloat16
T, G, B, H = 5, 2, 3, 16


def meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


class Recorder:
    """Stands in for a ``kernels`` function: keeps its positional arguments
    and returns ``make()``."""

    def __init__(self, make):
        self.make, self.args = make, None

    def __call__(self, *args, **kwargs):
        self.args = args
        return self.make()


def _lstm_operands(dtype=F32, G=G):
    return (meta(G, H, 4 * H, dtype=dtype), meta(G, 4 * H), meta(T, G, B, 4 * H, dtype=dtype),
            meta(T, G, B), meta(G, B, H), meta(G, B, H))


def test_k1_wrappers_pass_fp32_operands_unchanged():
    wh, b, xw, mask, h0, c0 = _lstm_operands()
    fwd = Recorder(lambda: (meta(T, G, B, H), meta(G, B, H), meta(G, B, H), meta(T, G, B, H),
                            meta(T, G, B, H)))
    with mock.patch.object(kernels, "lstm_scan_fwd", fwd):
        (ys, _, _), (h_res, c_res) = rnn.scan_core_fwd(wh, b, xw, mask, h0, c0, F32, True)
    assert all(got is want for got, want in zip(fwd.args, (wh, b, xw, mask, h0, c0)))
    assert ys.dtype == h_res.dtype == c_res.dtype == F32
    dys = meta(T, G, B, H)
    bwd = Recorder(lambda: (meta(T, G, B, 4 * H), meta(G, 4 * H), meta(G, B, H),
                            meta(G, B, H)))
    with mock.patch.object(kernels, "lstm_scan_bwd", bwd):
        dwh, db, dxw, dh0, dc0 = rnn.scan_core_bwd(wh, b, xw, mask, h_res, c_res, dys,
                                                   h0, c0, F32)
    assert all(got is want for got, want in
               zip(bwd.args, (wh, b, xw, mask, h_res, c_res, dys, h0, c0)))
    assert dwh.dtype == dxw.dtype == F32 and dwh.shape == wh.shape


def test_k4_k5_k6_wrappers_pass_fp32_operands_unchanged():
    Bq, Ta, Tv, nh, A, dv = 2, 5, 7, 4, 8, 16
    q, k, v = meta(Bq, Ta, nh, A), meta(Bq, Tv, nh, A), meta(Bq, Tv, nh, dv)
    lengths = torch.empty((Bq,), dtype=torch.int32, device="meta")
    rec = Recorder(lambda: (meta(Bq, Ta, nh, dv), meta(Bq, nh, Ta, Tv), (meta(Bq, nh, Ta, Tv),)))
    with mock.patch.object(kernels, "fusion_attention_fwd", rec):
        fusion.fusion_attention_fwd(q, k, v, lengths, save=True)
    assert all(got is want for got, want in zip(rec.args, (q, k, v, lengths)))
    weights, dctx = meta(Bq, nh, Ta, Tv), meta(Bq, Ta, nh, dv)
    for kernel in ("fusion_attention", "decoder_attention"):
        bwd = Recorder(lambda: (meta(Bq, Ta, nh, A), meta(Bq, Tv, nh, A), meta(Bq, Tv, nh, dv)))
        with mock.patch.object(kernels, "attention_bwd_core", bwd):
            grads = fusion.core_route_bwd(kernel, q, k, v, weights, dctx)
        assert bwd.args[0] == kernel
        assert all(got is want for got, want in zip(bwd.args[1:], (q, k, v, weights, dctx)))
        assert all(g.dtype == F32 for g in grads)
    bias = meta(Bq, Tv)
    dec = Recorder(lambda: (meta(Bq, Ta, nh, dv), None))
    with mock.patch.object(kernels, "decoder_attention_fwd", dec):
        out, _ = tdec.decoder_attention_fwd(q, k, v, bias)
    assert all(got is want for got, want in zip(dec.args, (q, k, v, bias)))
    assert out.dtype == F32
    N, L = 6, 9
    qd, kd, vd = meta(N, nh, A), meta(Bq, L, nh, A), meta(Bq, L, nh, dv)
    k6 = Recorder(lambda: meta(N, nh, dv))
    with mock.patch.object(kernels, "decode_attention", k6):
        tdec.decode_attention(qd, kd, vd, meta(Bq, L), L)
    assert k6.args[0] is qd and k6.args[1] is kd and k6.args[2] is vd


def test_bf16_operands_still_reach_the_kernels():
    """The bf16 policy is every family's: its wrappers pass the check."""
    wh, b, xw, mask, h0, c0 = _lstm_operands(BF16)
    fwd = Recorder(lambda: (meta(T, G, B, H, dtype=BF16), meta(G, B, H), meta(G, B, H), None,
                            None))
    with mock.patch.object(kernels, "lstm_scan_fwd", fwd):
        rnn.scan_core_fwd(wh, b, xw, mask, h0, c0, BF16, False)
    assert fwd.args[2] is xw
    for family in ("K1", "K1 rd", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K8 Luong", "K9",
                   "K10", "K10 Luong", "K11", "K12", "K13"):
        numerics.check_policy(BF16, family)


def _raises(family, fn):
    with pytest.raises(ValueError, match=rf"^{family}: the fp32 instance .* still to be ported"):
        fn()


def test_families_not_yet_ported_raise_with_their_name():
    wh, b, xw, mask, h0, c0 = _lstm_operands()
    rd = meta(G, B, H)
    _raises("K1 rd", lambda: rnn.scan_core_fwd(wh, b, xw, mask, h0, c0, F32, False, rd))
    wh1, b1, xw1, mask1, h01, c01 = _lstm_operands(G=1)
    _raises("K2", lambda: rnn.scan_core_fwd(wh1, b1, xw1, mask1, h01, c01, F32, False))
    gw, gxw = meta(G, H, 3 * H), meta(T, G, B, 3 * H)
    _raises("K12", lambda: rnn.gru_core_fwd(gw, meta(G, 3 * H), gxw, mask, h0, F32, False))
    ln = (meta(G, 4 * H), meta(G, H), meta(G, H))
    _raises("K13", lambda: rnn.ln_core_fwd(wh, b, *ln, xw, mask, h0, c0, F32, False))
    _raises("K11", lambda: transformer.encoder_self_attention_fwd(
        meta(2, 5, 3, 4, 8), torch.empty((2,), dtype=torch.int64, device="meta"), save=False))
    _raises("K9", lambda: transformer.conformer_conv_fwd(
        meta(5, 2, 16), meta(16), meta(15, 1, 8), meta(8), meta(8),
        torch.empty((2,), dtype=torch.int64, device="meta")))
    # K8 and K10 take fp32 with the Bahdanau read; their Luong reads raise
    _raises("K8 Luong", lambda: fusion.av_align_scan_fwd(
        {}, {}, None, meta(T, B, 4 * H), meta(T, B), None, F32, attention_type="luong"))
    _raises("K8 Luong", lambda: fusion.av_align_scan_bwd(
        {}, {}, None, meta(T, B, 4 * H), meta(T, B), None, None, None, None, None, None, None,
        None, F32, attention_type="luong"))
    _raises("K10 Luong", lambda: attention.attend_fwd("luong", {}, meta(B, H), None, F32))
    for family in ("K1", "K8", "K10"):
        numerics.check_policy(F32, family)
    # the kernels layer itself refuses an fp32 call of another instance
    with pytest.raises(ValueError, match="still to be ported"):
        kernels.lstm_scan_fwd(*(torch.zeros(t.shape, dtype=t.dtype)
                                for t in (wh1, b1, xw1, mask1, h01, c01)))
    with pytest.raises(ValueError, match="bf16 or the fp32"):
        numerics.check_policy(torch.float16, "K1")


def test_fp32_routes():
    assert kernels.lstm_family(2, 128, 256, F32) == "step"
    assert kernels.lstm_family(2, 128, 256) == "cluster"
    assert kernels.lstm_family(2, 8, 272, F32) == "step"
    assert kernels.lstm_step_smem(256, True, 4) <= kernels.SMEM_LIMIT
    with pytest.raises(ValueError, match="fp32 per-step kernels"):
        kernels.lstm_family(2, 8, 288, F32)
    for kernel, dk, dv in (("fusion_attention", 128, 128), ("decoder_self_attention", 64, 64),
                           ("decoder_cross_attention", 128, 256),
                           ("fusion_attention", 128, 64)):
        assert kernels.attention_family(kernel, dk, dv, F32) == "core"
        assert kernels.attention_family(kernel, dk, dv) != "core"
    for N, Bm, L, cross in ((80, 8, 50, True), (128, 128, 50, True), (80, 80, 150, False),
                            (128, 128, 150, False)):
        assert kernels.decode_attention_route(N, Bm, L, L, 4, 64 if not cross else 128,
                                              64 if not cross else 256, cross, F32) == "general"
    # the CUDA-core family in fp32 at the presets' 16 s limits: K4 over
    # T_a = 531 audio steps and T_v = 401 frames at (128, 128) and (128, 64);
    # K5's self attention over the 150-label horizon, its cross attention
    # over lrs2_av_v2's 531-step memory
    for Tq, Tk, dk, dv in ((kernels.ATTEND_MAX_S, kernels.FUSION_MAX_TV, 128, 128),
                           (kernels.ATTEND_MAX_S, kernels.FUSION_MAX_TV, 128, 64),
                           (150, 150, 64, 64), (150, kernels.ATTEND_MAX_S, 128, 256)):
        assert kernels.attention_core_smem(Tq, Tk, dk, dv, 4) <= kernels.SMEM_LIMIT


def test_full_precision_pins_and_restores_the_flags():
    mm, cudnn = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        with numerics.full_precision(F32):
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32
        with numerics.full_precision(BF16):
            assert torch.get_float32_matmul_precision() == "high"
            assert torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(mm)
        torch.backends.cudnn.allow_tf32 = cudnn
