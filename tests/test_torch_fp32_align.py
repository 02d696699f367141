"""The fp32 compute policy (``train.compute_dtype="float32"``) on
``lrs2_av_align``'s kernels, K8 (the AV-Align fusion scan) and K10 (the
Bahdanau read and its read loop), as far as the CPU can see it.

* The wrappers of K8's forward and backward and of K10's forward, per-step
  backward and loop sums hand their kernels the caller's fp32 operands as
  they are: no bf16 cast anywhere (``fusion._cell_operands`` and
  ``attention.kernel_operands`` included), so the kernels see the plain
  fp32 twins' dtypes and values.  The wrappers run on ``meta`` tensors,
  whose device is not the CPU, with the ``kernels`` functions replaced by
  recorders (``tests/test_torch_fp32_policy.py``'s pattern).
* The Luong reads of K8 and K10, and K2, still raise a ``ValueError`` that
  names them, at the wrappers and in the kernels layer; the bf16 policy
  still reaches every kernel, its operands cast to bf16.
* The routes: fp32 operands take K8's per-step kernels forward and
  backward and K10's general kernel and CUDA-core sums at the beam,
  greedy and teacher-forced loop's shapes; their shared memory holds
  align's widths at the 16 s limits (T_v = 401, S = 531 at Dv = 768); the
  launch counters name the fp32 instances apart.

The fp32 backward keeps the plain twins' decomposition (K8's per-step
backward adds each step's memory gradients in the twin's time order, K10's
CUDA-core sums add the loop's steps in order), so no further plain mirror
is needed; JAX's parity of align at fp32 is ``tests/test_torch_align_slice.py``.
"""

from unittest import mock

import pytest
import torch

from avsr_tpu_torch import kernels
from avsr_tpu_torch.models import fusion
from avsr_tpu_torch.ops import attention, rnn

F32, BF16 = torch.float32, torch.bfloat16
# a small scan: T audio steps, B rows, width H, S video frames, A attention
# units, Dv = Dc the video memory's width
T, B, H, S, A, DV = 5, 3, 16, 7, 8, 24


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


def _align_operands(dtype=F32):
    """The K8 scan's operands, fp32 as the fp32 policy holds them."""
    cell = {"wh": meta(H, 4 * H, dtype=dtype), "b": meta(4 * H)}
    att = {"wq": meta(H, A, dtype=dtype), "v": meta(A, dtype=dtype)}
    mem = attention.AttentionMemory(values=meta(B, S, DV, dtype=dtype), keys=meta(B, S, A),
                                    mask=meta(B, S), bias=meta(B, S))
    return cell, att, meta(DV, 4 * H, dtype=dtype), meta(T, B, 4 * H), meta(T, B), mem


def test_cell_and_kernel_operands_keep_fp32():
    cell, att, ctx_proj, _, _, mem = _align_operands()
    wh, b, cp = fusion._cell_operands(cell, ctx_proj, F32)
    assert wh is cell["wh"] and b is cell["b"] and cp is ctx_proj
    wq, v, keys, values = attention.kernel_operands("bahdanau", att, mem, F32)
    assert wq is att["wq"] and v is att["v"] and keys is mem.keys and values is mem.values
    # the bf16 policy casts the same operands to bf16, the keys stay fp32
    wq, v, keys, values = attention.kernel_operands("bahdanau", att, mem, BF16)
    assert (wq.dtype, v.dtype, keys.dtype, values.dtype) == (BF16, BF16, F32, BF16)
    assert fusion._cell_operands(cell, ctx_proj, BF16)[0].dtype == BF16


def test_k8_wrappers_pass_fp32_operands_unchanged():
    cell, att, ctx_proj, xw, mask, mem = _align_operands()
    fwd = Recorder(lambda: (meta(T, B, H), meta(T, B, DV), meta(T, B, S), meta(B, H),
                            meta(B, H), meta(B, DV), (meta(T, B, H), meta(T, B, H),
                                                      meta(T, B, DV))))
    with mock.patch.object(kernels, "av_align_scan", fwd):
        (hs, ctxs, aligns, *_), res = fusion.av_align_scan_fwd(cell, att, ctx_proj, xw, mask,
                                                                mem, F32, save=True)
    want = (cell["wh"], cell["b"], ctx_proj, att["wq"], att["v"], xw, mask, mem.keys,
            mem.values, mem.bias, mem.mask)
    assert all(got is w for got, w in zip(fwd.args, want))
    dhs, dctxs = meta(T, B, H), meta(T, B, DV)
    dhT, dcT, dctxT = meta(B, H), meta(B, H), meta(B, DV)
    bwd = Recorder(lambda: (meta(T, B, 4 * H), meta(4 * H), meta(T, B, A), meta(B, A),
                            meta(B, S, A), meta(B, S, DV), meta(T, B, H)))
    with mock.patch.object(kernels, "av_align_scan_bwd", bwd):
        fusion.av_align_scan_bwd(cell, att, ctx_proj, xw, mask, mem, aligns, res, dhs, dctxs,
                                 dhT, dcT, dctxT, F32)
    want = (cell["wh"], cell["b"], ctx_proj, att["wq"], att["v"], xw, mask, mem.keys,
            mem.values, aligns, *res, dhs, dctxs, dhT, dcT, dctxT)
    assert len(bwd.args) == len(want)
    assert all(got is w for got, w in zip(bwd.args, want))


def test_k8_autograd_function_runs_both_fp32_kernels():
    """``AVAlignScan`` (the scan under autograd) hands both kernels fp32
    operands and returns fp32 gradients of the fp32 leaves."""
    cell, att, ctx_proj, xw, mask, mem = _align_operands()
    leaves = [cell["wh"], cell["b"], ctx_proj, att["wq"], att["v"], xw, mem.keys, mem.values]
    for x in leaves:
        x.requires_grad_(True)
    fwd = Recorder(lambda: (meta(T, B, H), meta(T, B, DV), meta(T, B, S), meta(B, H),
                            meta(B, H), meta(B, DV), (meta(T, B, H), meta(T, B, H),
                                                      meta(T, B, DV))))
    bwd = Recorder(lambda: (meta(T, B, 4 * H), meta(4 * H), meta(T, B, A), meta(B, A),
                            meta(B, S, A), meta(B, S, DV), meta(T, B, H)))
    with mock.patch.object(kernels, "av_align_scan", fwd), \
            mock.patch.object(kernels, "av_align_scan_bwd", bwd):
        hs, ctxs, _, _ = fusion.av_align_scan(cell, att, ctx_proj, xw, mask, mem, F32)
        grads = torch.autograd.grad((hs.sum() + ctxs.sum()), leaves)
    assert fwd.args[0] is cell["wh"] and bwd.args[0] is cell["wh"]
    assert all(a.dtype == F32 for a in (*fwd.args[:5], *bwd.args[:5]) if a is not None)
    assert all(g.dtype == F32 and g.shape == x.shape for g, x in zip(grads, leaves))


def _loop(N=B, steps=2):
    _, att, _, _, _, mem = _align_operands()
    loop = attention.LoopState("bahdanau", mem, F32, steps)
    loop.bind(mem.keys, mem.values, att["wq"], att["v"])
    return att, mem, loop


def test_k10_wrappers_pass_fp32_operands_unchanged():
    _, att, _, _, _, mem = _align_operands()
    query = meta(B, H)
    rec = Recorder(lambda: (meta(B, DV), meta(B, S)))
    with mock.patch.object(kernels, "bahdanau_attend", rec):
        attention.attend_fwd("bahdanau", att, query, mem, F32)
    want = (query, att["wq"], att["v"], mem.keys, mem.values, mem.bias, mem.mask)
    assert all(got is w for got, w in zip(rec.args, want))
    # the read loop: its operands cast once (to fp32: not at all), each step's
    # forward, per-step backward and the loop's sums
    att, mem, loop = _loop()
    wq, v, keys, values = loop.operands  # the bound (detached) tensors themselves
    assert wq is loop.params["wq"] and v is loop.params["v"]
    assert keys is loop.mem.keys and values is loop.mem.values
    assert all(x.dtype == F32 for x in loop.operands)
    rec = Recorder(lambda: (meta(B, DV), meta(B, S)))
    with mock.patch.object(kernels, "bahdanau_attend", rec):
        attention.read_fwd(loop, query)
    assert rec.args[0] is query and all(got is w for got, w in zip(rec.args[1:5], loop.operands))
    weights, dctx = meta(B, S), meta(B, DV)
    step = Recorder(lambda: meta(B, H))
    with mock.patch.object(kernels, "attend_step_bwd", step):
        dquery = attention.read_step_bwd(loop, 0, query, weights, dctx)
    assert dquery.dtype == F32
    assert step.args[0] is query and all(got is w for got, w in zip(step.args[1:5], loop.operands))
    assert step.args[5] is weights and step.args[6] is dctx
    assert all(x.dtype == F32 for x in step.args[7:])
    loop.n, loop.weights = 2, [meta(B, S), meta(B, S)]
    sums = Recorder(lambda: (meta(B, S, A), meta(B, S, DV)))
    with mock.patch.object(kernels, "attend_loop_sums", sums):
        attention.read_loop_sums(loop)
    assert sums.args[0] is loop.mem.keys and sums.args[1] is loop.params["v"]
    assert all(x.dtype == F32 for x in sums.args[2:])


def _raises(family, fn):
    with pytest.raises(ValueError, match=rf"^{family}: the fp32 instance .* still to be ported"):
        fn()


def test_luong_reads_and_k2_raise_under_fp32_and_bf16_reaches_every_kernel():
    cell, att, ctx_proj, xw, mask, mem = _align_operands()
    luong_att = {"wq": meta(H, DV)}
    luong_mem = mem._replace(keys=mem.values)
    _raises("K8 Luong", lambda: fusion.av_align_scan_fwd(
        cell, luong_att, ctx_proj, xw, mask, luong_mem, F32, attention_type="luong"))
    _raises("K10 Luong", lambda: attention.attend_fwd("luong", luong_att, meta(B, H), luong_mem,
                                                      F32))
    _raises("K10 Luong", lambda: attention.LoopState("luong", luong_mem, F32, 2).bind(
        luong_mem.values, luong_mem.values, luong_att["wq"], None))
    lstm = (meta(1, H, 4 * H), meta(1, 4 * H), meta(T, 1, B, 4 * H), meta(T, 1, B),
            meta(1, B, H), meta(1, B, H))
    _raises("K2", lambda: rnn.scan_core_fwd(*lstm, F32, False))
    # the kernels layer refuses an fp32 Luong call before it looks further
    cpu = dict(dtype=F32)
    with pytest.raises(ValueError, match="Luong read's fp32 instance is still to be ported"):
        kernels.av_align_scan(torch.zeros(H, 4 * H, **cpu), torch.zeros(4 * H), None,
                              torch.zeros(H, DV, **cpu), None, torch.zeros(T, B, 4 * H),
                              torch.zeros(T, B), torch.zeros(B, S, DV), torch.zeros(B, S, DV),
                              torch.zeros(B, S), torch.zeros(B, S))
    with pytest.raises(ValueError, match="Luong read's fp32 instance is still to be ported"):
        kernels.bahdanau_attend(torch.zeros(B, H), torch.zeros(H, DV), None,
                                torch.zeros(B, S, DV), torch.zeros(B, S, DV), torch.zeros(B, S),
                                torch.zeros(B, S))
    # the bf16 policy: the same wrappers reach the kernels with bf16 weights
    fwd = Recorder(lambda: (meta(T, B, H), meta(T, B, DV), meta(T, B, S), meta(B, H),
                            meta(B, H), meta(B, DV), None))
    rec = Recorder(lambda: (meta(B, DV), meta(B, S)))
    with mock.patch.object(kernels, "av_align_scan", fwd), \
            mock.patch.object(kernels, "bahdanau_attend", rec):
        fusion.av_align_scan_fwd(cell, att, ctx_proj, xw, mask, mem, BF16)
        fusion.av_align_scan_fwd(cell, luong_att, ctx_proj, xw, mask, luong_mem, BF16,
                                 attention_type="luong")
        attention.attend_fwd("luong", luong_att, meta(B, H), luong_mem, BF16)
    assert fwd.args[0].dtype == BF16 and fwd.args[4] is None and rec.args[1].dtype == BF16


# align's widths: H = 256 (the fusion LSTM), A = 128, Dv = Dc = 512 (the video
# encoder's output); the decoder reads the fused memory [h ; ctx], Dv = 768,
# with its 256-wide query
ALIGN_H, ALIGN_A, ALIGN_DV, DEC_DV = 256, 128, 512, 768


@pytest.mark.parametrize("Tv", [150, kernels.FUSION_MAX_TV])
def test_k8_fp32_takes_the_per_step_kernels_within_shared_memory(Tv):
    H, Dc, A, Dv = ALIGN_H, ALIGN_DV, ALIGN_A, ALIGN_DV
    assert kernels.av_align_family(H, Dc, A, Tv, Dv, F32) == "step"
    assert kernels.av_align_family(H, Dc, A, Tv, Dv) == "cluster"
    assert kernels.av_align_bwd_family(H, Dc, A, Tv, Dv, False, F32) == "step"
    assert kernels.av_align_bwd_family(H, Dc, A, Tv, Dv, False) == "cluster"
    # the fp32 gate launch stages its weight slices in chunks: whole, they and
    # the h and ctx rows would pass the card's limit
    assert (64 + 16) * (H + Dc) * 4 > kernels.SMEM_LIMIT
    assert kernels.av_align_step_smem(H, Dc, A, Tv, 4) <= kernels.SMEM_LIMIT
    assert kernels.av_align_step_bwd_smem(H, A, Tv, Dv) <= kernels.SMEM_LIMIT
    assert kernels.av_align_step_smem(H, Dc, A, Tv, 4) == max(
        (64 + 16) * kernels.ALIGN_F32_CHUNK * 4, kernels.attend_general_smem(H, A, Tv))


@pytest.mark.parametrize("N,Bm,Sm", [(80, 8, 197), (128, 128, 197), (80, 8, kernels.ATTEND_MAX_S),
                                     (128, 128, kernels.ATTEND_MAX_S)])
def test_k10_fp32_takes_the_general_kernel_and_cuda_core_sums(N, Bm, Sm):
    """The beam step (N = 80 over 8 rows), greedy and the teacher-forced loop
    (N = 128, a row each) at 6 s and at the 16 s limit."""
    Hq, A, Dv = ALIGN_H, ALIGN_A, DEC_DV
    assert kernels.attend_route(N, Bm, Sm, Hq, A, Dv, False, F32) == "general"
    assert kernels.attend_route(N, Bm, Sm, Hq, A, Dv, False) in ("grouped", "row")
    assert kernels.attend_sums_family(A, Dv, F32) == "cuda_core"
    assert kernels.attend_sums_family(A, Dv) == "tensor_core"
    assert kernels.attend_general_smem(Hq, A, Sm) <= kernels.SMEM_LIMIT
    assert kernels.attend_step_bwd_smem(Hq, A, Sm, Dv) <= kernels.SMEM_LIMIT
    with pytest.raises(ValueError, match=f"S={kernels.ATTEND_MAX_S + 1}"):
        kernels.attend_route(N, Bm, kernels.ATTEND_MAX_S + 1, Hq, A, Dv, False, F32)


def test_fp32_instances_count_apart():
    assert kernels.align_counter("av_align_scan", False, F32) == "av_align_scan_f32"
    assert kernels.align_counter("av_align_scan_bwd", False, F32) == "av_align_scan_f32_bwd"
    assert kernels.align_counter("av_align_scan", True) == "av_align_scan_luong"
    assert kernels.align_counter("av_align_scan_bwd", False) == "av_align_scan_bwd"
    assert kernels.attend_counter("general", False, F32) == "bahdanau_attend_f32"
    assert kernels.attend_counter("row", False) == "bahdanau_attend_row"
    for name in ("av_align_scan_f32", "av_align_scan_f32_bwd", "bahdanau_attend_f32",
                 "bahdanau_attend_f32_bwd", "bahdanau_attend_f32_sums"):
        assert name in kernels.LAUNCHES
