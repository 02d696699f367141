"""K10's grouped read: the beams of an utterance read its one memory row.

The port's beam search no longer tiles the RNN decoder's memories over the
beams: K10 (``ops/attention.py`` ``attend``) takes the memory's B rows and
the N = B * W queries, query row n reading memory row n // W.  These tests
hold the plain twin over the untiled memory against itself over the tiled
one and against the JAX package's ``attend`` over the ``jnp.repeat``-tiled
memory; a torch mirror of the grouped kernel's decomposition (a cluster of
C CTAs per memory row, each owning q's column groups, a key chunk and value
column groups; the products' k steps split over warps, their partial sums
added in order; ``e^2k e^2q`` energies) against the plain twin; the RNN
decoder's beam search against JAX's at widths 1, 3 and 10; and the CUDA
wrapper's checks and route table, which run without a card.

Tolerances: fp32 twins and mirrors at atol 1e-5 on the weights and 1e-4
on the contexts (fp32 sums in another order; the energies' factored form
moves a tanh by ~1e-7); under the bf16 policy chip_smoke's K10_W_TOL 1e-3
on the weights (an energy's or q's bf16 rounding that flips after another
summation order moves a score by ~2^-9 of a term) and K10_CTX_TOL 2e-2 on
the contexts (bf16 weights times bf16 values of order one); whole decodes
as ``tests/test_torch_rnn_decoder.py`` holds them: ids, lengths and steps
identical, scores within 1e-4 relative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import DecoderConfig
from avsr_tpu.decode import beam as jbeam
from avsr_tpu.models import decoder as jdec
from avsr_tpu.ops import attention as jattn
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.decode import beam as tbeam
from avsr_tpu_torch.ops import attention as tattn

F32_W, F32_CTX = dict(atol=1e-5, rtol=0), dict(atol=1e-4, rtol=0)
BF16_W, BF16_CTX = dict(atol=1e-3, rtol=0), dict(atol=2e-2, rtol=0)
# the presets' decoder widths: lrs2_av_align (and av_align_tcdtimit,
# av_align_noisy), and lrs2_av_align_uni_luong's one 512-wide memory
BAHDANAU = dict(Hq=256, A=128, Dv=768)
LUONG = dict(Hq=256, A=512, Dv=512)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _read(typ, seed, B, W, S, Hq, A, Dv, cdt, lens=None):
    """The read's operands from numpy: params, queries [B W, Hq] and a
    prepared memory of B rows (Bahdanau: keys [B, S, A] fp32 projected from
    a [B, S, Dv] memory; Luong: one [B, S, A] memory as keys and values),
    row 1 of length 0."""
    rng = np.random.default_rng(seed)
    query = (0.5 * rng.standard_normal((B * W, Hq))).astype(np.float32)
    params = {"wq": (rng.standard_normal((Hq, A)) / np.sqrt(Hq)).astype(np.float32)}
    if typ == "bahdanau":
        params["v"] = (rng.standard_normal(A) / np.sqrt(A)).astype(np.float32)
        params["wm"] = (rng.standard_normal((Dv, A)) / np.sqrt(Dv)).astype(np.float32)
        memory = rng.standard_normal((B, S, Dv)).astype(np.float32)
    else:
        memory = (0.5 * rng.standard_normal((B, S, A))).astype(np.float32)
    if lens is None:
        lens = rng.integers(1, S + 1, B)
        lens[0] = S
        if B > 1:
            lens[1] = 0
    tparams = {k: torch.from_numpy(x) for k, x in params.items()}
    mem = tattn.prepare_memory(typ, tparams, torch.from_numpy(memory),
                               torch.from_numpy(np.asarray(lens)), cdt)
    return params, tparams, query, memory, np.asarray(lens), mem


def _tiled(mem, W):
    tile = lambda x: x.repeat_interleave(W, dim=0)  # noqa: E731
    values = tile(mem.values)
    keys = values if mem.keys is mem.values else tile(mem.keys)
    return tattn.AttentionMemory(values=values, keys=keys, mask=tile(mem.mask),
                                 bias=tile(mem.bias))


@pytest.mark.parametrize("typ", ["bahdanau", "luong"])
@pytest.mark.parametrize("W", [1, 3, 10])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_untiled_twin_is_the_tiled_twin_bit_for_bit(typ, W, cdt):
    """The twin over the memory's B rows gives the same bits as over the
    memory tiled W times (beams contiguous per row, as the reference tiles),
    with a length-0 memory row whose beams read zeros."""
    _, tparams, query, _, _, mem = _read(typ, W, 3, W, 7, 16, 8, 12, cdt)
    q = torch.from_numpy(query)
    got = tattn.attend_plain(typ, tparams, q, mem, cdt)
    want = tattn.attend_plain(typ, tparams, q, _tiled(mem, W), cdt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[0][W:2 * W].abs().max()) == 0.0 == float(got[1][W:2 * W].abs().max())


@pytest.mark.parametrize("typ", ["bahdanau", "luong"])
@pytest.mark.parametrize("W", [1, 3, 10])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_jax_over_the_tiled_memory(typ, W, dtype):
    """The twin over the untiled memory against the reference's ``attend``
    (``avsr_tpu/ops/attention.py:125``) over the memory ``jnp.repeat``-tiled
    W times, as its beam search reads it."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    params, tparams, query, memory, lens, mem = _read(typ, 10 + W, 3, W, 9, 16, 8, 12, tdt)
    mem_j = jattn.prepare_memory(typ, {k: jnp.asarray(x) for k, x in params.items()},
                                 jnp.asarray(np.repeat(memory, W, axis=0)),
                                 jnp.asarray(np.repeat(lens, W)), compute_dtype=jdt)
    ctx_j, w_j = jattn.attend(typ, {k: jnp.asarray(x) for k, x in params.items()},
                              jnp.asarray(query), mem_j, compute_dtype=jdt)
    ctx_t, w_t = tattn.attend_plain(typ, tparams, torch.from_numpy(query), mem, tdt)
    tol_w, tol_c = (F32_W, F32_CTX) if dtype == "float32" else (BF16_W, BF16_CTX)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), **tol_w)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), **tol_c)


# ---- a torch mirror of the grouped kernel's decomposition -----------------

WARPS = 16
EXP_RANGE = 40.0


def _ksplit(ng, nk):
    """The warps a 16-column group's k steps are split over: WARPS / ng, at
    least one, four steps a warp at least."""
    return max(1, min(1 if ng >= WARPS else WARPS // ng, nk // 4))


def _strip_product(a, b, ng, nk):
    """attend_grouped.cuh's strip_product: a [rows, 16 nk] times b [16 nk,
    16 ng] (exact bf16 values in fp32), the k steps split over
    ``_ksplit(ng, nk)`` warps and their partial sums added in order from 0."""
    ks = _ksplit(ng, nk)
    out = torch.zeros(a.shape[0], b.shape[1])
    for kq in range(ks):
        k0, k1 = 16 * (kq * nk // ks), 16 * ((kq + 1) * nk // ks)
        out = out + a[:, k0:k1] @ b[k0:k1]
    return out


def grouped_mirror(typ, params, query, mem, cdt, C):
    """The grouped read of N = B W queries over a memory of B rows by a
    cluster of C CTAs per row, as ``csrc/attend_grouped.cuh`` splits it:
    CTA r forms q's 16-column groups [r nq / C, (r + 1) nq / C) and the
    scores of keys [r S / C, (r + 1) S / C) for the W queries; every CTA
    runs the softmax over all S scores; CTA r forms the context of value
    column groups [r nv / C, (r + 1) nv / C).  -> (ctx [N, Dv], w [N, S])."""
    N, Hq = query.shape
    B, S = mem.mask.shape
    W, A, Dv = N // B, params["wq"].shape[1], mem.values.shape[-1]
    nq, nv, S_pad = A // 16, Dv // 16, -(-S // 16) * 16
    SCP = -(-(-(-S // C)) // 16) * 16
    dot = typ == "luong"
    qa = query.to(cdt).float()
    wq = params["wq"].to(cdt).float()
    ctx = torch.zeros(N, Dv)
    weights = torch.zeros(N, S)
    for b in range(B):
        qb = qa[b * W:(b + 1) * W]
        # 1. q, a CTA's column groups at a time
        q = torch.zeros(W, A)
        for r in range(C):
            g0, g1 = r * nq // C, (r + 1) * nq // C
            if g1 > g0:
                q[:, 16 * g0:16 * g1] = _strip_product(qb, wq[:, 16 * g0:16 * g1], g1 - g0,
                                                       Hq // 16)
        # 2. the scores, a CTA's key chunk at a time
        sc = torch.zeros(W, S)
        keys = mem.keys[b].float()
        for r in range(C):
            s0, s1 = r * S // C, (r + 1) * S // C
            if dot:
                kt = torch.zeros(SCP, A)
                kt[:s1 - s0] = keys[s0:s1].to(cdt).float()
                part = _strip_product(q.to(cdt).float(), kt.t(), SCP // 16, A // 16)
                sc[:, s0:s1] = part[:, :s1 - s0]
            else:
                k = keys[s0:s1]
                k_max = float(k.abs().max()) if k.numel() else 0.0
                if k_max <= EXP_RANGE and float(q.abs().max()) <= EXP_RANGE:
                    e = 1.0 - 2.0 / (1.0 + torch.exp(2 * k)[None] * torch.exp(2 * q)[:, None])
                else:
                    e = torch.tanh(k[None] + q[:, None])
                v = params["v"].to(cdt).float()
                sc[:, s0:s1] = (e.to(cdt).float() * v).sum(-1)
        sc = sc + mem.bias[b]
        # 3. the softmax, the mask and the renormalisation (every CTA alike)
        p = torch.softmax(sc, dim=-1) * mem.mask[b]
        w = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-9)
        w = w * torch.clamp(mem.mask[b].sum(), max=1.0)
        weights[b * W:(b + 1) * W] = w
        # 4. the context, a CTA's value column groups at a time
        pw = torch.zeros(W, S_pad)
        pw[:, :S] = w.to(cdt).float()
        vals = torch.zeros(S_pad, Dv)
        vals[:S] = mem.values[b].to(cdt).float()
        for r in range(C):
            g0, g1 = r * nv // C, (r + 1) * nv // C
            if g1 > g0:
                ctx[b * W:(b + 1) * W, 16 * g0:16 * g1] = _strip_product(
                    pw, vals[:, 16 * g0:16 * g1], g1 - g0, S_pad // 16)
    return ctx, weights


@pytest.mark.parametrize("typ", ["bahdanau", "luong"])
@pytest.mark.parametrize("S", [197, 531, 100])
@pytest.mark.parametrize("W", [3, 10])
def test_grouped_decomposition_matches_the_twin(typ, S, W):
    """The mirror of the kernel's split at the presets' widths, with the
    cluster size the wrapper picks for 8 utterances and with C = 16, over
    S = 197, 531 and 100 (chunks of 6 and 7 keys), a length-0 row among
    them; fp32 at tight tolerances and the bf16 policy at chip_smoke's."""
    widths = BAHDANAU if typ == "bahdanau" else LUONG
    for cdt, (tw, tc) in ((torch.float32, (F32_W, F32_CTX)), (torch.bfloat16, (BF16_W, BF16_CTX))):
        _, tparams, query, _, _, mem = _read(typ, S + W, 2, W, S, cdt=cdt, **widths)
        if typ == "bahdanau" and cdt == torch.bfloat16:
            mem = mem._replace(values=mem.values.to(cdt))
        q = torch.from_numpy(query)
        want = tattn.attend_plain(typ, tparams, q, mem, cdt)
        plan = kernels.attend_grouped_cluster(8, W, S, widths["Hq"], widths["A"], widths["Dv"],
                                              typ == "luong")
        for C in sorted({plan or 16, 16, 2}):
            ctx, w = grouped_mirror(typ, tparams, q, mem, cdt, C)
            np.testing.assert_allclose(w.numpy(), want[1].numpy(), **tw)
            np.testing.assert_allclose(ctx.numpy(), want[0].numpy(), **tc)
            assert float(ctx[W:2 * W].abs().max()) == 0.0 == float(w[W:2 * W].abs().max())


def test_decomposition_outside_the_factored_range():
    """Keys past |k| = 40 send the CTA to tanh(k + q): the mirror still
    matches the twin (a factor e^2k would overflow fp32 there)."""
    _, tparams, query, _, _, mem = _read("bahdanau", 3, 2, 4, 37, 32, 16, 32, torch.float32)
    keys = mem.keys.clone()
    keys[0, :5] = 45.0 * torch.sign(keys[0, :5])
    mem = mem._replace(keys=keys)
    q = torch.from_numpy(query)
    want = tattn.attend_plain("bahdanau", tparams, q, mem, torch.float32)
    ctx, w = grouped_mirror("bahdanau", tparams, q, mem, torch.float32, 4)
    np.testing.assert_allclose(w.numpy(), want[1].numpy(), **F32_W)
    np.testing.assert_allclose(ctx.numpy(), want[0].numpy(), **F32_CTX)


# ---- the RNN decoder's beam search over the untiled memory ---------------


def _decoder_and_memory(seed, cfg, V=11, m_len=(5, 0, 3), S=5, H=7):
    params = jdec.decoder_init(jax.random.PRNGKey(seed), cfg, [H], V)
    rng = np.random.default_rng(seed)
    memory = rng.standard_normal((len(m_len), S, H)).astype(np.float32)
    lengths = np.array(m_len, np.int32)
    typ = cfg.attention_type
    mem_j = jattn.prepare_memory(typ, params["atts"][0], jnp.asarray(memory),
                                 jnp.asarray(lengths), compute_dtype=jnp.float32)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    mem_t = tattn.prepare_memory(typ, tparams["atts"][0], torch.from_numpy(memory),
                                 torch.from_numpy(lengths), torch.float32)
    return params, tparams, mem_j, mem_t


@pytest.mark.parametrize("typ", ["bahdanau", "luong"])
@pytest.mark.parametrize("width", [1, 3, 10])
def test_rnn_beam_search_reads_the_untiled_memory_and_matches_jax(typ, width):
    """Beam search with the RNN decoder over a memory batch with a length-0
    row: every read sees the memory's B rows (no B * W copy), and ids,
    lengths and steps equal avsr_tpu's (which tiles the memory), scores
    within 1e-4 relative."""
    cfg = DecoderConfig(embedding_dim=8, hidden_units=(12,), attention_units=8,
                        attention_type=typ)
    params, tparams, mem_j, mem_t = _decoder_and_memory(width, cfg)
    seen = []
    real = tattn.attend_plain

    def spy(attention_type, p, query, mem, cdt):
        seen.append((query.shape[0], mem.values.shape[0], mem.keys.shape[0], mem.mask.shape[0]))
        return real(attention_type, p, query, mem, cdt)

    tattn.attend_plain = spy
    try:
        rt = tbeam.beam_search(tparams, cfg, [mem_t], 8, beam_width=width, length_penalty=0.6,
                               cdt=torch.float32)
    finally:
        tattn.attend_plain = real
    assert seen and all(s == (3 * width, 3, 3, 3) for s in seen)
    rj = jbeam.beam_search(params, cfg, [mem_j], 8, beam_width=width, length_penalty=0.6,
                           compute_dtype=jnp.float32)
    np.testing.assert_array_equal(rt.ids.numpy(), np.asarray(rj.ids))
    np.testing.assert_array_equal(rt.lengths.numpy(), np.asarray(rj.lengths))
    assert rt.steps == int(rj.steps)
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores), rtol=1e-4)


# ---- shapes, routes and the launcher ---------------------------------------


@pytest.mark.parametrize("N, B", [(7, 3), (10, 4), (5, 0)])
def test_queries_not_a_multiple_of_the_memory_rows_raise(N, B):
    """N query rows over B memory rows need N = B * W: the twin, the route
    and the read loop (which takes a query row per memory row) raise."""
    _, tparams, _, _, _, mem = _read("bahdanau", 1, max(B, 1), 1, 5, 8, 8, 8, torch.float32,
                                     lens=[5] * max(B, 1))
    if B == 0:
        mem = tattn.AttentionMemory(*(x[:0] for x in mem))
    with pytest.raises(ValueError, match="multiple of B"):
        tattn.attend_plain("bahdanau", tparams, torch.zeros(N, 8), mem, torch.float32)
    with pytest.raises(ValueError, match="multiple of B"):
        kernels.attend_route(N, B, 5, 8, 8, 8, False)


def test_read_loop_takes_a_query_row_per_memory_row():
    """Under autograd a read is a step of a read loop, whose backward keeps
    one row per memory row: two beams a row raise there."""
    _, tparams, _, _, _, mem = _read("bahdanau", 2, 2, 1, 5, 8, 8, 8, torch.float32)
    query = torch.zeros(4, 8, requires_grad=True)
    with pytest.raises(ValueError, match="a query row per memory row"):
        tattn.attend("bahdanau", tparams, query, mem, torch.float32)


def test_route_table_is_a_function_of_shape():
    """``attend_route`` by shape alone: the grouped read for 2 to 16 beams a
    memory row at widths that are multiples of 16 while a cluster's CTAs
    hold the row, the row read for one query a row at such widths, the
    general kernel for every other shape the wrapper takes; the same answer
    every call.  The cluster size: the most CTAs a row whose
    B clusters fit in one wave of the card (``ATTEND_GROUP_WAVE``)."""
    route, plan, smem = kernels.attend_route, kernels.attend_grouped_cluster, \
        kernels.attend_grouped_smem
    for dot, w in ((False, BAHDANAU), (True, LUONG)):
        Hq, A, Dv = w["Hq"], w["A"], w["Dv"]
        # the presets' beam step: 8 utterances, 10 beams, memories up to 16 s
        for S in (1, 50, 150, 197):
            assert route(80, 8, S, Hq, A, Dv, dot) == "grouped"
            assert plan(8, 10, S, Hq, A, Dv, dot) == 8      # 8 clusters of 8 CTAs
        # the 16 s memory: only a CTA of a 16-CTA cluster holds its share
        assert route(80, 8, 531, Hq, A, Dv, dot) == "grouped"
        assert plan(8, 10, 531, Hq, A, Dv, dot) == 16
        for W in range(2, 17):
            for B in (1, 8, 32):
                assert route(B * W, B, 197, Hq, A, Dv, dot) == "grouped"
        # greedy and the teacher-forced loop (one query a row), more than 16 beams
        assert route(128, 128, 197, Hq, A, Dv, dot) == "row"
        assert route(8, 8, 197, Hq, A, Dv, dot) == "row"
        assert route(8, 8, 531, Hq, A, Dv, dot) == "row"
        assert route(17 * 8, 8, 197, Hq, A, Dv, dot) == "general"
        for _ in range(3):
            assert route(80, 8, 197, Hq, A, Dv, dot) == "grouped"
    # widths that are not multiples of 16 (the tensor cores' k step)
    assert route(80, 8, 197, 256, 136, 768, False) == "general"
    assert route(80, 8, 197, 256, 128, 776, False) == "general"
    assert route(80, 8, 197, 250, 128, 768, False) == "general"
    assert route(80, 8, 197, 256, 72, 768, False) == "general"
    assert route(6, 3, 9, 16, 16, 16, False) == "grouped"
    # the cluster size by the rows: one wave of clusters while one fits
    assert plan(1, 10, 197, 256, 128, 768, False) == 16
    assert plan(7, 10, 197, 256, 128, 768, False) == 16
    assert plan(8, 10, 197, 256, 128, 768, False) == 8
    assert plan(15, 10, 197, 256, 128, 768, False) == 8
    assert plan(16, 10, 197, 256, 128, 768, False) == 4
    assert plan(32, 4, 50, 256, 128, 768, False) == 2
    # no size keeps the rows in one wave: the fewest CTAs that hold a row
    assert plan(32, 4, 197, 256, 128, 768, False) == 4
    assert plan(16, 10, 197, 256, 512, 512, True) == 8
    assert plan(1, 10, 197, 256, 512, 512, True) == 16
    for B, W, S, dot, Hq, A, Dv in ((8, 10, 197, False, 256, 128, 768),
                                    (8, 10, 197, True, 256, 512, 512),
                                    (64, 2, 197, False, 256, 128, 768),
                                    (2, 5, 300, True, 256, 512, 512)):
        C = plan(B, W, S, Hq, A, Dv, dot)
        assert C in kernels.ATTEND_GROUP_CLUSTERS
        assert smem(W, S, Hq, A, Dv, C, dot) <= kernels.SMEM_LIMIT
    # the layout at the presets' beam step, region by region (16 warps)
    assert smem(10, 197, 256, 128, 768, 8, False) == (
        16 * 264 * 2 + 256 * 24 * 2 + 10 * 128 * 4 + 128 * 4 + 2 * 25 * 128 * 4 + 10 * 128 * 4
        + 2 * 208 * 4 + 208 * 12 * 4 + 16 * 216 * 2 + 208 * 104 * 2 + 16 * 256 * 4 + 16)
    assert smem(10, 197, 256, 512, 512, 8, True) == (
        16 * 264 * 2 + 256 * 72 * 2 + 16 * 520 * 2 + 32 * 520 * 2 + 2 * 208 * 4
        + 208 * 12 * 4 + 16 * 216 * 2 + 208 * 72 * 2 + 16 * 256 * 4 + 16)
    # what the wrapper refuses, either route
    with pytest.raises(ValueError, match="multiples? of 8"):
        route(80, 8, 197, 256, 60, 768, False)
    with pytest.raises(ValueError, match="the kernel takes"):
        route(80, 8, kernels.ATTEND_MAX_S + 1, 256, 128, 768, False)


# (route, W, widths) the launcher is given, one of each route
LAUNCH_SHAPES = (("grouped", 10, None), ("row", 1, None), ("general", 10, 72))


@pytest.mark.parametrize("route, W, odd", LAUNCH_SHAPES)
@pytest.mark.parametrize("dot", [False, True])
def test_launcher_rejects_cpu_tensors_and_counts_no_launch(route, W, odd, dot):
    """The CUDA wrapper checks the device before building or launching, on
    every route (10 beams of 2 memory rows at the presets' widths: the
    grouped read; one beam a row: the row read; widths off the 16-column
    steps: the general kernel), and counts no launch."""
    bf = torch.bfloat16
    Hq, A, Dv = (256, 512, 512) if dot else (256, 128, 768)
    if odd and dot:
        A = Dv = odd
    elif odd:
        A = odd
    B, S = 2, 9
    keys = torch.zeros(B, S, A, dtype=bf if dot else torch.float32)
    v = None if dot else torch.zeros(A, dtype=bf)
    assert kernels.attend_route(B * W, B, S, Hq, A, Dv, dot) == route
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.bahdanau_attend(torch.zeros(B * W, Hq), torch.zeros(Hq, A, dtype=bf), v, keys,
                                torch.zeros(B, S, Dv, dtype=bf), torch.zeros(B, S),
                                torch.zeros(B, S))
    assert kernels.LAUNCHES == before


def test_step_backward_keeps_a_memory_row_per_query_row():
    """The read loop's per-step backward takes N == B only: two query rows a
    memory row raise before any other check."""
    with pytest.raises(ValueError, match="a memory row per query row"):
        kernels.attend_step_bwd(torch.zeros(4, 8), torch.zeros(8, 8, dtype=torch.bfloat16),
                                torch.zeros(8, dtype=torch.bfloat16), torch.zeros(2, 5, 8),
                                torch.zeros(2, 5, 8, dtype=torch.bfloat16), torch.zeros(4, 5),
                                torch.zeros(4, 8), *(torch.zeros(4, n) for n in (5, 8, 8, 8, 8)))


def _cta_units(S, Hq, A, Dv, C, dot):
    """The units of partial sums each CTA r of a cluster of C writes, by
    product (q, Luong's scores, the context), as ``strip_product`` splits
    them: ng groups times ``_ksplit(ng, nk)`` warps."""
    nq, nv, S_pad = A // 16, Dv // 16, -(-S // 16) * 16
    SCP = -(-(-(-S // C)) // 16) * 16
    for r in range(C):
        nqg = (r + 1) * nq // C - r * nq // C
        nvg = (r + 1) * nv // C - r * nv // C
        yield r, "q", nqg * _ksplit(nqg, Hq // 16) if nqg else 0
        if dot:
            yield r, "scores", SCP // 16 * _ksplit(SCP // 16, A // 16)
        yield r, "context", nvg * _ksplit(nvg, S_pad // 16) if nvg else 0


@pytest.mark.parametrize("C", kernels.ATTEND_GROUP_CLUSTERS)
@pytest.mark.parametrize("dot", [False, True])
def test_partial_sums_hold_every_cta(C, dot):
    """``attend_grouped_units`` (the ``part`` region of the layout, and of
    ``attend_grouped_smem``) holds the products of every CTA of the cluster,
    not only of the CTA that owns the most column groups, at every width the
    grouped read takes: with 17 groups of q over 8 CTAs, 7 CTAs own 2 groups
    split over 8 warps each (16 units) and one owns 3 over 5 (15)."""
    for A in range(16, 513, 16):
        for Dv in (16, 48, 112, 272, 512, 768, 1040, 2048):
            for S in (1, 7, 100, 197, 531):
                units = kernels.attend_grouped_units(S, A, Dv, C, dot)
                for r, what, n in _cta_units(S, 256, A, Dv, C, dot):
                    assert n <= units, (A, Dv, S, r, what, n, units)
    if C == 8:
        worst = {r: n for r, what, n in _cta_units(197, 512, 272, 768, 8, dot) if what == "q"}
        assert worst[7] == 15 and max(worst.values()) == 16
        assert kernels.attend_grouped_units(197, 272, 768, 8, dot) == 16
