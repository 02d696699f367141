"""K10's row read: one query row a memory row (greedy decode and the
teacher-forced loop's forward).

The CUDA kernel (``csrc/attend_row.cuh``) streams each memory row through a
ring of slots of shared memory: the keys' chunks, then the values' (or, for
Luong's one tensor where the row fits, the keys' chunks again).  These
tests hold, on the CPU: the route table (``kernels.attend_route`` sends W =
1 at the presets' widths and at 16 s to the row read, every other shape to
its old route, by shape alone); the Python mirror of the kernel's shared
memory (``kernels.attend_row_smem``) and chunk plan
(``kernels.attend_row_plan``) within a block's shared memory and covering
every key once; a torch mirror of the kernel's walk (chunk by chunk, the
context's slices in the kernel's key order, ``div_row``'s quotients)
against the plain twin; and the plain twin at W = 1
against the JAX package's ``attend`` for both scores, with a 0-length row
and a 16 s memory (S = 531).

Tolerances: fp32 twin against JAX at atol 1e-5 on the weights and 1e-4 on
the contexts (sums in another order); under the bf16 policy chip_smoke's
K10_W_TOL 1e-3 on the weights and K10_CTX_TOL 2e-2 on the contexts (an
energy's or q's bf16 rounding that flips after another summation order
moves a score by ~2^-9 of a term; bf16 weights times bf16 values of order
one).  The mirror against the twin: the same, as the kernel is held on the
card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.ops import attention as jattn
from avsr_tpu_torch import kernels
from avsr_tpu_torch.ops import attention as tattn

F32_W, F32_CTX = dict(atol=1e-5, rtol=0), dict(atol=1e-4, rtol=0)
BF16_W, BF16_CTX = dict(atol=1e-3, rtol=0), dict(atol=2e-2, rtol=0)
# the presets' decoder widths: lrs2_av_align's, and lrs2_av_align_uni_luong's
# one 512-wide memory
BAHDANAU = dict(Hq=256, A=128, Dv=768)
LUONG = dict(Hq=256, A=512, Dv=512)
PRESETS = (("bahdanau", BAHDANAU), ("luong", LUONG))
S_16S = kernels.ATTEND_MAX_S  # the audio steps of 16 s


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _read(typ, seed, B, S, Hq, A, Dv, cdt, lens=None):
    """The read's operands from numpy at one query a row: params, queries
    [B, Hq] and a prepared memory of B rows (Bahdanau: keys [B, S, A] fp32
    projected from a [B, S, Dv] memory; Luong: one [B, S, A] memory as keys
    and values), row 1 of length 0."""
    rng = np.random.default_rng(seed)
    query = (0.5 * rng.standard_normal((B, Hq))).astype(np.float32)
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


# ---- the route table ---------------------------------------------------------


@pytest.mark.parametrize("typ, widths", PRESETS, ids=["bahdanau", "luong"])
@pytest.mark.parametrize("S", [1, 50, 150, 197, S_16S])
@pytest.mark.parametrize("B", [1, 8, 128])
def test_one_query_a_row_takes_the_row_read(typ, widths, S, B):
    """W = 1 at the presets' widths, over every memory length up to 16 s and
    at every batch: the row read; the same shape with beams keeps its
    route (the grouped read for 2 to 16 beams, the general kernel past 16)."""
    Hq, A, Dv, dot = widths["Hq"], widths["A"], widths["Dv"], typ == "luong"
    assert kernels.attend_route(B, B, S, Hq, A, Dv, dot) == "row"
    assert kernels.attend_row_admits(Hq, A, S, Dv, dot)
    assert kernels.attend_route(10 * B, B, S, Hq, A, Dv, dot) == "grouped"
    assert kernels.attend_route(17 * B, B, S, Hq, A, Dv, dot) == "general"


@pytest.mark.parametrize("Hq, A, Dv", [(250, 128, 768), (256, 136, 768), (256, 128, 776),
                                       (256, 72, 768), (256, 8, 512), (8, 16, 16)])
@pytest.mark.parametrize("dot", [False, True])
def test_widths_off_sixteen_keep_the_general_kernel(Hq, A, Dv, dot):
    """One query a row at widths that are not multiples of 16 (or below
    16): the general kernel, a block per query row, as before."""
    for B in (1, 8, 128):
        assert kernels.attend_route(B, B, 197, Hq, A, Dv, dot) == "general"
    assert not kernels.attend_row_admits(Hq, A, 197, Dv, dot)


def test_route_is_a_function_of_shape_alone():
    """The same shape gives the same route every call, and the wrapper's
    limits raise on either route before any route is taken."""
    shapes = [(128, 128, 197, 256, 128, 768, False), (128, 128, 531, 256, 512, 512, True),
              (80, 8, 197, 256, 128, 768, False), (80, 8, 197, 256, 72, 768, False),
              (16, 16, 9, 16, 16, 16, True)]
    first = [kernels.attend_route(*s) for s in shapes]
    assert first == ["row", "row", "grouped", "general", "row"]
    for _ in range(3):
        assert [kernels.attend_route(*s) for s in shapes] == first
    with pytest.raises(ValueError, match="the kernel takes"):
        kernels.attend_route(128, 128, S_16S + 1, 256, 128, 768, False)
    with pytest.raises(ValueError, match="multiples? of 8"):
        kernels.attend_route(128, 128, 197, 256, 60, 768, False)


def test_counters_name_each_route():
    """Each route counts its launches under a name of its own, every one a
    ``LAUNCHES`` entry."""
    names = {(r, dot): kernels.attend_counter(r, dot) for r in ("grouped", "row", "general")
             for dot in (False, True)}
    assert names == {("grouped", False): "bahdanau_attend_grouped",
                     ("row", False): "bahdanau_attend_row",
                     ("general", False): "bahdanau_attend",
                     ("grouped", True): "luong_attend_grouped",
                     ("row", True): "luong_attend_row", ("general", True): "luong_attend"}
    assert set(names.values()) <= set(kernels.LAUNCHES)


@pytest.mark.parametrize("typ, widths", PRESETS, ids=["bahdanau", "luong"])
def test_launcher_rejects_cpu_tensors_and_counts_no_launch(typ, widths):
    """The CUDA wrapper checks the device before building or launching on
    the row route, and counts no launch."""
    bf = torch.bfloat16
    Hq, A, Dv, dot = widths["Hq"], widths["A"], widths["Dv"], typ == "luong"
    B, S = 2, 9
    assert kernels.attend_route(B, B, S, Hq, A, Dv, dot) == "row"
    keys = torch.zeros(B, S, A, dtype=bf if dot else torch.float32)
    v = None if dot else torch.zeros(A, dtype=bf)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.bahdanau_attend(torch.zeros(B, Hq), torch.zeros(Hq, A, dtype=bf), v, keys,
                                torch.zeros(B, S, Dv, dtype=bf), torch.zeros(B, S),
                                torch.zeros(B, S))
    assert kernels.LAUNCHES == before


# ---- the shared memory and the chunk plan ------------------------------------


def _layout_regions(Hq, A, S, Dv, dot):
    """``Layout`` of ``csrc/attend_row.cuh``, region by region (bytes)."""
    up16 = lambda x: (x + 15) // 16 * 16  # noqa: E731
    return {"ring": kernels.ATTEND_ROW_SLOTS * kernels.ATTEND_ROW_SLOT, "q": up16(4 * A),
            "v": 0 if dot else up16(4 * A), "qin": up16(8 * Hq), "p": up16(4 * S),
            "bias": up16(4 * S), "mask": up16(4 * S), "red": 2 * 16 * 4,
            "bars": (2 * kernels.ATTEND_ROW_SLOTS + 2) * 8}


@pytest.mark.parametrize("dot", [False, True])
@pytest.mark.parametrize("S", [1, 197, S_16S])
def test_layout_fits_at_every_admitted_shape(dot, S):
    """Every shape the row read admits holds its CTA within a block's shared
    memory; the mirror is the layout's regions summed; the presets' widths
    are admitted at every length up to 16 s."""
    n = 0
    for Hq in (16, 256, 512, 1024, 1040):
        for A in range(16, 513, 16):
            for Dv in (16, 256, 512, 768, 1024, 2048):
                smem = kernels.attend_row_smem(Hq, A, S, Dv, dot)
                assert smem == sum(_layout_regions(Hq, A, S, Dv, dot).values())
                if kernels.attend_row_admits(Hq, A, S, Dv, dot):
                    assert smem <= kernels.SMEM_LIMIT
                    n += 1
    assert n == 4 * 32 * 6  # every multiple of 16 up to these widths fits; Hq past 1024 not
    for _, w in PRESETS:
        assert kernels.attend_row_smem(w["Hq"], w["A"], S, w["Dv"], dot) <= kernels.SMEM_LIMIT


def test_layout_at_the_presets_widths():
    """The presets' CTA, region by region: the 200 KB ring and the rows."""
    assert kernels.attend_row_smem(256, 128, 197, 768, False) == (
        8 * 25600 + 512 + 512 + 2048 + 3 * 800 + 128 + 144)
    assert kernels.attend_row_smem(256, 512, 197, 512, True) == (
        8 * 25600 + 2048 + 2048 + 3 * 800 + 128 + 144)
    assert kernels.attend_row_smem(256, 512, S_16S, 512, True) == (
        8 * 25600 + 2048 + 2048 + 3 * 2128 + 128 + 144)


def _chunks(S, per, n):
    return [(c * per, min(S, (c + 1) * per)) for c in range(n)]


@pytest.mark.parametrize("S", [1, 7, 25, 197, 200, 201, 400, S_16S])
@pytest.mark.parametrize("typ, widths, same", [("bahdanau", BAHDANAU, False),
                                               ("luong", LUONG, True), ("luong", LUONG, False),
                                               ("odd", dict(Hq=16, A=272, Dv=2048), False)])
def test_chunk_plan_covers_every_key_once(S, typ, widths, same):
    """The keys' chunks and the values' (or, resident, the keys' again)
    cover [0, S) once each, in order; every chunk fits a slot and is a whole
    number of 16-byte units (one bulk copy); Luong's one tensor is read once
    where it fits the ring (S <= 200 at 512 columns), else in two passes."""
    A, Dv = widths["A"], widths["Dv"]
    dot = typ == "luong"
    plan = kernels.attend_row_plan(S, A, Dv, dot, same)
    kb, vb = A * (2 if dot else 4), Dv * 2
    for per, n, rb in ((plan["kc"], plan["nk"], kb), (plan["vc"], plan["nv"], vb)):
        if n == 0:
            continue
        chunks = _chunks(S, per, n)
        keys = [s for a, b in chunks for s in range(a, b)]
        assert keys == list(range(S))
        assert all(b > a for a, b in chunks)
        assert all((b - a) * rb <= kernels.ATTEND_ROW_SLOT and (b - a) * rb % 16 == 0
                   for a, b in chunks)
    resident = plan["nv"] == 0
    assert resident == (same and S <= kernels.ATTEND_ROW_SLOTS * (kernels.ATTEND_ROW_SLOT // kb))
    if resident:
        assert plan["nk"] <= kernels.ATTEND_ROW_SLOTS and plan["kc"] == plan["vc"]
    if typ == "luong" and same:
        assert resident == (S <= 200)


@pytest.mark.parametrize("S, per, csl", [(197, 16, 5), (197, 25, 8), (S_16S, 12, 5),
                                         (100, 7, 3), (5, 50, 8), (64, 16, 16)])
def test_context_slices_take_each_key_once_in_order(S, per, csl):
    """The context's thread slices over chunks of ``per`` keys: slice ``sl``
    takes key s where s = sl (mod csl), starting in each chunk at the
    kernel's first index ``s0 + ((sl - s0 % csl) + csl) % csl``; over the
    chunks each slice sees its keys in increasing order, so the sum order
    does not depend on the chunking, and every key lands in one slice."""
    seen = {sl: [] for sl in range(csl)}
    for s0 in range(0, S, per):
        s1 = min(S, s0 + per)
        for sl in range(csl):
            seen[sl] += list(range(s0 + ((sl - s0 % csl) + csl) % csl, s1, csl))
    for sl, keys in seen.items():
        assert keys == list(range(sl, S, csl))
    assert sorted(k for keys in seen.values() for k in keys) == list(range(S))


# ---- a torch mirror of the kernel's walk -------------------------------------


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _div_row(x, y):
    """``div_row`` from a correctly rounded reciprocal: q = x r, then one
    residual correction (fp32)."""
    r = torch.reciprocal(y)
    q = x * r
    return torch.addcmul(q, torch.addcmul(x, -y, q), r)


def row_mirror(typ, params, query, mem, same):
    """The row read as ``attend_row_kernel`` walks it, in fp32 torch: q, the
    scores chunk by chunk, the softmax with ``div_row``'s quotients, the
    context chunk by chunk over the kernel's slices (a thread per 8
    channels, ``CONSUMERS // (Dv / 8)`` slices), the slices' sums in order.
    -> (ctx [N, Dv], weights [N, S])."""
    dot = typ == "luong"
    wq = _bf16(params["wq"])
    keys = _bf16(mem.keys) if dot else mem.keys.float()
    values = _bf16(mem.values)
    N, S, A = keys.shape
    Dv = values.shape[-1]
    plan = kernels.attend_row_plan(S, A, Dv, dot, same)
    ctxs, ws = [], []
    for n in range(N):
        qin = _bf16(query[n])
        q = qin @ wq
        if dot:
            q = _bf16(q)
        sc = torch.empty(S)
        for a, b in _chunks(S, plan["kc"], plan["nk"]):
            k = keys[n, a:b]
            if dot:
                sc[a:b] = k @ q
            else:
                sc[a:b] = _bf16(torch.tanh(k + q)) @ _bf16(params["v"])
        sc = sc + mem.bias[n]
        p = torch.exp(sc - sc.max())
        p = _div_row(p, p.sum()) * mem.mask[n]
        denom = torch.clamp(p.sum(), min=1e-9)
        w = _div_row(p, denom) * torch.clamp(mem.mask[n].sum(), max=1.0)
        pw = _bf16(w)
        csl = kernels.ATTEND_ROW_CONSUMERS // (Dv // 8)
        parts = torch.zeros(csl, Dv)
        per, nc = (plan["vc"], plan["nv"]) if plan["nv"] else (plan["kc"], plan["nk"])
        for a, b in _chunks(S, per, nc):
            for s in range(a, b):
                if pw[s] != 0:
                    parts[s % csl] += pw[s] * values[n, s]
        ctx = torch.zeros(Dv)
        for j in range(csl):
            ctx = ctx + parts[j]
        ctxs.append(ctx)
        ws.append(w)
    return torch.stack(ctxs), torch.stack(ws)


@pytest.mark.parametrize("typ, S, same", [("bahdanau", 37, False), ("bahdanau", S_16S, False),
                                          ("luong", 37, True), ("luong", S_16S, True),
                                          ("luong", 37, False)])
def test_row_mirror_matches_the_twin(typ, S, same):
    """The kernel's walk (Bahdanau's two streams; Luong's one tensor read
    once, or in two passes at 16 s, or its keys a tensor apart) computes the
    plain twin's read under the bf16 policy, a 0-length row's weights and
    context exactly 0."""
    _, tparams, query, _, _, mem = _read(typ, S + 3, 3, S, 32, 32, 48 if typ == "bahdanau"
                                         else 32, torch.bfloat16)
    if typ == "luong" and not same:
        mem = mem._replace(keys=mem.values.clone())
    q = torch.from_numpy(query)
    ctx_m, w_m = row_mirror(typ, tparams, q, mem, same)
    ctx_t, w_t = tattn.attend_plain(typ, tparams, q, mem, torch.bfloat16)
    torch.testing.assert_close(w_m, w_t, **BF16_W)
    torch.testing.assert_close(ctx_m, ctx_t, **BF16_CTX)
    assert float(w_m[1].abs().max()) == 0.0 == float(ctx_m[1].abs().max())


# ---- the plain twin at one query a row against JAX ---------------------------


@pytest.mark.parametrize("typ", ["bahdanau", "luong"])
@pytest.mark.parametrize("S", [9, 197, S_16S])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_at_one_query_a_row_matches_jax(typ, S, dtype):
    """The plain twin (the CPU side of the row route) at W = 1 against the
    reference's ``attend`` (``avsr_tpu/ops/attention.py:125``), a 0-length
    row reading zeros, memories up to 16 s."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    params, tparams, query, memory, lens, mem = _read(typ, S, 4, S, 16, 16, 24, tdt)
    jp = {k: jnp.asarray(x) for k, x in params.items()}
    mem_j = jattn.prepare_memory(typ, jp, jnp.asarray(memory), jnp.asarray(lens),
                                 compute_dtype=jdt)
    ctx_j, w_j = jattn.attend(typ, jp, jnp.asarray(query), mem_j, compute_dtype=jdt)
    ctx_t, w_t = tattn.attend_plain(typ, tparams, torch.from_numpy(query), mem, tdt)
    tol_w, tol_c = (F32_W, F32_CTX) if dtype == "float32" else (BF16_W, BF16_CTX)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), **tol_w)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), **tol_c)
    assert float(w_t[1].abs().max()) == 0.0 == float(ctx_t[1].abs().max())
