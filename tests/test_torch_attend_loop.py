"""K10's backward as a read loop (``avsr_tpu_torch/ops/attention.py``:
``open_read_loop``, ``BahdanauAttend``, ``read_step_bwd``,
``read_loop_sums``): each step's backward saves the scores' cotangent, the
context's cotangent and q and returns only dquery; the memory's gradients
are summed once, after the last step's backward, and the weight gradients
are one product over the steps.  On CPU tensors the route runs its plain
mirror (``read_step_bwd_plain``, ``read_loop_sums_plain``), which these
tests hold against:

- the per-step twin ``attend_bwd_plain`` (each step's memory gradient
  formed and added inside the loop), summed over the steps;
- ``jax.vjp`` of ``avsr_tpu.models.decoder.teacher_forced_logits`` through
  the memories' keys and values, ``wq``, ``v`` and every weight of the
  query path (embedding, LSTM, output projection);

for both reads, fp32 and bf16, with and without a value projection, a
Luong memory that is its own keys, two memories in one loop, ragged
lengths with a 0-length memory row, and S = 531 (16 s of audio steps) on
narrow widths.

Tolerances, as the relative error of each gradient's norm:
- against the twin, fp32 1e-5: the same terms summed in another order
  (seen: 7.5e-8); bf16 1e-2: the twin rounds each step's dvalues term (and
  Luong's dkeys term) to bf16, as the reference's transposed casts do,
  the mirror sums the exact terms and the kernels sum them to ~2^-16
  (seen: 2.2e-3, on dvalues);
- against JAX, fp32 1e-5 (seen: 5.0e-7); bf16 1e-2: the reference's
  per-step rounding as above, and an LSTM gate or an energy on a bf16
  rounding boundary lands one ulp (2^-8) apart and the recurrence carries
  it on (seen: 2.4e-3, on dvalues).
A 0-length memory row's gradients are exactly 0 on every side: its
weights are exactly 0, so every term it adds is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import DecoderConfig
from avsr_tpu.models import decoder as jdec
from avsr_tpu.ops import attention as jattn
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.models import decoder as tdec
from avsr_tpu_torch.ops import attention as tattn
from avsr_tpu_torch.utils.numerics import rounded

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
LENGTHS = (7, 3, 0, 5)  # row 2's memory is empty


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


# ---- the loop against the per-step twin -------------------------------------


def _twin_case(attention_type, dtype, *, shared=False, value_dim=None, S=7, lengths=LENGTHS,
               K=5, Hq=5, H=6, A=8, seed=0, steps_in_loss=None):
    """K reads of one memory through a read loop and through the per-step
    twin: ([dquery per step, dwq, (dv,) dkeys, dvalues] from the loop, the
    same from the twin).  ``shared``: a Luong memory that is its own keys
    and values (one gradient, the sum of both paths).  ``steps_in_loss``:
    the steps whose context reaches the loss (default all)."""
    _, tdt = DT[dtype]
    gen = torch.Generator().manual_seed(seed)
    params = tattn.attention_init(attention_type, gen, Hq, H, A, "cpu", value_dim=value_dim)
    memory = torch.randn((len(lengths), S, H), generator=gen)
    queries = 0.5 * torch.randn((K, len(lengths), Hq), generator=gen)
    mem = tattn.prepare_memory(attention_type, params, memory, torch.tensor(lengths), tdt)
    dctx = torch.randn((K, len(lengths), mem.values.shape[-1]), generator=gen)
    steps = range(K) if steps_in_loss is None else steps_in_loss

    # the loop route
    p = {k: _leaf(x) for k, x in params.items()}
    q = _leaf(queries)
    if shared:
        m = _leaf(memory)
        lmem = tattn.prepare_memory(attention_type, p, m, torch.tensor(lengths), tdt)
        assert lmem.keys is lmem.values
        mem_leaves = [m]
    else:
        keys, values = _leaf(mem.keys), _leaf(mem.values)
        lmem = mem._replace(keys=keys, values=values)
        mem_leaves = [keys, values]
    loop = tattn.open_read_loop(attention_type, p, lmem, tdt, K)
    ctxs = [tattn.attend(attention_type, p, q[k], lmem, tdt, loop=loop)[0] for k in range(K)]
    w_leaves = [p["wq"]] + ([p["v"]] if "v" in p else [])
    got = torch.autograd.grad([ctxs[k] for k in steps], [q] + w_leaves + mem_leaves,
                              [dctx[k] for k in steps])

    # the twin, step by step
    dq_all, dwq, dv = torch.zeros_like(queries), 0.0, 0.0
    dkeys, dvalues = 0.0, 0.0
    for k in steps:
        _, w = tattn.attend_plain(attention_type, params, queries[k], mem, tdt)
        dquery, dq, dv_rows, dk, dval = tattn.attend_bwd_plain(
            attention_type, params, queries[k], mem, w, dctx[k], tdt)
        g_wq, g_v = tattn.attention_weight_grads(queries[k], dq, dv_rows, tdt)
        dq_all[k] = dquery
        dwq = dwq + rounded(g_wq, tdt)
        if g_v is not None:
            dv = dv + rounded(g_v, tdt)
        dkeys, dvalues = dkeys + dk, dvalues + dval
    want = [dq_all, dwq] + ([dv] if "v" in p else [])
    want += [dkeys + dvalues] if shared else [dkeys, dvalues]
    return list(got), want


@pytest.mark.parametrize("attention_type, dtype, shared, value_dim", [
    ("bahdanau", "float32", False, None),
    ("bahdanau", "bfloat16", False, None),
    ("bahdanau", "float32", False, 4),
    ("luong", "float32", False, None),
    ("luong", "bfloat16", False, None),
    ("luong", "float32", True, None),
    ("luong", "bfloat16", True, None),
    ("luong", "bfloat16", False, 4),
], ids=["bahdanau-fp32", "bahdanau-bf16", "bahdanau-fp32-value-projection", "luong-fp32",
        "luong-bf16", "luong-fp32-keys-are-values", "luong-bf16-keys-are-values",
        "luong-bf16-value-projection"])
def test_loop_matches_the_per_step_twin_summed(attention_type, dtype, shared, value_dim):
    """dquery of every step, dwq, dv and the memory's gradients of a loop
    of 5 reads against the twin's per-step gradients summed; the empty
    row's query and memory get exactly 0."""
    got, want = _twin_case(attention_type, dtype, shared=shared, value_dim=value_dim)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape), i
        assert _rel(g.numpy(), w.numpy()) < TOL[dtype], (i, _rel(g.numpy(), w.numpy()))
    assert float(got[0][:, 2].abs().max()) == 0.0
    for g in got[-1:] if shared else got[-2:]:
        assert float(g[2].abs().max()) == 0.0
        assert float(g[1, 3:].abs().max()) == 0.0  # row 1's padded positions


@pytest.mark.parametrize("attention_type", ["bahdanau", "luong"])
def test_loop_at_the_longest_memory(attention_type):
    """S = 531 (the audio steps of 16 s, ``kernels.ATTEND_MAX_S``) on narrow
    widths, a ragged batch with an empty row."""
    got, want = _twin_case(attention_type, "float32", S=kernels.ATTEND_MAX_S,
                           lengths=(531, 200, 0), K=4, Hq=4, H=8, A=8, seed=3)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) < TOL["float32"]
    assert float(got[-1][2].abs().max()) == 0.0 and float(got[-2][2].abs().max()) == 0.0


def test_steps_that_reach_no_loss_add_nothing():
    """A step whose context reaches no loss never runs its backward: its
    saved rows are zeroed before the sums, so the loop's gradients are the
    other steps' alone."""
    got, want = _twin_case("bahdanau", "float32", K=4, steps_in_loss=(0, 2))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) < TOL["float32"]


def test_a_second_backward_through_the_graph_gives_the_same_gradients():
    gen = torch.Generator().manual_seed(4)
    p = {k: _leaf(x) for k, x in tattn.attention_init("bahdanau", gen, 5, 6, 8, "cpu").items()}
    memory = _leaf(torch.randn((3, 6, 6), generator=gen))
    mem = tattn.prepare_memory("bahdanau", p, memory, torch.tensor([6, 2, 0]), torch.float32)
    q = _leaf(torch.randn((3, 3, 5), generator=gen))
    loop = tattn.open_read_loop("bahdanau", p, mem, torch.float32, 3)
    ctx = torch.stack([tattn.attend("bahdanau", p, q[k], mem, torch.float32, loop=loop)[0]
                       for k in range(3)])
    dctx = torch.randn(ctx.shape, generator=gen)
    leaves = [memory, q, p["wq"], p["v"], p["wm"]]
    first = torch.autograd.grad(ctx, leaves, dctx, retain_graph=True)
    second = torch.autograd.grad(ctx, leaves, dctx)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ---- the teacher-forced decoder against jax.vjp ------------------------------


def _decoder_case(dtype, attention_type, value_dim, n_mem, seed=0, K=6, B=4, Vv=11):
    """jax.vjp of ``teacher_forced_logits`` and torch autograd of the port's
    through the same random weights, memories and logits cotangent:
    (names, port gradients, JAX gradients).  Each memory enters through
    its prepared keys and values, or, where the keys are the values (Luong
    without a value projection), through the raw memory."""
    jdt, tdt = DT[dtype]
    cfg = DecoderConfig(embedding_dim=8, hidden_units=(12,), attention_units=8,
                        memory_value_dim=value_dim, attention_type=attention_type,
                        dropout_rate=0.0)
    dims = [10, 6][:n_mem]
    params = jdec.decoder_init(jax.random.PRNGKey(seed), cfg, dims, Vv)
    rng = np.random.default_rng(seed)
    S = (7, 5)
    memories = [rng.standard_normal((B, S[i], dims[i])).astype(np.float32) for i in range(n_mem)]
    lens = [np.asarray(LENGTHS, np.int32), np.asarray((5, 0, 2, 4), np.int32)][:n_mem]
    targets = rng.integers(3, Vv, (B, K)).astype(np.int32)
    tlen = np.asarray([K, 3, K, 1], np.int32)
    dlogits = rng.standard_normal((B, K, Vv)).astype(np.float32)
    raw = attention_type == "luong" and value_dim is None

    def jmems(params, inputs):
        out = []
        for i, x in enumerate(inputs):
            if raw:
                out.append(jattn.prepare_memory(attention_type, params["atts"][i], x,
                                                jnp.asarray(lens[i]), compute_dtype=jdt))
            else:
                m = jattn.prepare_memory(attention_type, params["atts"][i],
                                         jnp.asarray(memories[i]), jnp.asarray(lens[i]),
                                         compute_dtype=jdt)
                out.append(m._replace(keys=x[0], values=x[1]))
        return out

    if raw:
        j_inputs = [jnp.asarray(m) for m in memories]
    else:
        j_inputs = []
        for i in range(n_mem):
            m = jattn.prepare_memory(attention_type, params["atts"][i], jnp.asarray(memories[i]),
                                     jnp.asarray(lens[i]), compute_dtype=jdt)
            j_inputs.append((m.keys, m.values))

    def f(params, inputs):
        return jdec.teacher_forced_logits(params, cfg, jnp.asarray(targets), jnp.asarray(tlen),
                                          jmems(params, inputs), compute_dtype=jdt)

    _, vjp = jax.vjp(f, params, j_inputs)
    g_params, g_inputs = vjp(jnp.asarray(dlogits))

    tparams = jax.tree_util.tree_map(_leaf, convert.from_jax(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    t_inputs, t_mems = [], []
    for i in range(n_mem):
        if raw:
            x = _leaf(torch.from_numpy(memories[i]))
            t_inputs.append(x)
            t_mems.append(tattn.prepare_memory(attention_type, tparams["atts"][i], x,
                                               torch.from_numpy(lens[i]), tdt))
            assert t_mems[-1].keys is t_mems[-1].values
        else:
            k, v = (_leaf(torch.from_numpy(np.asarray(a, np.float32))) for a in j_inputs[i])
            t_inputs += [k, v]
            m = tattn.prepare_memory(attention_type, tparams["atts"][i],
                                     torch.from_numpy(memories[i]), torch.from_numpy(lens[i]), tdt)
            t_mems.append(m._replace(keys=k, values=v))
    logits = tdec.teacher_forced_logits(tparams, cfg, torch.from_numpy(targets).long(),
                                        torch.from_numpy(tlen), t_mems, tdt)
    leaves = jax.tree_util.tree_leaves(tparams)
    got = torch.autograd.grad(logits, leaves + t_inputs, torch.from_numpy(dlogits),
                              allow_unused=True)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tparams)[0]]
    want = jax.tree_util.tree_leaves(convert.from_jax(
        jax.tree_util.tree_map(np.asarray, g_params), device="cpu"))
    mem_names = []
    for i in range(n_mem):
        if raw:
            mem_names.append(f"memory{i}")
            want.append(torch.from_numpy(np.asarray(g_inputs[i], np.float32)))
        else:
            mem_names += [f"keys{i}", f"values{i}"]
            want += [torch.from_numpy(np.asarray(a, np.float32)) for a in g_inputs[i]]
    return names + mem_names, got, want


@pytest.mark.parametrize("dtype, attention_type, value_dim, n_mem", [
    ("float32", "bahdanau", None, 1),
    ("bfloat16", "bahdanau", None, 1),
    ("float32", "bahdanau", 4, 2),
    ("bfloat16", "bahdanau", None, 2),
    ("float32", "luong", None, 1),
    ("bfloat16", "luong", None, 1),
    ("float32", "luong", 4, 1),
    ("bfloat16", "luong", None, 2),
], ids=["fp32-bahdanau", "bf16-bahdanau", "fp32-bahdanau-value-projection-two-memories",
        "bf16-bahdanau-two-memories", "fp32-luong-keys-are-values", "bf16-luong-keys-are-values",
        "fp32-luong-value-projection", "bf16-luong-two-memories"])
def test_teacher_forced_gradients_match_jax(dtype, attention_type, value_dim, n_mem):
    """Every weight's gradient (the reads' wq and v, the query path) and each
    memory's (keys and values, or the raw memory where it is both) through
    the teacher-forced loop; an empty memory row gets exactly 0."""
    names, got, want = _decoder_case(dtype, attention_type, value_dim, n_mem)
    for name, g, w in zip(names, got, want):
        if g is None:  # wm / wv where the keys and values enter as inputs: JAX's is zero
            assert float(w.abs().max()) == 0.0, name
            continue
        assert tuple(g.shape) == tuple(w.shape), name
        assert _rel(g.numpy(), w.numpy()) < TOL[dtype], (name, _rel(g.numpy(), w.numpy()))
    mem_grads = got[len(got) - len(names) + names.index(next(n for n in names if n.startswith(
        ("keys", "memory")))):]
    assert float(mem_grads[0][2].abs().max()) == 0.0  # memory 0's row 2 is empty
    if n_mem == 2:
        assert float(mem_grads[-1][1].abs().max()) == 0.0  # memory 1's row 1 is empty


def test_memory_gradient_reaches_autograd_once_per_loop(monkeypatch):
    """Two memories, six steps: the sums run once per memory, every step's
    backward forms no memory gradient, and one graph node (the loop's
    entry) feeds each memory tensor."""
    calls = {"sums": 0, "steps": 0}
    sums, step = tattn.read_loop_sums, tattn.read_step_bwd

    def count_sums(loop):
        calls["sums"] += 1
        return sums(loop)

    def count_step(*args):
        calls["steps"] += 1
        return step(*args)

    monkeypatch.setattr(tattn, "read_loop_sums", count_sums)
    monkeypatch.setattr(tattn, "read_step_bwd", count_step)
    names, got, _ = _decoder_case("float32", "bahdanau", None, 2, K=6)
    assert calls == {"sums": 2, "steps": 12}
    # the graph: each memory leaf's accumulator has exactly one producer
    cfg = DecoderConfig(embedding_dim=8, hidden_units=(12,), attention_units=8, dropout_rate=0.0)
    params = tdec.decoder_init(torch.Generator().manual_seed(0), cfg, [10], 11, "cpu")
    memory = _leaf(torch.randn(4, 7, 10))
    mem = tattn.prepare_memory("bahdanau", params["atts"][0], memory, torch.tensor(LENGTHS),
                               torch.float32)
    keys, values = _leaf(mem.keys), _leaf(mem.values)
    mem = mem._replace(keys=keys, values=values)
    logits = tdec.teacher_forced_logits(params, cfg, torch.randint(3, 11, (4, 6)),
                                        torch.tensor([6, 3, 6, 1]), [mem], torch.float32)
    producers = {id(keys): [], id(values): []}
    seen, todo = set(), [logits.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and hasattr(nxt, "variable") and id(nxt.variable) in producers:
                producers[id(nxt.variable)].append(type(node).__name__)
            todo.append(nxt)
    assert producers[id(keys)] == ["_ReadLoopEnterBackward"]
    assert producers[id(values)] == ["_ReadLoopEnterBackward"]


# ---- the kernels' routes and wrappers ----------------------------------------


def test_attend_loop_routing_table():
    """The memory sums' route by width alone: the tensor-core sums of
    ``av_align_bwd.cuh`` where A and Dv are multiples of 64 (every preset:
    lrs2_av_align's (128, 768), the uni-Luong (512, 512)), the CUDA-core
    kernel otherwise."""
    table = {(128, 768): "tensor_core", (512, 512): "tensor_core", (64, 64): "tensor_core",
             (128, 72): "cuda_core", (40, 768): "cuda_core", (8, 8): "cuda_core",
             (96, 512): "cuda_core"}
    for (A, Dv), family in table.items():
        assert kernels.attend_sums_family(A, Dv) == family, (A, Dv)


def test_loop_kernel_wrappers_reject_cpu_tensors():
    N, S, A, Dv, Hq, K = 2, 5, 8, 16, 4, 3
    f32, bf = torch.float32, torch.bfloat16
    z = torch.zeros
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.attend_step_bwd(z(N, Hq), z(Hq, A, dtype=bf), z(A, dtype=bf), z(N, S, A),
                                z(N, S, Dv, dtype=bf), z(N, S), z(N, Dv), z(N, S), z(N, Dv),
                                z(N, A), z(N, A), z(N, A))
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.attend_loop_sums(z(N, S, A, dtype=f32), z(A, dtype=bf), z(K, N, S), z(K, N, A),
                                 z(K, N, S), z(K, N, Dv))
    with pytest.raises(ValueError, match="expected a tensor on"):  # Luong: no v
        kernels.attend_loop_sums(z(N, S, A, dtype=bf), None, z(K, N, S), z(K, N, A), z(K, N, S),
                                 z(K, N, Dv))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("needs", ["query", "memory"])
def test_a_read_outside_a_loop_is_a_loop_of_one_step(needs):
    """``attend`` without a loop, when only the query or only the memory
    takes a gradient: one ``BahdanauAttend`` step, and the gradient the
    per-step twin gives."""
    gen = torch.Generator().manual_seed(6)
    params = tattn.attention_init("bahdanau", gen, 5, 6, 8, "cpu")
    mem = tattn.prepare_memory("bahdanau", params, torch.randn((3, 6, 6), generator=gen),
                               torch.tensor([6, 2, 0]), torch.float32)
    query = torch.randn((3, 5), generator=gen)
    dctx = torch.randn((3, 6), generator=gen)
    q = _leaf(query) if needs == "query" else query
    values = _leaf(mem.values) if needs == "memory" else mem.values
    ctx, w = tattn.attend("bahdanau", params, q, mem._replace(values=values), torch.float32)
    assert "BahdanauAttend" in type(ctx.grad_fn).__name__
    (got,) = torch.autograd.grad(ctx, [q if needs == "query" else values], dctx)
    want = tattn.attend_bwd_plain("bahdanau", params, query, mem, w.detach(), dctx,
                                  torch.float32)
    assert _rel(got.numpy(), (want[0] if needs == "query" else want[4]).numpy()) < 1e-6
