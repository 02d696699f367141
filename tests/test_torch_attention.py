"""The port's Bahdanau and Luong attention (``avsr_tpu_torch/ops/attention.py``)
against ``avsr_tpu.ops.attention``: the init trees, the prepared memory
(keys, values, mask, bias), the read ``attend`` (K10's plain twin, and the
wrapper on CPU tensors), and mirrors of ``tests/test_attention.py``'s
masking invariants.

Inputs come from seeded numpy and the weights from ``attention_init`` in
the JAX package, converted with ``convert.from_jax``.  Tolerances: fp32 at
atol / rtol 1e-5 (one tanh, one softmax and a few fp32 sums in another
order); the bf16 policy at atol 1e-2 (both sides round the same operands
to bf16, but an energy whose fp32 value lands on a bf16 rounding boundary
can flip by one ulp, 2^-8 relative, and move a score by that much of a v
entry; Luong's q is rounded to bf16 before its dot with the bf16 keys on
both sides, so only the fp32 sums' order differs); masked weights exactly
0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.ops import attention as jattn
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.ops import attention as tattn

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _setup(seed, lengths, S=7, H=6, Q=5, A=4, value_dim=None, dtype="float32",
           attention_type="bahdanau"):
    """JAX params, memory and query; the port's converted params and the
    prepared memories of both packages."""
    jdt, tdt = DT[dtype]
    rng = np.random.default_rng(seed)
    B = len(lengths)
    params = jattn.attention_init(attention_type, jax.random.PRNGKey(seed), Q, H, A,
                                  value_dim=value_dim)
    memory = rng.standard_normal((B, S, H)).astype(np.float32)
    query = rng.standard_normal((B, Q)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    mem_j = jattn.prepare_memory(attention_type, params, jnp.asarray(memory), jnp.asarray(lens),
                                 compute_dtype=jdt)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    mem_t = tattn.prepare_memory(attention_type, tparams, torch.from_numpy(memory),
                                 torch.from_numpy(lens), tdt)
    return params, tparams, memory, query, mem_j, mem_t


@pytest.mark.parametrize("attention_type", ["bahdanau", "luong"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("value_dim", [None, 3])
def test_attend_matches_jax(dtype, value_dim, attention_type):
    """Context and weights over a batch with full, ragged and empty rows."""
    jdt, tdt = DT[dtype]
    params, tparams, _, query, mem_j, mem_t = _setup(0, [7, 3, 0, 5], value_dim=value_dim,
                                                     dtype=dtype, attention_type=attention_type)
    ctx_j, w_j = jattn.attend(attention_type, params, jnp.asarray(query), mem_j,
                              compute_dtype=jdt)
    ctx_t, w_t = tattn.attend_plain(attention_type, tparams, torch.from_numpy(query), mem_t, tdt)
    assert ctx_t.dtype == w_t.dtype == torch.float32
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=0)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), **tol)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), **tol)
    assert float(w_t[1, 3:].abs().max()) == 0.0 and float(w_t[2].abs().max()) == 0.0
    assert float(ctx_t[2].abs().max()) == 0.0
    # on CPU tensors the K10 wrapper is the plain twin
    ctx_w, w_w = tattn.attend(attention_type, tparams, torch.from_numpy(query), mem_t, tdt)
    assert torch.equal(ctx_w, ctx_t) and torch.equal(w_w, w_t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepare_memory_matches_jax(dtype):
    """Keys fp32 from compute-dtype operands, values (projected or not),
    mask and the -1e30 bias."""
    for value_dim in (None, 3):
        _, _, _, _, mem_j, mem_t = _setup(1, [7, 2, 0], value_dim=value_dim, dtype=dtype)
        assert mem_t.keys.dtype == torch.float32
        tol = 1e-5 if dtype == "float32" else 1e-2
        np.testing.assert_allclose(mem_t.keys.numpy(), np.asarray(mem_j.keys), atol=tol, rtol=tol)
        np.testing.assert_allclose(mem_t.values.float().numpy(),
                                   np.asarray(mem_j.values, np.float32), atol=tol, rtol=tol)
        np.testing.assert_array_equal(mem_t.mask.numpy(), np.asarray(mem_j.mask))
        np.testing.assert_array_equal(mem_t.bias.numpy(), np.asarray(mem_j.bias))


def test_value_only_memory_has_no_keys():
    memory = torch.randn(2, 4, 6)
    mem = tattn.prepare_memory("value_only", {}, memory, torch.tensor([4, 1]), torch.float32)
    assert mem.keys is None and torch.equal(mem.values, memory)
    assert mem._fields == ("values", "keys", "mask", "bias")


def test_padded_positions_zero_weight():
    """Mirror of tests/test_attention.py::test_padded_positions_zero_weight[bahdanau]."""
    _, tparams, _, query, _, mem = _setup(2, [7, 3])
    ctx, w = tattn.attend("bahdanau", tparams, torch.from_numpy(query), mem, torch.float32)
    np.testing.assert_allclose(w[1, 3:].numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(w.sum(dim=1).numpy(), 1.0, rtol=1e-5)
    assert tuple(ctx.shape) == (2, 6)


def test_context_is_convex_combination():
    """Mirror of tests/test_attention.py::test_context_is_convex_combination[bahdanau]."""
    _, tparams, memory, query, _, mem = _setup(3, [4], S=4, H=3, Q=3, A=4)
    ctx, w = tattn.attend("bahdanau", tparams, torch.from_numpy(query), mem, torch.float32)
    manual = (w.numpy()[0][:, None] * memory[0]).sum(0)
    np.testing.assert_allclose(ctx.numpy()[0], manual, rtol=1e-5, atol=1e-6)


def test_fully_masked_memory_gives_zero_context():
    """Mirror of tests/test_attention.py::test_fully_masked_memory_gives_zero_context."""
    _, tparams, _, query, _, mem = _setup(4, [0], S=4, H=3, Q=3, A=4)
    ctx, w = tattn.attend("bahdanau", tparams, torch.from_numpy(query), mem, torch.float32)
    np.testing.assert_allclose(w.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(ctx.numpy(), 0.0, atol=1e-6)


def test_luong_is_not_ported():
    """Luong attention is ported now (it used to raise "not ported"): its
    init tree (``wq [query, memory]``, ``wv`` when asked, no ``wm`` or
    ``v``) and its prepared memory (the keys ARE the raw memory, unprojected)
    equal the reference's; an unknown attention type still raises."""
    for value_dim in (None, 3):
        params = jattn.attention_init("luong", jax.random.PRNGKey(0), 5, 6, 4,
                                      value_dim=value_dim)
        tparams = tattn.attention_init("luong", torch.Generator().manual_seed(0), 5, 6, 4,
                                       "cpu", value_dim=value_dim)
        assert list(tparams) == list(params) == (["wq"] if value_dim is None else ["wq", "wv"])
        assert {k: tuple(v.shape) for k, v in tparams.items()} == \
            {k: tuple(v.shape) for k, v in params.items()}
        for dtype in DT:
            _, _, memory, _, mem_j, mem_t = _setup(1, [7, 2, 0], value_dim=value_dim,
                                                   dtype=dtype, attention_type="luong")
            assert torch.equal(mem_t.keys, torch.from_numpy(memory))
            np.testing.assert_array_equal(mem_t.keys.numpy(), np.asarray(mem_j.keys))
            tol = 1e-5 if dtype == "float32" else 1e-2
            np.testing.assert_allclose(mem_t.values.float().numpy(),
                                       np.asarray(mem_j.values, np.float32), atol=tol, rtol=tol)
            np.testing.assert_array_equal(mem_t.mask.numpy(), np.asarray(mem_j.mask))
            np.testing.assert_array_equal(mem_t.bias.numpy(), np.asarray(mem_j.bias))
            if value_dim is None:  # one tensor serves as the keys and the values
                assert mem_t.keys is mem_t.values
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="unknown attention type"):
        tattn.attention_init("dot", gen, 4, 6, 4, "cpu")
    with pytest.raises(ValueError, match="unknown attention type"):
        tattn.prepare_memory("dot", {}, torch.zeros(1, 2, 3), torch.tensor([2]), torch.float32)


def test_bahdanau_init_shapes_and_keys_match_jax():
    params = jattn.attention_init("bahdanau", jax.random.PRNGKey(0), 5, 6, 4, value_dim=3)
    tparams = tattn.attention_init("bahdanau", torch.Generator().manual_seed(0), 5, 6, 4, "cpu",
                                   value_dim=3)
    assert list(tparams) == list(params)
    assert {k: tuple(v.shape) for k, v in tparams.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}


def test_kernel_rejects_cpu_tensors():
    """The CUDA entry point checks its operands before it builds anything."""
    N, S, A, Dv = 2, 5, 8, 16
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.bahdanau_attend(torch.zeros(N, 4), torch.zeros(4, A, dtype=torch.bfloat16),
                                torch.zeros(A, dtype=torch.bfloat16), torch.zeros(N, S, A),
                                torch.zeros(N, S, Dv, dtype=torch.bfloat16), torch.zeros(N, S),
                                torch.zeros(N, S))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):  # the Luong read: no v
        kernels.bahdanau_attend(torch.zeros(N, 4), torch.zeros(4, A, dtype=torch.bfloat16),
                                None, torch.zeros(N, S, A, dtype=torch.bfloat16),
                                torch.zeros(N, S, Dv, dtype=torch.bfloat16), torch.zeros(N, S),
                                torch.zeros(N, S))
    assert kernels.LAUNCHES == before
