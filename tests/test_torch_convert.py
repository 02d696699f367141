"""Weight bridge between the JAX parameter tree and the PyTorch port.

The round trip JAX -> port -> JAX must be bit-exact for the full
``lrs2_av_fast`` tree (built with ``jax.eval_shape`` plus random numpy
leaves, so no full JAX init runs), and the port's own ``model_init`` must
build the same tree: keys, shapes and dtypes.
"""

import jax
import numpy as np
import pytest
import torch

from avsr_tpu import configs
from avsr_tpu.data.units import builtin_unit_dict
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu_torch import convert
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.utils.params import tree_map

torch.set_num_threads(1)


def _fast_tree_shapes():
    cfg = configs.lrs2_av_fast()
    vocab = builtin_unit_dict(cfg.data.unit).vocab_size
    shapes = jax.eval_shape(lambda k: jseq.model_init(k, cfg, vocab), jax.random.PRNGKey(0))
    return cfg, vocab, shapes


def _paths(tree, prefix=()):
    """Sorted (path, shape, dtype) of every leaf; empty containers kept."""
    if isinstance(tree, dict):
        if not tree:
            return [(prefix, "empty", None)]
        return sum((_paths(tree[k], prefix + (k,)) for k in sorted(tree)), [])
    if isinstance(tree, (list, tuple)):
        return sum((_paths(v, prefix + (i,)) for i, v in enumerate(tree)), [])
    return [(prefix, tuple(tree.shape), str(np.dtype(tree.dtype)))]


def test_round_trip_is_bit_exact_for_the_full_tree():
    _, _, shapes = _fast_tree_shapes()
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)
    back = convert.to_jax_numpy(convert.from_jax(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_conv_kernels_become_oihw():
    _, _, shapes = _fast_tree_shapes()
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    tree["video_frontend"]["convs"][1]["w"] = np.arange(
        3 * 3 * 8 * 16, dtype=np.float32).reshape(3, 3, 8, 16)
    port = convert.from_jax(tree)
    w = port["video_frontend"]["convs"][1]["w"]
    assert tuple(w.shape) == (16, 8, 3, 3)
    # OIHW[o, i, h, w] == HWIO[h, w, i, o]
    assert float(w[5, 2, 1, 0]) == tree["video_frontend"]["convs"][1]["w"][1, 0, 2, 5]


def test_port_model_init_matches_tree_shapes_and_dtypes():
    cfg, vocab, shapes = _fast_tree_shapes()
    params = tseq.model_init(cfg, vocab, torch.Generator().manual_seed(0))
    port_as_jax = convert.to_jax_numpy(params)
    assert _paths(port_as_jax) == _paths(shapes)


@pytest.mark.parametrize("seed", [0, 1])
def test_port_model_init_distributions(seed):
    cfg, vocab, _ = _fast_tree_shapes()
    p = tseq.model_init(cfg, vocab, torch.Generator().manual_seed(seed))
    layer = p["audio_encoder"]["layers"][0]["fwd"]
    H = layer["wh"].shape[0]
    # forget-gate bias 1, other gates 0 (gate order i, f, g, o)
    b = layer["b"]
    assert torch.all(b[H:2 * H] == 1.0) and torch.all(b[:H] == 0) and torch.all(b[2 * H:] == 0)
    # block-orthogonal recurrent weights: each [H, H] block is orthogonal
    for q in range(4):
        blk = layer["wh"][:, q * H:(q + 1) * H]
        torch.testing.assert_close(blk.T @ blk, torch.eye(H), atol=1e-4, rtol=0)
    # Glorot-uniform bound sqrt(6 / (fan_in + fan_out))
    wx = layer["wx"]
    limit = (6.0 / (wx.shape[0] + wx.shape[1])) ** 0.5
    assert float(wx.abs().max()) <= limit and float(wx.abs().max()) > 0.9 * limit
    emb = p["decoder"]["embedding"]
    assert abs(float(emb.std()) - 0.02) < 0.005
    assert all(torch.isfinite(x).all() for x in _leaves(p))


def _leaves(p):
    out = []
    tree_map(out.append, p)
    return out
