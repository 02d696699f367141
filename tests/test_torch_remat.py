"""``train.remat`` in the port: each encoder stack under
``torch.utils.checkpoint`` (``models/seq2seq.py`` ``_encoder_apply``).

* With remat against without, bit for bit on the CPU: the metrics and
  every gradient leaf of two train steps that draw from ONE generator (a
  recompute that left the generator moved would move the second step's
  draws), and the generator's state after them, for the lrs2_av_fast,
  lrs2_av_align, lrs2_av_v2 and LN-LSTM structures at small widths, with
  encoder dropout and (LSTM encoders) recurrent dropout on.
* With remat against JAX's ``train.remat=True`` at dropout 0: the loss at
  rtol 1e-5 and each gradient leaf at a relative norm error of 1e-4, the
  bounds of ``test_torch_train.py`` (fp32; summation order only).
* What remat relies on: every autograd Function inside an encoder keeps
  its residuals through ``save_for_backward`` (a tensor kept as a ``ctx``
  attribute would stay alive under remat), and every tensor saved inside
  the region is read by the backward (``saved_tensors_hooks``).
* A ``Trainer`` run with remat resumes a checkpoint written without it and
  ends bit-equal to the uninterrupted run.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from avsr_tpu.data.units import builtin_unit_dict
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu_torch import convert
from avsr_tpu_torch.models import encoder as tenc
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.train import optim as toptim
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.utils.params import tree_leaves, tree_map
from test_torch_align_slice import small_align_cfg
from test_torch_slice import small_fast_cfg
from test_torch_train import _by_path, _jbatch, batch_arrays, train_cfg
from test_torch_v2_slice import small_v2_cfg

RD = 0.2  # recurrent dropout of the LSTM encoders


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _with_dropout(cfg, rd=True):
    """Encoder dropout 0.2 and, for LSTM encoders, recurrent dropout."""
    def enc(e):
        return dataclasses.replace(e, dropout_rate=0.2,
                                   recurrent_dropout_rate=RD if rd else 0.0)
    return cfg.replace(audio_encoder=enc(cfg.audio_encoder), video_encoder=enc(cfg.video_encoder))


def _ln(cfg):
    return cfg.override({"audio_encoder.layer_norm": True, "video_encoder.layer_norm": True})


STRUCTURES = {
    "fast": lambda: _with_dropout(small_fast_cfg()),
    "align": lambda: _with_dropout(small_align_cfg()),
    "v2": lambda: _with_dropout(small_v2_cfg(), rd=False),
    "ln": lambda: _ln(_with_dropout(small_fast_cfg())),
}


def two_steps(cfg, params0, arrays, seed=5):
    """Two train steps' (metrics, gradients), both steps drawing from one
    generator, and the generator's state after them."""
    opt, _ = toptim.build_optimizer(cfg.train)
    state = tstep.train_state_from_params(params0, opt)
    batch = tseq.batch_to_device(arrays, "cpu")
    gen = torch.Generator().manual_seed(seed)
    out, opt_state = [], state.opt_state
    for _ in range(2):
        m, g = tstep.loss_and_grads(state.params, batch, cfg=cfg, generator=gen)
        out.append((m, g))
        leaves = tstep.param_leaves(state.params)
        opt_state = opt.update(leaves, [torch.zeros_like(p) if x is None else x
                                        for p, x in zip(leaves, g)], opt_state)
    return out, gen.get_state()


@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_remat_is_bit_equal_to_no_remat(structure):
    cfg = STRUCTURES[structure]()
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    params = tseq.model_init(cfg, V, torch.Generator().manual_seed(3), device="cpu")
    arrays = batch_arrays(0, V)
    plain, gen_plain = two_steps(cfg, params, arrays)
    remat, gen_remat = two_steps(cfg.override({"train.remat": True}), params, arrays)
    assert torch.equal(gen_plain, gen_remat)
    for (m_p, g_p), (m_r, g_r) in zip(plain, remat):
        assert set(m_p) == set(m_r)
        for k in m_p:
            assert torch.equal(m_p[k], m_r[k]), k
        assert len(g_p) == len(g_r)
        for i, (a, b) in enumerate(zip(g_p, g_r)):
            assert (a is None) == (b is None), i
            assert a is None or torch.equal(a, b), i
    # the second step is another step: the update and its draws moved it
    assert float(plain[0][0]["loss"]) != float(plain[1][0]["loss"])


def test_remat_matches_jax_remat():
    cfg = train_cfg(remat=True)
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    jparams = jseq.model_init(jax.random.PRNGKey(3), cfg, V)
    arrays = batch_arrays(0, V)
    lf = jax.jit(lambda p, b: jseq.loss_fn(p, cfg, b, train=True, rng=jax.random.PRNGKey(0)))
    (_, m_j), g_j = jax.value_and_grad(lf, has_aux=True)(jparams, _jbatch(arrays))
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    opt, _ = toptim.build_optimizer(cfg.train)
    state = tstep.train_state_from_params(tparams, opt)
    m_t, g_t = tstep.loss_and_grads(state.params, tseq.batch_to_device(arrays, "cpu"), cfg=cfg,
                                    generator=torch.Generator().manual_seed(0))
    for k in m_t:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    it = iter(g_t)
    grads = dict(tree_leaves(convert.to_jax_numpy(tree_map(lambda _: next(it), state.params))))
    want = _by_path(g_j)
    assert set(grads) == set(want)
    for k, w in want.items():
        err = np.linalg.norm(grads[k] - w) / np.linalg.norm(w)
        assert err < 1e-4, (k, err)


def _custom_nodes(root):
    """The autograd Function nodes of the graph under ``root``."""
    seen, stack, found = set(), [root], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if hasattr(node, "_forward_cls"):
            found.append(node)
        stack.extend(n for n, _ in node.next_functions)
    return found


def _tensors_in(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors_in(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors_in(y)]
    return []


@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_encoder_residuals_go_through_save_for_backward(structure):
    """Each encoder in train mode: no Function node of its graph holds a
    tensor as an attribute, some do save residuals (the kernels'
    Functions), and every tensor packed while the stack ran is unpacked by
    the backward of its output and final state: what a checkpointed region
    saves, it needs."""
    cfg = STRUCTURES[structure]()
    g = torch.Generator().manual_seed(0)
    for ecfg, D in ((cfg.audio_encoder, cfg.audio.output_dim),
                    (cfg.video_encoder, cfg.video.embedding_dim)):
        params = tenc.encoder_init(g, ecfg, D, "cpu")
        params = tree_map(lambda t: t.detach().requires_grad_(True), params)
        x = torch.randn((13, 3, D), generator=g, requires_grad=True)
        lengths = torch.tensor([13, 9, 0])
        packed, unpacked = {}, set()

        def pack(t):
            packed[len(packed)] = t
            return len(packed) - 1

        def unpack(i):
            unpacked.add(i)
            return packed[i]

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            out, final = tenc.encoder_apply(params, ecfg, x, lengths, torch.float32, train=True,
                                            generator=torch.Generator().manual_seed(1))
        nodes = _custom_nodes(out.grad_fn)
        assert nodes, "no kernel Function in the encoder's graph"
        for node in nodes:
            held = [k for k, v in vars(node).items() if _tensors_in(v)]
            assert not held, (node, held)
        loss = (out * torch.linspace(-1, 1, out.shape[-1])).sum()
        (loss + sum(t.sum() for t in _tensors_in(final))).backward()
        assert packed and set(packed) == unpacked, sorted(set(packed) - unpacked)


def test_trainer_with_remat_resumes_a_checkpoint_written_without_it(tmp_path):
    """``Trainer`` passes ``train.remat`` through as every option: a run
    with remat restored from a mid-epoch checkpoint of a run without it
    ends on the uninterrupted run's parameters and Adam state, bit for bit
    (encoder dropout and recurrent dropout on)."""
    import shutil

    from avsr_tpu_torch import configs as tconfigs
    from avsr_tpu_torch.avsr import AVSR
    from test_torch_trainer import params_equal, synth, tiny_cfg

    drop = {"audio_encoder.dropout_rate": 0.2, "audio_encoder.recurrent_dropout_rate": 0.2}
    data = synth()

    def run(name, remat):
        cfg = tiny_cfg(tconfigs, save_every_steps=1, keep_checkpoints=10,
                       eval_every_epochs=100).override({**drop, "train.remat": remat})
        return AVSR(config=cfg, run_dir=str(tmp_path / name), train_utterances=data,
                    eval_utterances=data, device="cpu")

    a = run("a", False)
    a.train()  # 4 batches an epoch -> 8 steps
    shutil.copytree(tmp_path / "a" / "checkpoints", tmp_path / "b" / "checkpoints")
    b = run("b", True)
    assert b.trainer.restore_checkpoint(step=6) == 6
    b.train()
    assert b.trainer._host_step == 8 and b.trainer.state.step == 8
    assert params_equal(a.trainer.state.params, b.trainer.state.params)
    for x, y in zip(a.trainer.state.opt_state["nu"], b.trainer.state.opt_state["nu"]):
        assert torch.equal(x, y)
