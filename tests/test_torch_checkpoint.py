"""The port's checkpoints (``avsr_tpu_torch/train/checkpoint.py``) against
the JAX package's model and ``CheckpointManager``.

* A port checkpoint's ``params.npz`` holds the JAX tree's leaves in
  ``tree_flatten`` order under their paths, in the JAX layout:
  unflattened into the JAX model's tree it gives the JAX loss within
  ``tests/test_torch_train.py``'s rtol 1e-5 of the port's loss (both
  architectures; ``av_align`` has the video CNN's conv kernels, the one
  layout that differs).
* ``restore`` copies into the state's own tensors, bit for bit.
* ``average`` equals numpy's float64 mean of the same files.
* keep-N pruning and preserved steps leave the same steps as the JAX
  package's orbax manager after the same saves.
* A write cut off between the temporary directory and the rename leaves
  the previous checkpoints readable.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu import configs as jconfigs
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu.train.checkpoint import CheckpointManager as JManager
from avsr_tpu.train.step import TrainState as JState
from avsr_tpu_torch import configs as tconfigs
from avsr_tpu_torch import convert
from avsr_tpu_torch.data.loader import BucketingLoader
from avsr_tpu_torch.data.units import builtin_unit_dict
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.train import checkpoint as tckpt
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.train.checkpoint import CheckpointManager
from avsr_tpu_torch.utils.params import tree_leaves
from test_torch_trainer import synth, tiny_cfg


def _state(arch="audio", seed=0):
    cfg = tiny_cfg(tconfigs, arch)
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    state, opt = tstep.create_train_state(cfg, V, torch.Generator().manual_seed(seed), "cpu")
    return cfg, V, state, opt


def _batch_arrays(cfg):
    units = builtin_unit_dict(cfg.data.unit)
    au = (cfg.audio.frame_stacking, cfg.audio.frame_skipping) \
        if cfg.architecture == "av_align" else None
    loader = BucketingLoader(synth(), units, cfg.data, require_audio=True,
                             require_video=cfg.architecture == "av_align", au_target_stacking=au,
                             au_dim=cfg.fusion.au_dim)
    _, nb = next(iter(loader.epoch(shuffle=False)))
    return nb


@pytest.mark.parametrize("arch", ["audio", "av_align"])
def test_params_npz_loads_into_the_jax_model(tmp_path, arch):
    cfg, V, state, opt = _state(arch)
    nb = _batch_arrays(cfg)
    batch = tseq.batch_to_device(nb, "cpu")
    state, _ = tstep.train_step(state, batch, cfg=cfg, optimizer=opt,
                                generator=torch.Generator().manual_seed(1))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, state, {"epoch": 0})
    jcfg = tiny_cfg(jconfigs, arch)
    jparams0 = jseq.model_init(jax.random.PRNGKey(0), jcfg, V)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jparams0)
    with np.load(tmp_path / "ck" / "1" / "params.npz") as z:
        assert z.files == ["/".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in p)
                           for p, _ in flat]
        for (_, ref), name in zip(flat, z.files):
            assert z[name].shape == ref.shape and z[name].dtype == ref.dtype, name
        jparams = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(z[k]) for k in z.files])
    jbatch = jseq.Batch(**{k: jnp.asarray(nb[k]) for k in jseq.Batch._fields
                           if nb.get(k) is not None and k != "uid_hashes"})
    loss_j, _ = jseq.loss_fn(jparams, jcfg, jbatch, train=False, rng=jax.random.PRNGKey(0))
    with torch.no_grad():
        loss_t, _ = tseq.loss_fn(state.params, cfg, batch, train=False)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)


def test_files_read_with_numpy_alone(tmp_path):
    cfg, V, state, opt = _state()
    state = state._replace(step=7, opt_state=dict(state.opt_state, count=7))
    CheckpointManager(str(tmp_path)).save(7, state, {"epoch": 2, "batches_done": 3})
    with np.load(tmp_path / "7" / "params.npz") as z:
        keys = z.files
    with np.load(tmp_path / "7" / "opt_state.npz") as z:
        assert z.files == ["mu/" + k for k in keys] + ["nu/" + k for k in keys] + ["count"]
        assert int(z["count"]) == 7
    assert json.loads((tmp_path / "7" / "meta.json").read_text()) == {"step": 7}
    assert json.loads((tmp_path / "extra_7.json").read_text()) == {"epoch": 2,
                                                                    "batches_done": 3}


@pytest.mark.parametrize("arch", ["audio", "av_align"])
def test_restore_copies_into_the_states_tensors(tmp_path, arch):
    cfg, V, state, opt = _state(arch)
    batch = tseq.batch_to_device(_batch_arrays(cfg), "cpu")
    for _ in range(2):
        state, _ = tstep.train_step(state, batch, cfg=cfg, optimizer=opt,
                                    generator=torch.Generator().manual_seed(1))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state, {"epoch": 1})
    _, _, other, _ = _state(arch, seed=5)
    tensors = [t for _, t in tree_leaves(other.params)]
    moments = list(other.opt_state["mu"])
    restored, extra, step = mgr.restore(other)
    assert step == 2 and extra == {"epoch": 1} and restored.step == 2
    assert restored.opt_state["count"] == 2
    for t, (_, r), (_, s) in zip(tensors, tree_leaves(restored.params),
                                 tree_leaves(state.params)):
        assert r is t and r.requires_grad and torch.equal(r, s)
    for name in ("mu", "nu"):
        for r, s in zip(restored.opt_state[name], state.opt_state[name]):
            assert torch.equal(r, s)
    assert all(r is m for r, m in zip(restored.opt_state["mu"], moments))


def test_average_equals_numpy_float64_mean(tmp_path):
    cfg, V, state, opt = _state()
    mgr = CheckpointManager(str(tmp_path), keep=10)
    gen = torch.Generator().manual_seed(3)
    for s in (1, 2, 3):
        with torch.no_grad():
            for _, t in tree_leaves(state.params):
                t.add_(torch.randn(t.shape, generator=gen))
            for m in state.opt_state["mu"]:
                m.add_(float(s))
        mgr.save(s, state._replace(step=s, opt_state=dict(state.opt_state, count=s)))
    files = [dict(np.load(tmp_path / str(s) / "params.npz")) for s in (1, 2, 3)]
    _, _, fresh, _ = _state(seed=9)
    avg, used = mgr.average(fresh, last_n=2)
    assert used == [2, 3] and avg.step == 3 and avg.opt_state["count"] == 3
    got = tckpt.params_to_numpy(avg.params)
    for k in files[0]:
        want = np.mean(np.stack([f[k].astype(np.float64) for f in files[1:]]), axis=0)
        np.testing.assert_array_equal(got[k], want.astype(np.float32), err_msg=k)
    for m in avg.opt_state["mu"]:  # the newest step's moments
        assert torch.all(m == m.flatten()[0]) and float(m.flatten()[0]) == 6.0
    avg3, used3 = mgr.average(fresh, steps=[3, 1, 2])
    assert used3 == [1, 2, 3]
    got3 = tckpt.params_to_numpy(avg3.params)
    k = next(iter(files[0]))
    np.testing.assert_array_equal(
        got3[k], (np.mean(np.stack([f[k].astype(np.float64) for f in files]), axis=0)
                  ).astype(np.float32))
    with pytest.raises(ValueError, match="cannot average"):
        mgr.average(fresh, steps=[4])


SCENARIOS = {
    # (keep, [(action, arg), ...]): save a step, pin steps, or open a new
    # manager over the directory (a new run)
    "keep2": (2, [("save", s) for s in (1, 2, 3, 4)]),
    "keep1-pinned": (1, [("save", 1), ("save", 2), ("pin", {2}), ("save", 3), ("save", 4)]),
    "keep2-pin-old": (2, [("save", 1), ("pin", {1}), ("save", 2), ("save", 3), ("save", 4),
                          ("pin", set()), ("save", 5)]),
    "new-run-collides": (3, [("save", 1), ("save", 2), ("new", None), ("save", 2),
                             ("save", 3), ("save", 4)]),
    "same-step-twice": (2, [("save", 2), ("save", 2), ("save", 4), ("save", 4), ("save", 6)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_keep_n_and_preserved_steps_match_the_reference(tmp_path, name):
    keep, actions = SCENARIOS[name]
    _, _, state, _ = _state()

    def jstate(step):
        return JState(params={"w": np.full((3,), step, np.float32)},
                      opt_state={"m": np.zeros((3,), np.float32)},
                      step=jnp.asarray(step, jnp.int32))

    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jm, tm = JManager(jd, keep=keep), CheckpointManager(td, keep=keep)
    for action, arg in actions:
        if action == "save":
            jm.save(arg, jstate(arg), {"epoch": arg})
            tm.save(arg, state._replace(step=arg), {"epoch": arg})
        elif action == "pin":
            jm.set_preserved(arg)
            tm.set_preserved(arg)
        else:
            jm.close()
            jm, tm = JManager(jd, keep=keep), CheckpointManager(td, keep=keep)
        assert tm.all_steps() == jm.all_steps(), (action, arg)
        assert tm.latest_step() == jm.latest_step()
    assert (sorted(f for f in os.listdir(td) if f.startswith("extra_"))
            == sorted(f for f in os.listdir(jd) if f.startswith("extra_")))
    jm.close()


def test_previous_run_collision_overwrites(tmp_path):
    cfg, V, state, opt = _state()
    d = str(tmp_path / "ck")
    CheckpointManager(d).save(1, state._replace(step=1), {"epoch": 0, "batches_done": 1})
    with torch.no_grad():
        for _, t in tree_leaves(state.params):
            t.fill_(2.0)
    run2 = CheckpointManager(d)
    run2.save(1, state._replace(step=1), {"epoch": 0, "batches_done": 1})
    _, _, other, _ = _state(seed=4)
    restored, extra, step = run2.restore(other)
    assert step == 1 and all(bool(torch.all(t == 2.0)) for _, t in tree_leaves(restored.params))
    # the same run's second save of a step refreshes only the side metadata
    with torch.no_grad():
        for _, t in tree_leaves(state.params):
            t.fill_(3.0)
    run2.save(1, state._replace(step=1), {"epoch": 1, "batches_done": 0})
    restored, extra, _ = run2.restore(other)
    assert extra == {"epoch": 1, "batches_done": 0}
    assert all(bool(torch.all(t == 2.0)) for _, t in tree_leaves(restored.params))
    assert sorted(os.listdir(d)) == ["1", "extra_1.json"]


def test_interrupted_write_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    cfg, V, state, opt = _state()
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d)
    mgr.save(1, state._replace(step=1))
    saved = {k: v.copy() for k, v in tckpt.params_to_numpy(state.params).items()}
    with torch.no_grad():
        for _, t in tree_leaves(state.params):
            t.mul_(0.5)
    real_replace = os.replace

    def cut(src, dst):
        if os.path.basename(dst) == "2":
            raise KeyboardInterrupt("cut off before the rename")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", cut)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(2, state._replace(step=2))
    monkeypatch.setattr(os, "replace", real_replace)
    assert any(n.startswith(".tmp-") for n in os.listdir(d))  # the cut-off write
    again = CheckpointManager(d)
    assert again.all_steps() == [1] and again.latest_step() == 1
    assert not any(n.startswith(".tmp-") for n in os.listdir(d))
    _, _, other, _ = _state(seed=6)
    restored, _, step = again.restore(other)
    assert step == 1
    got = tckpt.params_to_numpy(restored.params)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v)
    with pytest.raises(FileNotFoundError, match="no checkpoint for step 2"):
        again.restore(other, step=2)
