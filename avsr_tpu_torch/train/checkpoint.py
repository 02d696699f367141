"""Checkpoint / resume (counterpart of ``avsr_tpu/train/checkpoint.py``,
without orbax).

One directory per step under the manager's directory::

    <step>/params.npz     every parameter, keyed by its path in the JAX
                          tree (``convert.path_key``), in the order of
                          ``jax.tree_util.tree_flatten``, in the JAX layout
                          (``convert.leaf_to_jax``)
    <step>/opt_state.npz  the optimizer's moments in the same keys and
                          layout under ``mu/``, ``nu/`` (Adam, AdamW) or
                          ``trace/`` (SGD), and its update ``count``
    <step>/meta.json      {"step": the state's step}
    extra_<step>.json     side metadata beside the step directory (epoch,
                          data-iterator position), as the reference writes it

numpy reads every file without torch, and the parameters unflatten into
the JAX model's tree.  A step is written into a temporary directory and
renamed into place (``os.replace``), so a write cut off midway leaves the
previous checkpoints as they were; a temporary directory left behind is
removed by the next manager over the directory.

The reference's semantics are kept: keep-N pruning after each save that
spares the ``set_preserved`` steps (orbax's ``max_to_keep`` with
``should_keep_fn``); a same-step collision within one run (a per-K-steps
save meeting the epoch-end save) refreshes only the side metadata, while a
step left on disk by a previous run is overwritten, loudly; ``average``
takes the float64 mean of the parameters with the optimizer state and
step of the newest averaged checkpoint.

``restore`` copies into the template state's own tensors under
``no_grad``: the autograd-tracked parameters and the optimizer's moment
buffers keep their identity (and device).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from avsr_tpu_torch import convert
from avsr_tpu_torch.train.step import TrainState
from avsr_tpu_torch.utils.params import tree_leaves

PARAMS_FILE = "params.npz"
OPT_FILE = "opt_state.npz"
META_FILE = "meta.json"
_TMP = ".tmp-"

_log = logging.getLogger("avsr_tpu_torch")


def _moment_names(opt_state: Dict) -> List[str]:
    return [k for k in ("mu", "nu", "trace") if k in opt_state]


def _paths(params) -> List[Tuple]:
    return [p for p, _ in tree_leaves(params)]


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """{path key: JAX-layout array} in ``tree_flatten`` order."""
    return {convert.path_key(p): x for p, x in
            convert.jax_order_leaves(convert.to_jax_numpy(params))}


def _moments_to_numpy(params, name: str, moments: List[torch.Tensor]) -> Dict[str, np.ndarray]:
    by_path = {p: m for p, m in zip(_paths(params), moments)}
    order = [p for p, _ in convert.jax_order_leaves(params)]
    return {f"{name}/{convert.path_key(p)}":
            np.ascontiguousarray(convert.leaf_to_jax(p, by_path[p].detach().cpu().numpy()))
            for p in order}


def _write_json(path: str, obj) -> None:
    tmp = os.path.join(os.path.dirname(path), f"{_TMP}{os.path.basename(path)}-{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _copy_into(dst: torch.Tensor, arr: np.ndarray, key: str) -> None:
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, state {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        # Steps in this set survive keep-N pruning (the Trainer pins the
        # best-eval-CER step so `evaluate(checkpoint="best")` keeps working
        # after the step ages out of the retention window).
        self._preserved: set = set()
        # Steps written by THIS manager instance: a same-step collision
        # within one run has an identical payload and skips the write; a
        # collision with a previous run's step does not.
        self._saved_steps: set = set()
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.startswith(_TMP):  # an interrupted write
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    os.remove(path)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: TrainState, extra: Optional[Dict[str, Any]] = None) -> None:
        step = int(step)
        if step not in self._saved_steps:
            if step in self.all_steps():
                _log.warning("checkpoint step %d already exists in %s from a previous run; "
                             "overwriting with this run's state", step, self.directory)
            self._write(step, state)
            self._saved_steps.add(step)
            self._prune()
        # else: the same optimizer step already saved by THIS run; refresh
        # the side metadata only (the epoch-end extra carries the advanced
        # epoch / reset iterator position)
        if extra:
            _write_json(os.path.join(self.directory, f"extra_{step}.json"), extra)

    def _write(self, step: int, state: TrainState) -> None:
        tmp = os.path.join(self.directory, f"{_TMP}{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, PARAMS_FILE), **params_to_numpy(state.params))
        opt = state.opt_state
        moments: Dict[str, np.ndarray] = {}
        for name in _moment_names(opt):
            moments.update(_moments_to_numpy(state.params, name, opt[name]))
        moments["count"] = np.asarray(int(opt["count"]), np.int64)
        np.savez(os.path.join(tmp, OPT_FILE), **moments)
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump({"step": int(state.step)}, f)
        final = self._step_dir(step)
        if os.path.exists(final):
            # a previous run's step: move it aside, put the new one in place
            old = os.path.join(self.directory, f"{_TMP}old-{step}-{os.getpid()}")
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)

    def _prune(self) -> None:
        """Keep the newest ``keep`` steps and every preserved one."""
        steps = self.all_steps()
        for s in steps[:-max(self.keep, 1)]:
            if s not in self._preserved:
                shutil.rmtree(self._step_dir(s))

    def set_preserved(self, steps) -> None:
        """Pin steps against keep-N pruning (evaluated at save time)."""
        self._preserved.clear()
        self._preserved.update(int(s) for s in steps)

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(self.directory, n,
                                                                     META_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _check_step(self, step: Optional[int]) -> int:
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        if step not in self.all_steps():
            raise FileNotFoundError(f"no checkpoint for step {step} under {self.directory}")
        return step

    def read_params(self, step: int) -> Dict[str, np.ndarray]:
        """A step's parameters as saved: {path key: JAX-layout array}."""
        with np.load(os.path.join(self._step_dir(step), PARAMS_FILE)) as z:
            return {k: z[k] for k in z.files}

    @torch.no_grad()
    def _load_params(self, params, arrays: Dict[str, np.ndarray]) -> None:
        want = {convert.path_key(p) for p in _paths(params)}
        if set(arrays) != want:
            raise ValueError(f"checkpoint parameters differ from the state's: missing "
                             f"{sorted(want - set(arrays))}, extra {sorted(set(arrays) - want)}")
        for p, t in tree_leaves(params):
            key = convert.path_key(p)
            _copy_into(t, convert.leaf_from_jax(p, arrays[key]), key)

    def restore(self, state_template: TrainState, step: Optional[int] = None
                ) -> Tuple[TrainState, Dict[str, Any], int]:
        """Restore into the template's tensors.  Returns (state, extra, step).

        ``extra`` is the side metadata written by ``save(extra=...)``, {} if
        the checkpoint was saved without it."""
        step = self._check_step(step)
        d = self._step_dir(step)
        self._load_params(state_template.params, self.read_params(step))
        opt = dict(state_template.opt_state)
        with np.load(os.path.join(d, OPT_FILE)) as z, torch.no_grad():
            for name in _moment_names(opt):
                for p, m in zip(_paths(state_template.params), opt[name]):
                    key = f"{name}/{convert.path_key(p)}"
                    _copy_into(m, convert.leaf_from_jax(p, z[key]), key)
            opt["count"] = int(z["count"])
        with open(os.path.join(d, META_FILE)) as f:
            saved_step = int(json.load(f)["step"])
        extra: Dict[str, Any] = {}
        side = os.path.join(self.directory, f"extra_{step}.json")
        if os.path.exists(side):
            with open(side) as f:
                extra = json.load(f)
        return TrainState(state_template.params, opt, saved_step), extra, step

    def average(self, state_template: TrainState, steps: Optional[list] = None,
                last_n: int = 5) -> Tuple[TrainState, list]:
        """Uniform parameter averaging over saved checkpoints: the float64
        mean of each float parameter, cast back to its dtype; non-float
        leaves, the optimizer state and the step come from the NEWEST
        averaged checkpoint.  Returns (averaged state, steps used); the
        template's tensors hold the result."""
        avail = self.all_steps()
        if steps is None:
            steps = avail[-max(last_n, 1):]
        steps = sorted(int(s) for s in steps)
        missing = [s for s in steps if s not in avail]
        if missing or not steps:
            raise ValueError(f"cannot average: steps {missing or '(none)'} not in {avail} "
                             f"under {self.directory}")
        acc: Optional[Dict[str, np.ndarray]] = None
        newest: Dict[str, np.ndarray] = {}
        for s in steps:
            newest = self.read_params(s)
            leaves = {k: (x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x)
                      for k, x in newest.items()}
            acc = leaves if acc is None else {
                k: (a + leaves[k] if np.issubdtype(a.dtype, np.floating) else leaves[k])
                for k, a in acc.items()}
        n = float(len(steps))
        mean = {k: ((a / n).astype(newest[k].dtype) if np.issubdtype(a.dtype, np.floating)
                    else newest[k]) for k, a in acc.items()}
        state, _, _ = self.restore(state_template, step=steps[-1])
        self._load_params(state.params, mean)
        return state, steps
