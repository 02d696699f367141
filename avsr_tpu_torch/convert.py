"""Weight bridge between the JAX parameter tree and the port's parameters.

The port keeps the JAX tree's structure and key names (nested dicts and
lists), so one path names the same weight in both packages.  Only layouts
that PyTorch's operators want differently are converted:

* video CNN conv kernels: JAX ``HWIO`` <-> torch ``OIHW``
  (``video_frontend/convs/i/w``, ``avsr_tpu/models/video_cnn.py:41-44``);
* everything else keeps its JAX layout: LSTM ``wx [D, 4H]``,
  ``wh [H, 4H]`` and one ``b [4H]`` in gate order i, f, g, o
  (``avsr_tpu/ops/rnn.py:36-54``), dense weights ``[in, out]`` used as
  ``x @ w``, embeddings ``[V, E]``.

Both directions copy values bit-exactly; the round trip is pinned by
``tests/test_torch_convert.py``.  The input of ``from_jax`` is a tree of
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``, or the
leaves of a serving artifact's ``params.npz`` unflattened).
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from avsr_tpu_torch.utils.params import Params


def _is_conv_kernel(path: Tuple) -> bool:
    return len(path) >= 3 and path[-3] == "convs" and path[-1] == "w"


def _walk(tree: Any, path: Tuple, leaf_fn):
    if isinstance(tree, dict):
        return {k: _walk(v, path + (k,), leaf_fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, path + (i,), leaf_fn) for i, v in enumerate(tree)]
    return leaf_fn(path, tree)


def from_jax(tree: Any, *, device="cpu") -> Params:
    """JAX parameter tree (numpy leaves) -> port parameters on ``device``."""

    def leaf(path, x):
        x = np.asarray(x)
        if _is_conv_kernel(path):
            x = np.transpose(x, (3, 2, 0, 1))  # HWIO -> OIHW
        return torch.from_numpy(np.array(x, order="C")).to(device)  # owned copy

    return _walk(tree, (), leaf)


def to_jax_numpy(params: Params) -> Any:
    """Port parameters -> JAX-layout tree of numpy arrays (host copies)."""

    def leaf(path, x):
        x = x.detach().cpu()
        if _is_conv_kernel(path):
            x = x.permute(2, 3, 1, 0)  # OIHW -> HWIO
        return np.ascontiguousarray(x.numpy())

    return _walk(params, (), leaf)
