"""Weight bridge between the JAX parameter tree and the port's parameters.

The port keeps the JAX tree's structure and key names (nested dicts and
lists), so one path names the same weight in both packages.  Only layouts
that PyTorch's operators want differently are converted:

* video CNN conv kernels: JAX ``HWIO`` <-> torch ``OIHW``
  (``video_frontend/convs/i/w``, ``avsr_tpu/models/video_cnn.py:41-44``);
* everything else keeps its JAX layout: LSTM ``wx [D, 4H]``,
  ``wh [H, 4H]`` and one ``b [4H]`` in gate order i, f, g, o
  (``avsr_tpu/ops/rnn.py:36-54``), dense weights ``[in, out]`` used as
  ``x @ w``, embeddings ``[V, E]``, and the transformer encoders'
  depthwise conv kernels ``conv_dw [k, 1, d]`` (WIO,
  ``avsr_tpu/models/transformer.py:134``): their path ends in ``conv_dw``,
  not ``convs/i/w``, so they pass through as they are, and the port's
  conformer conv reads that layout.

Both directions copy values bit-exactly; the round trip is pinned by
``tests/test_torch_convert.py``.  The input of ``from_jax`` is a tree of
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``, or the
leaves of a serving artifact's ``params.npz`` unflattened; ``from_jax_leaves``
takes those leaves as they are, in flatten order, against a template
tree).

``jax_order_leaves`` lists a tree's leaves as ``jax.tree_util.tree_flatten``
orders them (dict keys sorted, list items by index), each under its path
key (``path_key``: the keys joined by ``/``, e.g.
``decoder/atts/0/wq``): the key and order of the port's checkpoint files
(``train/checkpoint.py``).
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from avsr_tpu_torch.utils.params import Params


def _is_conv_kernel(path: Tuple) -> bool:
    return len(path) >= 3 and path[-3] == "convs" and path[-1] == "w"


def leaf_to_jax(path: Tuple, x: np.ndarray) -> np.ndarray:
    """One leaf's array from the port's layout into JAX's (by its path)."""
    return np.transpose(x, (2, 3, 1, 0)) if _is_conv_kernel(path) else x  # OIHW -> HWIO


def leaf_from_jax(path: Tuple, x: np.ndarray) -> np.ndarray:
    """One leaf's array from JAX's layout into the port's (by its path)."""
    return np.transpose(x, (3, 2, 0, 1)) if _is_conv_kernel(path) else x  # HWIO -> OIHW


def path_key(path: Tuple) -> str:
    return "/".join(str(k) for k in path)


def jax_order_leaves(tree: Any) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) for every leaf, in ``jax.tree_util.tree_flatten``'s
    order: dict keys sorted, list and tuple items by index."""
    out: List[Tuple[Tuple, Any]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out.append((path, t))

    walk(tree, ())
    return out


def _walk(tree: Any, path: Tuple, leaf_fn):
    if isinstance(tree, dict):
        return {k: _walk(v, path + (k,), leaf_fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, path + (i,), leaf_fn) for i, v in enumerate(tree)]
    return leaf_fn(path, tree)


def _placed(x: np.ndarray, device) -> torch.Tensor:
    """A contiguous copy of the port-layout array ``x`` in the allocator's
    own (aligned) memory on ``device``, as the model's own tensors are: a
    conv over other strides, or on the CPU a product over a numpy buffer's
    alignment, may round otherwise."""
    return torch.tensor(np.ascontiguousarray(x), device=device)


def from_jax(tree: Any, *, device="cuda") -> Params:
    """JAX parameter tree (numpy leaves) -> port parameters on ``device``."""
    return _walk(tree, (), lambda path, x: _placed(leaf_from_jax(path, np.asarray(x)), device))


def from_jax_leaves(template: Params, leaves: List[np.ndarray], *, device="cuda") -> Params:
    """JAX-layout leaves in ``tree_flatten`` order (a serving artifact's
    ``params.npz``) -> port parameters on ``device`` with ``template``'s
    structure (its tensors give only the shapes: a ``device="meta"`` tree
    will do).  A leaf whose shape or dtype is not its slot's raises."""
    order = jax_order_leaves(template)
    if len(order) != len(leaves):
        raise ValueError(f"{len(leaves)} parameter leaves; the model has {len(order)}")
    placed = {}
    for i, ((path, t), x) in enumerate(zip(order, leaves)):
        x = leaf_from_jax(path, np.asarray(x))
        want = str(t.dtype).replace("torch.", "")
        if tuple(x.shape) != tuple(t.shape) or x.dtype.name != want:
            raise ValueError(f"leaf {i} ({path_key(path)}): {x.dtype.name} {tuple(x.shape)}, "
                             f"the model wants {want} {tuple(t.shape)}")
        placed[path] = _placed(x, device)
    return _walk(template, (), lambda path, _: placed[path])


def to_jax_numpy(params: Params) -> Any:
    """Port parameters -> JAX-layout tree of numpy arrays (host copies)."""

    def leaf(path, x):
        return np.ascontiguousarray(leaf_to_jax(path, x.detach().cpu().numpy()))

    return _walk(params, (), leaf)
