"""Parameter initializers on an explicit ``torch.Generator``.

Counterpart of ``avsr_tpu/utils/params.py``: the same distributions
(Glorot-uniform, block-orthogonal, scaled normal) so a model built here
has the reference's parameter statistics.  JAX's PRNG streams cannot be
reproduced, so equal VALUES come only through ``convert.from_jax``.

Parameters are plain nested dicts/lists of tensors whose keys follow the
JAX tree (``convert.py`` maps one onto the other).  Draws happen on the
generator's device (the CPU for a default generator) and the result is
moved to ``device``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

Params = Dict[str, Any]


def glorot_uniform(gen: torch.Generator, shape, device="cpu") -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (u * (2.0 * limit) - limit).to(device)


def orthogonal(gen: torch.Generator, shape, device="cpu", gain=1.0) -> torch.Tensor:
    """Orthogonal init (rows x cols); for [H, 4H] builds 4 orthogonal blocks."""
    rows, cols = shape
    if cols % rows == 0 and cols != rows:
        blocks = [_orthogonal_square(gen, rows) for _ in range(cols // rows)]
        return (gain * torch.cat(blocks, dim=1)).to(device)
    n = max(rows, cols)
    return (gain * _orthogonal_square(gen, n)[:rows, :cols]).to(device)


def _orthogonal_square(gen: torch.Generator, n: int) -> torch.Tensor:
    a = torch.randn((n, n), generator=gen, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


def normal_init(gen: torch.Generator, shape, device="cpu", stddev=0.02) -> torch.Tensor:
    return (stddev * torch.randn(shape, generator=gen, dtype=torch.float32)).to(device)


def zeros(shape, device="cpu") -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict/list/tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) for every leaf of a nested dict/list/tuple, in the
    tree's own order (dict insertion, then list index)."""
    out: List[Tuple[Tuple, Any]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out.append((path, t))

    walk(tree, ())
    return out


def param_count(params: Params) -> int:
    n = 0

    def count(x):
        nonlocal n
        n += x.numel()
        return x

    tree_map(count, params)
    return n
