"""Optimizer and LR schedules (counterpart of ``avsr_tpu/train/optim.py``).

The reference builds an optax chain: ``clip_by_global_norm`` (when
``max_gradient_norm > 0``), then Adam / AdamW / SGD with momentum 0.9,
scaled by a schedule.  This module writes the same update out in torch,
equal to optax's arithmetic:

* clipping scales the gradients by ``max_norm / g_norm`` only when
  ``g_norm >= max_norm`` (``t / g_norm * max_norm``; not torch's
  ``clip_grad_norm_``, whose ``max_norm / (norm + 1e-6)`` differs);
* Adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
  correction by ``1 - b^count`` at the incremented count, update
  ``mu_hat / (sqrt(nu_hat) + eps)``; AdamW adds ``weight_decay * param``;
  SGD keeps the trace ``g + 0.9 trace``;
* the step is ``param - lr(count) * update`` with the schedule read at
  the count BEFORE the update, so the first warmup-cosine step has lr 0.

The update runs in place on the parameter tensors and on the moment
buffers (under ``no_grad``): the train state's parameters are the tensors
autograd tracks, and a second copy of an 11M-parameter tree per step would
only cost memory.
``lamb`` is not ported and raises.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from avsr_tpu.configs import TrainConfig

Schedule = Callable[[int], float]


def build_schedule(cfg: TrainConfig, steps_per_epoch: int = 1000) -> Schedule:
    """Learning rate as a function of the optimizer's update count (the
    optax schedules of the reference, written out in ``math``)."""
    base = cfg.learning_rate
    kind = cfg.lr_schedule
    if kind == "constant" or (kind == "exponential" and cfg.lr_decay == 0.0):
        return lambda count: float(base)
    if kind == "exponential":
        return lambda count: float(base * (1.0 - cfg.lr_decay) ** (max(count, 0) // steps_per_epoch))
    if kind == "cosine":
        total = max(cfg.num_epochs * steps_per_epoch, 1)
        return lambda count: float(
            base * 0.5 * (1.0 + math.cos(math.pi * min(max(count, 0) / total, 1.0))))
    if kind == "warmup_cosine":
        warm = max(cfg.warmup_steps, 1)
        total = max(cfg.num_epochs * steps_per_epoch, cfg.warmup_steps + 1)

        def warmup_cosine(count: int) -> float:
            s = max(count, 0)
            if s < warm:
                return float(base * s / warm)
            frac = min((s - warm) / max(total - warm, 1), 1.0)
            return float(base * 0.5 * (1.0 + math.cos(math.pi * frac)))

        return warmup_cosine
    raise ValueError(f"unknown lr schedule {kind}")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """Clip-by-global-norm then Adam / AdamW / SGD(0.9), as optax chains them.

    ``init(params)`` returns the state for a list of parameter tensors;
    ``update(params, grads, state)`` applies one step in place and returns
    the new state.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam defaults
    MOMENTUM = 0.9

    def __init__(self, kind: str, schedule: Schedule, max_gradient_norm: float,
                 weight_decay: float = 0.0):
        if kind not in ("adam", "adamw", "sgd"):
            if kind == "lamb":
                raise ValueError("the lamb optimizer is not ported")
            raise ValueError(f"unknown optimizer {kind}")
        self.kind = kind
        self.schedule = schedule
        self.max_gradient_norm = max_gradient_norm
        self.weight_decay = weight_decay

    def init(self, params: List[torch.Tensor]) -> Dict:
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]  # noqa: E731
        if self.kind == "sgd":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """``g / g_norm * max_norm`` when ``g_norm >= max_norm``, else ``g``
        (``/ 1 * 1``, exact), decided on the device: no host sync."""
        if self.max_gradient_norm <= 0:
            return grads
        g_norm = global_norm(grads)
        clipped = g_norm >= self.max_gradient_norm
        one = torch.ones_like(g_norm)
        out = torch._foreach_div(grads, torch.where(clipped, g_norm, one))
        torch._foreach_mul_(out, torch.where(clipped, one * self.max_gradient_norm, one))
        return out

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict) -> Dict:
        """One step, in place on ``params`` and on the state's moment lists
        (``torch._foreach_*``: a few launches for the whole tree, not a
        few per leaf)."""
        grads = self.clip(grads)
        count = state["count"]
        lr = self.schedule(count)
        new = dict(state, count=count + 1)
        if self.kind == "sgd":
            torch._foreach_mul_(new["trace"], self.MOMENTUM)
            torch._foreach_add_(new["trace"], grads)
            updates = new["trace"]
        else:
            b1, b2 = self.B1, self.B2
            torch._foreach_mul_(new["mu"], b1)
            torch._foreach_add_(new["mu"], grads, alpha=1 - b1)
            torch._foreach_mul_(new["nu"], b2)
            torch._foreach_addcmul_(new["nu"], grads, grads, value=1 - b2)
            denom = torch._foreach_div(new["nu"], 1.0 - b2 ** (count + 1))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.EPS)
            updates = torch._foreach_div(new["mu"], 1.0 - b1 ** (count + 1))
            torch._foreach_div_(updates, denom)
            if self.kind == "adamw":
                torch._foreach_add_(updates, params, alpha=self.weight_decay)
        torch._foreach_add_(params, updates, alpha=-lr)
        return new


def build_optimizer(cfg: TrainConfig, steps_per_epoch: int = 1000
                    ) -> Tuple[Optimizer, Schedule]:
    sched = build_schedule(cfg, steps_per_epoch)
    return Optimizer(cfg.optimizer, sched, cfg.max_gradient_norm, cfg.weight_decay), sched
