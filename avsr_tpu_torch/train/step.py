"""Train and eval steps (counterpart of ``avsr_tpu/train/step.py``).

One step: the loss (noise mixing, frontends, encoders, fusion,
teacher-forced decoder, CE + AU loss) on the batch, its gradient by
autograd through the kernels' ``torch.autograd.Function``s, then the
optimizer update of ``train/optim.py`` in place on the parameters.  With
``accum > 1`` the batch is split into that many micro-batches, and their
gradients are weighted by their valid-label-token counts, so the
accumulated CE gradient equals the full-batch gradient (the reference's
``step.py:104-163``).

Randomness: the reference folds the step into its key
(``jax.random.fold_in(rng, state.step)``).  Here step ``s`` draws from a
generator on the batch's device seeded with
``rng.fold_in(generator.initial_seed(), s)``, and micro-batch ``a`` of it
from one seeded with ``rng.fold_in(that seed, a)``: a step's noise and
dropout depend only on (seed, step, micro-batch), never on what ran before.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from avsr_tpu.configs import ExperimentConfig
from avsr_tpu_torch.models import seq2seq
from avsr_tpu_torch.models.seq2seq import Batch
from avsr_tpu_torch.train.optim import Optimizer, build_optimizer, global_norm
from avsr_tpu_torch.utils import rng
from avsr_tpu_torch.utils.params import Params, tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Params   # leaves are tensors with requires_grad, updated in place
    opt_state: Any
    step: int


def create_train_state(cfg: ExperimentConfig, vocab_size: int, generator: torch.Generator,
                       device, steps_per_epoch: int = 1000) -> Tuple[TrainState, Optimizer]:
    """Random parameters from ``generator`` on ``device``, the optimizer and
    its zero state: (state, optimizer)."""
    params = seq2seq.model_init(cfg, vocab_size, generator, device)
    optimizer, _ = build_optimizer(cfg.train, steps_per_epoch)
    return train_state_from_params(params, optimizer), optimizer


def train_state_from_params(params: Params, optimizer: Optimizer) -> TrainState:
    """A step-0 state around existing parameters (e.g. ``convert.from_jax``)."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    return TrainState(params, optimizer.init(param_leaves(params)), 0)


def param_leaves(params: Params) -> List[torch.Tensor]:
    return [p for _, p in tree_leaves(params)]


def loss_and_grads(params: Params, batch: Batch, *, cfg: ExperimentConfig,
                   generator: Optional[torch.Generator], noise_bank=None
                   ) -> Tuple[Dict[str, torch.Tensor], List[Optional[torch.Tensor]]]:
    """Train-mode metrics and the gradient of the loss for every leaf of
    ``params`` (``tree_leaves`` order); a leaf the loss does not reach
    gets None."""
    leaves = param_leaves(params)
    loss, metrics = seq2seq.loss_fn(params, cfg, batch, train=True, generator=generator,
                                    noise_bank=noise_bank)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {k: v.detach() for k, v in metrics.items()}, list(grads)


def _micro(batch: Batch, a: int, b: int) -> Batch:
    return Batch(*[None if x is None else x[a * b:(a + 1) * b] for x in batch])


def train_step(state: TrainState, batch: Batch, *, cfg: ExperimentConfig,
               optimizer: Optimizer, generator: torch.Generator, noise_bank=None,
               accum: int = 1) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step: (new state, metrics).  Metrics are ``loss``,
    ``ce_loss``, ``au_loss`` (when the AU loss is on) and ``grad_norm``,
    the global norm of the gradient before clipping.  The parameters are
    updated in place; the returned state holds the same tensors."""
    dev = batch.audio.device
    step_seed = rng.fold_in(generator.initial_seed(), state.step)
    leaves = param_leaves(state.params)
    if accum <= 1:
        metrics, grads = loss_and_grads(state.params, batch, cfg=cfg,
                                        generator=rng.generator_for(step_seed, dev),
                                        noise_bank=noise_bank)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    else:
        B, K = batch.targets.shape
        if B % accum:
            raise ValueError(f"batch rows {B} not divisible by accum {accum}")
        b = B // accum
        grads = [torch.zeros_like(p) for p in leaves]
        msum: Dict[str, torch.Tensor] = {}
        wsum = torch.zeros((), device=dev)
        for a in range(accum):
            mb = _micro(batch, a, b)
            m, g = loss_and_grads(state.params, mb, cfg=cfg,
                                  generator=rng.generator_for(rng.fold_in(step_seed, a), dev),
                                  noise_bank=noise_bank)
            # the micro-batch's valid label tokens (sequence_loss's mask);
            # an all-padding micro-batch weighs 0
            w = torch.clamp(mb.target_lengths, max=K).sum().float()
            for acc, gi in zip(grads, g):
                if gi is not None:
                    acc.add_(w * gi)
            for k, v in m.items():
                msum[k] = msum.get(k, 0.0) + w * v
            wsum = wsum + w
        wsafe = torch.clamp(wsum, min=1.0)
        grads = [g / wsafe for g in grads]
        metrics = {k: v / wsafe for k, v in msum.items()}
    metrics["grad_norm"] = global_norm(grads)
    opt_state = optimizer.update(leaves, grads, state.opt_state)
    return TrainState(state.params, opt_state, state.step + 1), metrics


def eval_step(params: Params, batch: Batch, *, cfg: ExperimentConfig,
              noise_bank=None) -> Dict[str, torch.Tensor]:
    """Eval-mode metrics (no dropout, no label smoothing, no noise draws)."""
    with torch.no_grad():
        _, metrics = seq2seq.loss_fn(params, cfg, batch, train=False, noise_bank=noise_bank)
    return dict(metrics)
