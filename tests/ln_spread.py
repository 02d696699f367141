"""Measures whether the full-width LN-LSTM model's sensitivity under the bf16
policy is the reference's own or the port's: how far one part in 1e6 on
every weight moves the train-mode loss and each gradient leaf, in the JAX
package and in the port's plain path (the CPU twins of its kernels), beside
the same model without LayerNorm.

    JAX_PLATFORMS=cpu python tests/ln_spread.py [--batch 2] [--seconds 3]

Both packages start from the same ``lrs2_av_align_ln`` parameters (the
``lrs2_av_align`` preset, ``configs.lrs2_full``, with LN-LSTM cells in both
encoders and recurrent dropout 0.2 in the video one: chip_smoke's
``ln_cfg``), full width, on one small synthetic batch (``--batch``
utterances of up to ``--seconds`` s, 20 labels), bf16 products with fp32
accumulation.  Each package is compared only with itself: its loss and
gradient leaves at the parameters against those at the parameters times (1
+ 1e-6), with the same random draws (JAX's key, the port's generator seed)
on both sides.  Prints, per package and model, the loss's relative change
and the median and worst relative norm change of the gradient leaves.  If
JAX's leaves stayed where the port's moved, the port's bf16 LN path would be
at fault.  About a minute and a few GiB on the CPU.
"""

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from avsr_tpu.configs import lrs2_full  # noqa: E402
from avsr_tpu.data.units import builtin_unit_dict  # noqa: E402
from avsr_tpu.models import seq2seq as jseq  # noqa: E402
from avsr_tpu_torch import configs as tconfigs, convert  # noqa: E402
from avsr_tpu_torch.models import seq2seq as tseq  # noqa: E402
from avsr_tpu_torch.train import step as tstep  # noqa: E402
from avsr_tpu_torch.utils.params import tree_map  # noqa: E402
from test_torch_train import _jbatch, batch_arrays  # noqa: E402

EPS = 1e-6
LN = {"audio_encoder.layer_norm": True, "video_encoder.layer_norm": True,
      "video_encoder.recurrent_dropout_rate": 0.2}


def changes(loss_a, loss_b, leaves_a, leaves_b):
    """(loss relative change, [each leaf's relative norm change])."""
    rels = [float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in zip(leaves_a, leaves_b)
            if np.linalg.norm(b) > 0]
    return abs(loss_a - loss_b) / abs(loss_b), rels


def jax_spread(cfg, params, arrays):
    batch = _jbatch(arrays)

    @jax.jit
    def loss_and_grads(p):
        def lf(p):
            loss, _ = jseq.loss_fn(p, cfg, batch, train=True, rng=jax.random.PRNGKey(0))
            return loss
        return jax.value_and_grad(lf)(p)

    out = []
    for p in (params, jax.tree_util.tree_map(lambda x: x * (1 + EPS), params)):
        loss, g = loss_and_grads(p)
        out.append((float(loss), [np.asarray(x, np.float32)
                                  for x in jax.tree_util.tree_leaves(g)]))
    return changes(out[1][0], out[0][0], out[1][1], out[0][1])


def port_spread(cfg, jparams, arrays):
    tcfg = tconfigs.ExperimentConfig.from_dict(cfg.to_dict())
    params = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    params = tree_map(lambda t: t.requires_grad_(True), params)
    batch = tseq.batch_to_device(arrays, "cpu")
    out = []
    for scale in (1.0, 1.0 + EPS):
        with torch.no_grad():
            p = tree_map(lambda t: (t * scale).requires_grad_(True), params)
        metrics, grads = tstep.loss_and_grads(p, batch, cfg=tcfg,
                                              generator=torch.Generator().manual_seed(0))
        out.append((float(metrics["loss"]), [g.numpy() for g in grads if g is not None]))
    return changes(out[1][0], out[0][0], out[1][1], out[0][1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    torch.set_num_threads(4)
    for ln in (True, False):
        cfg = lrs2_full().override(LN) if ln else lrs2_full()
        V = builtin_unit_dict(cfg.data.unit).vocab_size
        params = jseq.model_init(jax.random.PRNGKey(0), cfg, V)
        S = int(16000 * args.seconds)
        arrays = batch_arrays(0, V, B=args.batch, S=S, T_v=int(25 * args.seconds), K=20)
        # the AU targets a step of the audio encoder: 25 / 10 ms frames
        # stacked 8, skipped 3 (the preset's frontend)
        T_a = ((S - 400) // 160 + 1 - 8) // 3 + 1
        arrays["au_targets"] = np.random.default_rng(1).standard_normal(
            (args.batch, T_a, 2)).astype(np.float32)
        name = "lrs2_av_align_ln" if ln else "lrs2_av_align (no LN)"
        for pkg, fn in (("JAX", jax_spread), ("port plain path", port_spread)):
            t0 = time.perf_counter()
            loss_rel, rels = fn(cfg, params, arrays)
            print(f"{name}, {pkg}: parameters times (1 + {EPS}) move the loss by {loss_rel:.3e} "
                  f"(relative), the {len(rels)} gradient leaves by median "
                  f"{statistics.median(rels):.3e}, worst {max(rels):.3e} (relative norm; "
                  f"{time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
