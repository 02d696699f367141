"""avsr_tpu_torch: the PyTorch / CUDA port of avsr_tpu.

The JAX package ``avsr_tpu`` is the reference; this package mirrors its
layout module by module (``ops/``, ``models/``, ``decode/``, ``serve.py``)
so each function's counterpart is found under the same path.  It imports
``torch`` and nothing of ``jax`` or ``avsr_tpu``: the framework-free parts
of the reference it needs are copies of their own (``configs.py``,
``data/``, ``eval/``, ``native/``).  Its entry points place tensors on the
card unless the caller asks for the CPU.

Covered so far: the serving path, the eval-time greedy decode and the
training step of the ``lrs2_av_fast`` preset — compact-transfer
dequantization, on-device noise mixing, the log-mel frontend, the BiLSTM
encoders with pyramidal time reduction and dropout, the lip-ROI CNN,
cross-attention fusion with the AU head, the transformer decoder
(teacher-forced, and its KV-cache step for width-W beam search and greedy
decode), the losses, the optimizer and the train step (``train/``) — and
the serving path and greedy decode of the reference-dims ``lrs2_av_align``
preset: the AV-Align fusion (a fusion LSTM with input feeding and a
Bahdanau read of the video memory per audio step) and the attention-LSTM
decoder, also with one-direction encoders and Luong reads
(``lrs2_av_align_uni_luong``) — and the reference's other regimes:
audio-only, video-only (lip-ROI CNN or AU features) and bimodal (two
decoder memories), fixed-SNR eval noise drawn as the JAX package draws it,
and the eval set's data path and scoring (``data/``, ``eval/``, the host
code of ``native/``) — and the experiment workflow above the steps: the
training loop with checkpoints, resume, warm-up, in-loop eval and the
noise matrix (``train/loop.py``, ``train/checkpoint.py``), the ``AVSR``
API (``avsr.py``), the CLI (``cli.py``), the corpus builder
(``data/ingest.py``) and metrics logging (``utils/logging.py``,
``utils/tensorboard.py``).  The compute cores run as hand-written CUDA
kernels on a GPU (``kernels/``, ``csrc/``) and as plain PyTorch on the
CPU: the direction-batched LSTM recurrence forward and backward (K1; at
one direction K2), the post-DFT
log-mel chain (K3), the fusion attention forward and backward (K4), the
teacher-forced decoder attention forward and backward (K5), the
single-query decode attention (K6), the fused beam step (K7), the AV-Align
fusion scan (K8) and the Bahdanau or Luong read (K10).

Layouts follow the reference: time-major [T, B, D] inside the recurrent
core and the fusion, batch-major at the API and for decoder memories.
"""

__version__ = "0.1.0"
