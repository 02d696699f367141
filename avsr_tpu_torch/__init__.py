"""avsr_tpu_torch: the PyTorch / CUDA port of avsr_tpu.

The JAX package ``avsr_tpu`` is the reference; this package mirrors its
layout module by module (``ops/``, ``models/``, ``decode/``, ``serve.py``)
so each function's counterpart is found under the same path.  It imports
``torch`` and never ``jax``.  The framework-free parts of the reference
(``avsr_tpu.configs``, ``avsr_tpu.data.units``) are imported as they are.

Covered so far: the serving path and the training step of the
``lrs2_av_fast`` preset — compact-transfer dequantization, on-device noise
mixing, the log-mel frontend, the BiLSTM encoders with pyramidal time
reduction and dropout, the lip-ROI CNN, cross-attention fusion with the AU
head, the transformer decoder (teacher-forced, and its KV-cache step for
width-W beam search), the losses, the optimizer and the train step
(``train/``).  The compute cores the JAX package hand-wrote or that carry
its hand-written gradients (the direction-batched LSTM recurrence forward
and backward, the post-DFT log-mel chain, the fusion attention forward and
backward) run as hand-written CUDA kernels on a GPU (``kernels/``,
``csrc/``) and as plain PyTorch on the CPU.

Layouts follow the reference: time-major [T, B, D] inside the recurrent
core and the fusion, batch-major at the API and for decoder memories.
"""

__version__ = "0.1.0"
