"""avsr_tpu_torch: the PyTorch / CUDA port of avsr_tpu.

The JAX package ``avsr_tpu`` is the reference; this package mirrors its
layout module by module (``ops/``, ``models/``, ``decode/``, ``serve.py``)
so each function's counterpart is found under the same path.  It imports
``torch`` and never ``jax``.  The framework-free parts of the reference
(``avsr_tpu.configs``, ``avsr_tpu.data.units``) are imported as they are.

Covered so far: the serving path of the ``lrs2_av_fast`` preset —
compact-transfer dequantization, the log-mel frontend, the BiLSTM
encoders with pyramidal time reduction, the lip-ROI CNN, cross-attention
fusion, the transformer decoder's KV-cache step and width-W beam search.
The compute cores the JAX package hand-wrote (the direction-batched LSTM
recurrence and the post-DFT log-mel chain) run as hand-written CUDA
kernels on a GPU (``kernels/``, ``csrc/``) and as plain PyTorch on the CPU.

Layouts follow the reference: time-major [T, B, D] inside the recurrent
core and the fusion, batch-major at the API and for decoder memories.
"""

__version__ = "0.1.0"
