"""The port's data path: unit dictionaries (``units``), the synthetic corpus,
the TFRecord / SequenceExample codec and sources, and the bucketing loader
(copies of ``avsr_tpu/data``; ``loader.to_model_batch`` makes the port's
``Batch`` on the card)."""
