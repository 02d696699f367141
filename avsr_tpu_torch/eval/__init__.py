"""Eval scoring (copies of ``avsr_tpu/eval``): ``metrics`` (edit distance,
CER / WER) and ``analysis`` (alignments, confusions, error reports)."""
