"""Error-rate metrics: Levenshtein edit distance -> CER / WER.

The reference accumulates edit distance over the test set to report CER and
WER and writes per-epoch prediction files (upstream:avsr/avsr.py eval path,
SURVEY.md §2.2 row 12, §3.2).  This module supplies the same capability with
a fast C++ kernel (avsr_tpu_torch/native, built at first use) and a NumPy
fallback.  A copy of ``avsr_tpu/eval/metrics.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from avsr_tpu_torch import native


def levenshtein(ref: Sequence, hyp: Sequence) -> int:
    """Edit distance between two sequences (insert/delete/substitute, cost 1):
    the native kernel where its library builds, else the NumPy DP."""
    if native.available():
        # Map arbitrary hashable elements to dense int ids for the C++ kernel.
        table: dict = {}
        ref_ids = [table.setdefault(x, len(table)) for x in ref]
        hyp_ids = [table.setdefault(x, len(table)) for x in hyp]
        return native.levenshtein_ids(ref_ids, hyp_ids)
    return _levenshtein_np(ref, hyp)


def _levenshtein_np(ref: Sequence, hyp: Sequence) -> int:
    """Vectorized two-row DP. O(len(ref)) memory."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    ref_arr = np.asarray([hash(x) for x in ref], dtype=np.int64)
    hyp_arr = np.asarray([hash(x) for x in hyp], dtype=np.int64)
    prev = np.arange(n + 1, dtype=np.int32)
    cur = np.empty(n + 1, dtype=np.int32)
    for j in range(1, m + 1):
        cur[0] = j
        sub = prev[:-1] + (ref_arr != hyp_arr[j - 1])
        dele = prev[1:] + 1
        best = np.minimum(sub, dele)
        # insertion needs a sequential pass (prefix dependency)
        running = cur[0]
        for i in range(1, n + 1):
            running = min(best[i - 1], running + 1)
            cur[i] = running
        prev, cur = cur, prev
    return int(prev[n])


@dataclass
class ErrorRateAccumulator:
    """Accumulate edit distances over a test set to produce CER/WER.

    Matches the reference's workflow: per-utterance character and word
    distances summed over the epoch, divided by total reference length.
    """

    char_errors: int = 0
    char_total: int = 0
    word_errors: int = 0
    word_total: int = 0
    num_utterances: int = 0
    predictions: List[Tuple[str, str, str]] = field(default_factory=list)
    keep_predictions: bool = True

    def update(self, reference: str, hypothesis: str, uid: str = "") -> None:
        ref_c, hyp_c = list(reference), list(hypothesis)
        ref_w, hyp_w = reference.split(), hypothesis.split()
        self.char_errors += levenshtein(ref_c, hyp_c)
        self.char_total += len(ref_c)
        self.word_errors += levenshtein(ref_w, hyp_w)
        self.word_total += len(ref_w)
        self.num_utterances += 1
        if self.keep_predictions:
            self.predictions.append((uid, reference, hypothesis))

    @property
    def cer(self) -> float:
        return self.char_errors / max(self.char_total, 1)

    @property
    def wer(self) -> float:
        return self.word_errors / max(self.word_total, 1)

    def summary(self) -> Dict[str, float]:
        return {
            "cer": self.cer,
            "wer": self.wer,
            "num_utterances": self.num_utterances,
        }

    def write_predictions(self, path: str) -> None:
        """Human-readable predictions file, one utterance per block
        (parity with the reference's per-epoch prediction transcripts)."""
        with open(path, "w") as f:
            for uid, ref, hyp in self.predictions:
                f.write(f"id:  {uid}\nref: {ref}\nhyp: {hyp}\n\n")
            f.write(
                f"# CER {self.cer:.4f} WER {self.wer:.4f} "
                f"N {self.num_utterances}\n"
            )
