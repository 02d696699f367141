"""Error analysis over prediction files: confusions, distributions, worst cases.

The reference's eval workflow ends at per-epoch prediction transcripts and
CER/WER summary files (upstream:avsr/avsr.py eval path, SURVEY.md §3.2);
the error ANALYSIS step — which characters confuse, where the errors
concentrate, which utterances fail — is left to the user's ad-hoc scripts.
This module makes it a first-class surface: parse a predictions file (or
take (ref, hyp) pairs), compute Levenshtein ALIGNMENTS (not just
distances), and aggregate into a report.

Host-side, offline, NumPy-only: analysis runs on prediction files after an
eval, never on the device.  A copy of ``avsr_tpu/eval/analysis.py`` on the
port's own ``eval/metrics.py``.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from avsr_tpu_torch.eval.metrics import levenshtein

# Alignment op codes.
MATCH, SUB, INS, DEL = "match", "sub", "ins", "del"


def parse_predictions(path: str) -> List[Tuple[str, str, str]]:
    """Parse an ``ErrorRateAccumulator.write_predictions`` file back into
    (uid, reference, hypothesis) triples."""
    triples: List[Tuple[str, str, str]] = []
    uid = ref = None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("#") or not line.strip() and uid is None:
                continue
            # Exact writer prefixes ("id:  " two spaces, "ref: "/"hyp: "
            # one): a greedy ' {0,2}' would eat leading spaces that are
            # PART of the text (space is in the character inventory), and
            # the file-derived CER would disagree with the eval-time
            # accumulator's.
            if line.startswith("id:  "):
                uid = line[5:]
            elif line.startswith("ref: "):
                ref = line[5:]
            elif line.startswith("hyp: "):
                if uid is None or ref is None:
                    raise ValueError(f"malformed predictions file {path!r}")
                triples.append((uid, ref, line[5:]))
                uid = ref = None
    return triples


def align(ref: Sequence, hyp: Sequence) -> List[Tuple[str, object, object]]:
    """Levenshtein alignment with backtrace.

    Returns ops as (kind, ref_elem|None, hyp_elem|None), kind in
    {match, sub, ins, del}; the number of non-match ops equals
    ``metrics.levenshtein(ref, hyp)`` (unit costs).  O(len(ref)*len(hyp))
    — fine for transcripts; use ``metrics.levenshtein`` (C++ kernel) when
    only the distance is needed.
    """
    n, m = len(ref), len(hyp)
    # DP table; ties resolved sub > del > ins for a deterministic trace.
    d = np.zeros((n + 1, m + 1), np.int32)
    d[:, 0] = np.arange(n + 1)
    d[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        ri = ref[i - 1]
        for j in range(1, m + 1):
            d[i, j] = min(
                d[i - 1, j - 1] + (ri != hyp[j - 1]),
                d[i - 1, j] + 1,
                d[i, j - 1] + 1,
            )
    ops: List[Tuple[str, object, object]] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + (
            ref[i - 1] != hyp[j - 1]
        ):
            ops.append(
                (MATCH if ref[i - 1] == hyp[j - 1] else SUB,
                 ref[i - 1], hyp[j - 1])
            )
            i, j = i - 1, j - 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            ops.append((DEL, ref[i - 1], None))
            i -= 1
        else:
            ops.append((INS, None, hyp[j - 1]))
            j -= 1
    ops.reverse()
    return ops


def analyze(
    pairs: Sequence[Tuple[str, str, str]], top: int = 10
) -> Dict[str, object]:
    """Aggregate (uid, ref, hyp) triples into an error report.

    Keys: overall cer/wer; per-utterance CER percentiles + histogram;
    top substitution pairs / inserted / deleted characters AND words
    (the word alignment already feeds WER — its confusions are free);
    CER broken down by reference-length quartile; the worst utterances.
    """
    subs: Counter = Counter()
    ins: Counter = Counter()
    dels: Counter = Counter()
    wsubs: Counter = Counter()
    wins: Counter = Counter()
    wdels: Counter = Counter()
    per_utt: List[Tuple[float, str, str, str]] = []
    char_err = char_tot = word_err = word_tot = 0
    for uid, ref, hyp in pairs:
        ops = align(list(ref), list(hyp))
        errs = 0
        for kind, r, h in ops:
            if kind == SUB:
                subs[f"{r}->{h}"] += 1
                errs += 1
            elif kind == INS:
                ins[str(h)] += 1
                errs += 1
            elif kind == DEL:
                dels[str(r)] += 1
                errs += 1
        char_err += errs
        char_tot += len(ref)
        rw, hw = ref.split(), hyp.split()
        for kind, r, h in align(rw, hw):
            if kind == SUB:
                wsubs[f"{r}->{h}"] += 1
                word_err += 1
            elif kind == INS:
                wins[str(h)] += 1
                word_err += 1
            elif kind == DEL:
                wdels[str(r)] += 1
                word_err += 1
        word_tot += len(rw)
        per_utt.append((errs / max(len(ref), 1), uid, ref, hyp))

    cers = np.asarray([u[0] for u in per_utt], np.float64)
    edges = [0.0, 0.05, 0.1, 0.2, 0.4, 0.6, 1.0, np.inf]
    hist, _ = np.histogram(cers, bins=edges) if len(cers) else (
        np.zeros(len(edges) - 1, np.int64), None)

    # CER by reference-length quartile: where do the errors live?
    by_len: List[Dict[str, float]] = []
    if per_utt:
        lens = np.asarray([len(r) for _, _, r, _ in per_utt])
        qs = np.quantile(lens, [0.25, 0.5, 0.75]) if len(lens) > 3 else []
        bounds = [0, *[int(q) for q in qs], int(lens.max()) + 1]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            sel = [(e, len(r)) for e, _, r, _ in per_utt
                   if lo <= len(r) < hi or (hi == bounds[-1] and len(r) == hi - 1)]
            if not sel:
                continue
            e_sum = sum(e * n for e, n in sel)
            n_sum = sum(n for _, n in sel)
            by_len.append({
                "ref_len_range": [lo, hi - 1],
                "num_utterances": len(sel),
                "cer": e_sum / max(n_sum, 1),
            })

    worst = sorted(per_utt, reverse=True)[:top]
    return {
        "num_utterances": len(per_utt),
        "cer": char_err / max(char_tot, 1),
        "wer": word_err / max(word_tot, 1),
        "cer_percentiles": {
            "p50": float(np.percentile(cers, 50)) if len(cers) else 0.0,
            "p90": float(np.percentile(cers, 90)) if len(cers) else 0.0,
            "max": float(cers.max()) if len(cers) else 0.0,
        },
        "cer_histogram": {
            f"[{lo:g},{hi:g})": int(c)
            for lo, hi, c in zip(edges[:-1], edges[1:], hist)
        },
        "top_substitutions": subs.most_common(top),
        "top_insertions": ins.most_common(top),
        "top_deletions": dels.most_common(top),
        "top_word_substitutions": wsubs.most_common(top),
        "top_word_insertions": wins.most_common(top),
        "top_word_deletions": wdels.most_common(top),
        "cer_by_ref_length": by_len,
        "worst_utterances": [
            {"uid": u, "cer": round(e, 4), "ref": r, "hyp": h}
            for e, u, r, h in worst
        ],
    }


def analyze_file(path: str, top: int = 10) -> Dict[str, object]:
    return analyze(parse_predictions(path), top=top)


def _error_table(
    pairs: Sequence[Tuple[str, str, str]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """(char_errs, char_lens, word_errs, word_lens, uids) per utterance.

    The corpus CER/WER of any utterance subset is sum(errs)/sum(lens)
    over that subset — the quantity every bootstrap below resamples.
    """
    ce, cl, we, wl, uids = [], [], [], [], []
    for uid, ref, hyp in pairs:
        ce.append(levenshtein(list(ref), list(hyp)))
        cl.append(len(ref))
        we.append(levenshtein(ref.split(), hyp.split()))
        wl.append(len(ref.split()))
        uids.append(uid)
    return (
        np.asarray(ce, np.float64), np.asarray(cl, np.float64),
        np.asarray(we, np.float64), np.asarray(wl, np.float64), uids,
    )


def bootstrap_ci(
    pairs: Sequence[Tuple[str, str, str]],
    *,
    n_resamples: int = 2000,
    confidence: float = 0.95,
    seed: int = 0,
) -> Dict[str, object]:
    """Percentile-bootstrap confidence intervals for corpus CER and WER.

    Resamples UTTERANCES with replacement (the i.i.d. unit of an eval
    set) and recomputes the corpus-level ratio sum(errors)/sum(length)
    per resample — the standard recipe for error-rate uncertainty
    (Bisani & Ney 2004).  Host-side NumPy; vectorized over resamples.
    """
    ce, cl, we, wl, _ = _error_table(pairs)
    n = len(ce)
    if n == 0:
        raise ValueError("bootstrap_ci needs at least one utterance")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_resamples, n))
    lo_q = (1.0 - confidence) / 2.0
    out: Dict[str, object] = {
        "num_utterances": n,
        "n_resamples": n_resamples,
        "confidence": confidence,
    }
    for name, errs, lens in (("cer", ce, cl), ("wer", we, wl)):
        stat = errs[idx].sum(axis=1) / np.maximum(lens[idx].sum(axis=1), 1.0)
        out[name] = {
            "point": float(errs.sum() / max(lens.sum(), 1.0)),
            "low": float(np.quantile(stat, lo_q)),
            "high": float(np.quantile(stat, 1.0 - lo_q)),
        }
    return out


def compare(
    pairs_a: Sequence[Tuple[str, str, str]],
    pairs_b: Sequence[Tuple[str, str, str]],
    *,
    n_resamples: int = 2000,
    seed: int = 0,
    top: int = 10,
) -> Dict[str, object]:
    """Paired bootstrap significance test between two systems' predictions.

    Joins the two prediction sets on uid (references must agree), then
    resamples utterances with replacement and measures how often system
    A's corpus CER/WER is at least as high as B's.  ``p_value`` is the
    two-sided bootstrap p for "the CER/WER difference is zero"; small p
    + negative delta means A is significantly better.  Also reports the
    utterances whose error count changed the most in each direction —
    the qualitative "what did the change fix/break" list.
    """
    a = {uid: (ref, hyp) for uid, ref, hyp in pairs_a}
    b = {uid: (ref, hyp) for uid, ref, hyp in pairs_b}
    shared = [u for u in a if u in b]
    if not shared:
        raise ValueError("no shared uids between the two prediction sets")
    for u in shared:
        if a[u][0] != b[u][0]:
            raise ValueError(
                f"reference mismatch for uid {u!r}: the two prediction "
                "files score different eval sets"
            )
    joined_a = [(u, a[u][0], a[u][1]) for u in shared]
    joined_b = [(u, b[u][0], b[u][1]) for u in shared]
    cea, cla, wea, wla, _ = _error_table(joined_a)
    ceb, _, web, _, _ = _error_table(joined_b)
    n = len(shared)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_resamples, n))
    out: Dict[str, object] = {
        "num_shared_utterances": n,
        "only_in_a": len(a) - n,
        "only_in_b": len(b) - n,
        "n_resamples": n_resamples,
    }
    for name, ea, eb, lens in (
        ("cer", cea, ceb, cla), ("wer", wea, web, wla)
    ):
        tot = np.maximum(lens[idx].sum(axis=1), 1.0)
        sa = ea[idx].sum(axis=1) / tot
        sb = eb[idx].sum(axis=1) / tot
        delta = sa - sb
        point = float((ea.sum() - eb.sum()) / max(lens.sum(), 1.0))
        # two-sided: twice the smaller tail, using >= / <= so the
        # identical-systems case (delta identically zero) yields p = 1
        # rather than 0
        p = 2.0 * min(
            float(np.mean(delta >= 0.0)), float(np.mean(delta <= 0.0))
        )
        out[name] = {
            "a": float(ea.sum() / max(lens.sum(), 1.0)),
            "b": float(eb.sum() / max(lens.sum(), 1.0)),
            "delta": point,
            "delta_ci95": [
                float(np.quantile(delta, 0.025)),
                float(np.quantile(delta, 0.975)),
            ],
            "p_value": min(p, 1.0),
        }
    diff = cea - ceb
    order = np.argsort(diff)
    def _row(i: int) -> Dict[str, object]:
        u = shared[i]
        return {
            "uid": u, "ref": a[u][0],
            "hyp_a": a[u][1], "hyp_b": b[u][1],
            "char_errs_a": int(cea[i]), "char_errs_b": int(ceb[i]),
        }
    out["a_wins"] = [_row(i) for i in order[:top] if diff[i] < 0]
    out["b_wins"] = [_row(i) for i in order[::-1][:top] if diff[i] > 0]
    out["num_a_better"] = int(np.sum(diff < 0))
    out["num_b_better"] = int(np.sum(diff > 0))
    out["num_tied"] = int(np.sum(diff == 0))
    return out
