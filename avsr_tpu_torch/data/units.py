"""Unit dictionaries: symbol tables mapping transcription units <-> ids.

A copy of ``avsr_tpu/data/units.py`` (the port imports nothing of
``avsr_tpu``); ``tests/test_torch_port_hygiene.py`` holds the builtin
inventories of both copies equal.

The reference ships plain-text symbol tables (character list incl. GO/EOS,
viseme/phoneme lists for the TCD-TIMIT protocols) under upstream:avsr/misc/
(SURVEY.md §2.2 row 13).  This module provides the same capability: load a
unit file, or fall back to built-in character / phoneme / viseme inventories,
and encode/decode label sequences with GO/EOS handling
(upstream:avsr/io_utils.py label-id path, SURVEY §2.2 row 10).

Id conventions (fixed, relied on across the framework):
  0 = PAD, 1 = GO (decoder start), 2 = EOS (decoder stop / label terminator).
Real units start at 3.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

PAD_ID = 0
GO_ID = 1
EOS_ID = 2

PAD = "<pad>"
GO = "<go>"
EOS = "<eos>"

_SPECIALS = [PAD, GO, EOS]

# English character inventory used by the reference's character models
# (lowercase letters, space, apostrophe).
_CHARACTERS = list("abcdefghijklmnopqrstuvwxyz") + [" ", "'"]

# LRS2 character inventory: LRS2 transcripts additionally contain digits —
# with the base inventory they would be silently dropped from references,
# faking better WER.  Punctuation policy: keep apostrophe/hyphen/period/comma
# (they appear in LRS2 text), drop everything else explicitly via the unit
# file if a different protocol is needed.
_CHARACTERS_LRS2 = _CHARACTERS + list("0123456789") + ["-", ".", ","]

# ARPAbet-style phoneme inventory (TCD-TIMIT protocol set, reduced 39).
_PHONEMES = (
    "aa ae ah aw ay b ch d dh eh er ey f g hh ih iy jh k l m n ng ow oy p r s"
    " sh sil t th uh uw v w y z zh"
).split()

# Viseme inventory for the TCD-TIMIT viseme protocol (Neti et al. clustering).
_VISEMES = "A B C D E F G H S V sil".split()


class UnitDict:
    """Bidirectional unit <-> id table with PAD/GO/EOS bookkeeping."""

    def __init__(self, units: Sequence[str], unit_type: str = "character"):
        self.unit_type = unit_type
        self.idx_to_unit: List[str] = list(_SPECIALS) + list(units)
        self.unit_to_idx = {u: i for i, u in enumerate(self.idx_to_unit)}
        if len(self.unit_to_idx) != len(self.idx_to_unit):
            raise ValueError("duplicate units in unit dictionary")

    # -- size ---------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.idx_to_unit)

    def __len__(self) -> int:
        return self.vocab_size

    # -- encode / decode ------------------------------------------------------
    def tokenize(self, transcript: str) -> List[str]:
        if self.unit_type.startswith("character"):
            return list(transcript.lower())
        return transcript.strip().split()

    def encode(
        self, transcript: str, add_eos: bool = True, on_unknown: str = "drop"
    ) -> List[int]:
        """Transcript -> ids.

        ``on_unknown`` controls out-of-inventory units:
          * "drop" (default, reference behavior: record writers filtered
            transcripts to the unit inventory) — silently skip;
          * "error" — raise, naming the offending symbols.  Use for corpora
            whose transcripts should be fully covered (dropped symbols in
            REFERENCES fake better error rates).
        """
        toks = self.tokenize(transcript)
        if on_unknown == "error":
            unknown = sorted({t for t in toks if t not in self.unit_to_idx})
            if unknown:
                raise ValueError(
                    f"transcript contains units outside the "
                    f"{self.unit_type!r} inventory: {unknown!r} "
                    f"(transcript={transcript!r})"
                )
        ids = [self.unit_to_idx[t] for t in toks if t in self.unit_to_idx]
        if add_eos:
            ids.append(EOS_ID)
        return ids

    def count_unknown(self, transcript: str) -> int:
        """Number of tokens encode() would drop."""
        return sum(
            1 for t in self.tokenize(transcript) if t not in self.unit_to_idx
        )

    def decode(self, ids: Iterable[int], stop_at_eos: bool = True) -> str:
        units: List[str] = []
        for i in ids:
            i = int(i)
            if i == EOS_ID and stop_at_eos:
                break
            if i in (PAD_ID, GO_ID, EOS_ID):
                continue
            if 0 <= i < len(self.idx_to_unit):
                units.append(self.idx_to_unit[i])
        if self.unit_type.startswith("character"):
            return "".join(units)
        return " ".join(units)

    # -- io -------------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for u in self.idx_to_unit[len(_SPECIALS):]:
                f.write(u + "\n")

    @classmethod
    def load(cls, path: str, unit_type: str = "character") -> "UnitDict":
        units: List[str] = []
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                # Tolerate "unit id" two-column tables as well as one-per-line.
                if " " in line and not unit_type.startswith("character"):
                    line = line.split()[0]
                if line and line not in _SPECIALS:
                    units.append(line)
        return cls(units, unit_type)


def builtin_unit_dict(unit_type: str = "character") -> UnitDict:
    if unit_type == "character":
        return UnitDict(_CHARACTERS, "character")
    if unit_type == "character_lrs2":
        return UnitDict(_CHARACTERS_LRS2, "character_lrs2")
    if unit_type == "phoneme":
        return UnitDict(_PHONEMES, "phoneme")
    if unit_type == "viseme":
        return UnitDict(_VISEMES, "viseme")
    raise ValueError(f"unknown unit type: {unit_type}")


def load_or_builtin(unit_file: Optional[str], unit_type: str) -> UnitDict:
    if unit_file:
        return UnitDict.load(unit_file, unit_type)
    return builtin_unit_dict(unit_type)


def from_transcripts(
    transcripts: Iterable[str],
    unit_type: str = "character",
    min_count: int = 1,
):
    """Discover a unit inventory from corpus transcripts.

    The reference ships fixed symbol tables; users bringing their own
    corpus need the inverse — build the table FROM the data so nothing is
    silently dropped at encode time (dropped reference symbols fake
    better error rates; see ``UnitDict.encode``).  Tokenization matches
    ``UnitDict.tokenize`` for the given ``unit_type`` (lowercased
    characters, or whitespace units).  ``min_count`` drops tail units
    (typos, stray punctuation) — dropped units are reported, not hidden.

    Returns ``(unit_dict, counts, dropped)`` where ``counts`` maps every
    observed unit to its corpus frequency and ``dropped`` is the sorted
    list of units excluded by ``min_count``.
    """
    if min_count < 1:
        raise ValueError(f"min_count must be >= 1, got {min_count}")
    probe = UnitDict([], unit_type)  # tokenizer for this unit_type
    counts: dict = {}
    for t in transcripts:
        for tok in probe.tokenize(t):
            counts[tok] = counts.get(tok, 0) + 1
    kept = sorted(u for u, c in counts.items() if c >= min_count)
    dropped = sorted(u for u, c in counts.items() if c < min_count)
    return UnitDict(kept, unit_type), counts, dropped
