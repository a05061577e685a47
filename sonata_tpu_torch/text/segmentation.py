"""Clause and sentence segmentation for the phonemizer front-end.

In the reference, segmentation is a side effect of eSpeak-ng's clause loop:
each ``espeak_TextToPhonemesWithTerminator`` call returns one clause plus
terminator metadata, the intonation bits are mapped back to punctuation, and
the CLAUSE_TYPE_SENTENCE bit ends a sentence
(``crates/text/espeak-phonemizer/src/lib.rs:124-136``).

This module is the host-side implementation of that contract — clause
splitting independent of any G2P backend, each clause carrying its
terminator punctuation (one of ``. , ? ! ; :``) and a "sentence end" flag.
It is the default segmentation authority; when the loaded libespeak-ng
carries the reference's patched terminator API, the phonemizer defers to
eSpeak's own clause loop instead (:meth:`EspeakBackend.phonemize_clauses`)
for exact reference parity on non-Latin scripts.  Either way compiled
program shapes stay bounded: sentences pad to TEXT_BUCKETS shapes
downstream (multiples of the top bucket beyond it) regardless of where
the boundaries fall.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

# Punctuation that terminates a clause.  Sentence enders are a subset, same
# set eSpeak's CLAUSE_TYPE_SENTENCE covers for Latin scripts, plus their
# Arabic counterparts (، ؛ ؟) since the reference's Arabic path flows through
# the same clause loop.
_CLAUSE_END = ".,;:!?،؛؟。，"
_SENTENCE_END = ".!?؟。"

# Map non-Latin terminators onto the reference's canonical four
# (espeak-phonemizer/src/lib.rs:124-133 maps intonation bits → ``. , ? !``).
_TERMINATOR_CANON = {
    "،": ",",  # Arabic comma
    "؛": ",",  # Arabic semicolon → pause-like
    "؟": "?",  # Arabic question mark
    "。": ".",  # CJK full stop
    "，": ",",  # CJK comma
    ";": ",",
    ":": ",",
}

_ABBREVIATIONS = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "inc",
    "ltd", "co", "fig", "al", "dept", "est", "approx",
    "e.g", "i.e", "a.m", "p.m",  # matched after placeholder restoration
}

# Dotted abbreviations whose *internal* periods must survive clause
# splitting; protected with a placeholder before the clause regex runs.
_DOTTED_ABBR_RE = re.compile(
    r"\b(e\.g|i\.e|a\.m|p\.m|u\.s|u\.k|ph\.d|d\.c|b\.c|a\.d)\.",
    re.IGNORECASE,
)
_DOT_PLACEHOLDER = "\x00"

_CLAUSE_RE = re.compile(rf"[^{re.escape(_CLAUSE_END)}]*[{re.escape(_CLAUSE_END)}]?")


@dataclass(frozen=True)
class Clause:
    text: str          # clause text without the terminator
    terminator: str    # canonical terminator punctuation: ``. , ? !``
    sentence_end: bool


def _is_abbreviation(text: str) -> bool:
    last_word = text.rstrip().rsplit(None, 1)[-1] if text.strip() else ""
    last_word = last_word.replace(_DOT_PLACEHOLDER, ".")
    if last_word.lower().rstrip(".") in _ABBREVIATIONS:
        return True
    # single capital letter reads as an initial ("J. Smith") — except the
    # pronoun "I", which legitimately ends sentences ("It was I.")
    return (
        len(last_word) == 1
        and last_word.isalpha()
        and last_word.isupper()
        and last_word != "I"
    )


def split_clauses(text: str) -> list[Clause]:
    """Split one line of text into clauses with terminator metadata."""
    # protect internal periods of dotted abbreviations ("e.g.", "p.m.")
    # from the clause regex; restored in the emitted clause text
    text = _DOTTED_ABBR_RE.sub(
        lambda m: m.group(0)[:-1].replace(".", _DOT_PLACEHOLDER) + ".", text
    )
    clauses: list[Clause] = []
    pending = ""  # text carried over a non-breaking period (abbreviation)
    for m in _CLAUSE_RE.finditer(text):
        chunk = m.group(0)
        if not chunk:
            continue
        body, term = (chunk[:-1], chunk[-1]) if chunk[-1] in _CLAUSE_END else (chunk, "")
        body = pending + body
        pending = ""
        if term == "." and _is_abbreviation(body):
            pending = body + "."
            continue
        body = body.strip()
        if not body and not clauses:
            continue
        canon = _TERMINATOR_CANON.get(term, term) or "."
        sentence_end = term in _SENTENCE_END or term == ""
        if body:
            clauses.append(
                Clause(body.replace(_DOT_PLACEHOLDER, "."), canon, sentence_end)
            )
        elif clauses:
            # stray terminator attaches to the previous clause
            prev = clauses[-1]
            clauses[-1] = Clause(
                prev.text, canon, prev.sentence_end or sentence_end
            )
    if pending.strip():
        body = pending.strip().rstrip(".").replace(_DOT_PLACEHOLDER, ".")
        clauses.append(Clause(body, ".", True))
    return clauses


def split_sentences(text: str) -> list[str]:
    """Plain-text sentence split (used by frontends for progress display)."""
    sentences: list[str] = []
    for line in text.splitlines():
        current: list[str] = []
        for clause in split_clauses(line):
            current.append(clause.text + clause.terminator)
            if clause.sentence_end:
                sentences.append(" ".join(current))
                current = []
        if current:
            sentences.append(" ".join(current))
    return [s for s in (s.strip() for s in sentences) if s]
