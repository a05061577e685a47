"""Text → IPA phonemes, split into sentences.

The PyTorch port's copy of the analogue of the reference's
``espeak-phonemizer`` crate
(``crates/text/espeak-phonemizer/src/lib.rs``).  The observable contract is
identical:

- input is split on newlines first (``lib.rs:65-83``);
- each clause's phonemes get the clause terminator appended as punctuation
  (the reference maps eSpeak intonation bits ``0x0000F000`` back to
  ``. , ? !`` — ``lib.rs:124-133``);
- sentences close on the sentence-type clause bit (``lib.rs:134-136``);
- an optional separator character is inserted between phonemes
  (``lib.rs:102-105``);
- language-switch flags ``(xx)`` and stress marks ``ˈ ˌ`` are optionally
  regex-stripped (``lib.rs:34-35,141-154``).

Architecture differs deliberately: G2P is a pluggable *backend* (eSpeak via
ctypes when libespeak-ng is installed, a hermetic rule-based fallback
otherwise), and all backend calls are mutex-serialized — the reference
leaves eSpeak's C globals unprotected in production and only dodges the race
by single-threading its tests (SURVEY §5); here the lock is part of the
design, since the gRPC frontend phonemizes from many threads.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import re
import threading
from typing import Optional, Protocol

from ..core import PhonemizationError, Phonemes
from .segmentation import Clause, split_clauses

# Same post-filters as the reference (espeak-phonemizer/src/lib.rs:34-35).
LANG_SWITCH_RE = re.compile(r"\([^)]*\)")
STRESS_RE = re.compile(r"[ˈˌ]")

# Characters that extend the preceding phoneme rather than starting a new
# one: length marks, aspiration/secondary articulations, rhotic hook, and
# all combining diacritics (category Mn).
_MODIFIERS = set("ːˑʰʲʷˤ˞")
# Two-codepoint phonemes written without a tie bar: affricates + diphthongs.
_DIGRAPHS = {"tʃ", "dʒ", "ts", "dz", "aɪ", "eɪ", "ɔɪ", "aʊ", "oʊ",
             "ɪə", "eə", "ʊə"}


def split_ipa_segments(ipa: str) -> list[str]:
    """Split an IPA string into phoneme-level segments: base character plus
    attached modifiers/diacritics, with affricate/diphthong digraphs kept
    whole."""
    import unicodedata

    segments: list[str] = []
    for ch in ipa:
        attached = ch in _MODIFIERS or unicodedata.combining(ch)
        if segments and (attached or segments[-1] + ch in _DIGRAPHS):
            segments[-1] += ch
        else:
            segments.append(ch)
    return segments

ESPEAK_DATA_ENV = "SONATA_ESPEAKNG_DATA_DIRECTORY"


class G2PBackend(Protocol):
    """Phonemize a single clause of text into one IPA string."""

    name: str

    def phonemize_clause(self, text: str, voice: str) -> str:
        ...


class RuleG2PBackend:
    """Dependency-free deterministic fallback (see :mod:`.rule_g2p`)."""

    name = "rule"

    def phonemize_clause(self, text: str, voice: str) -> str:
        from . import rule_g2p

        return rule_g2p.phonemize_clause(text, voice)


class EspeakBackend:
    """eSpeak-ng G2P over ctypes (no compiled extension needed).

    Loads ``libespeak-ng`` at runtime, initializes it once per process in
    phoneme-retrieval mode with the data directory from
    ``SONATA_ESPEAKNG_DATA_DIRECTORY`` (same env var as the reference,
    ``lib.rs:21,36-45``), and serializes all calls behind a lock because
    eSpeak keeps global state.
    """

    name = "espeak"

    _AUDIO_OUTPUT_RETRIEVAL = 1
    _CHARS_UTF8 = 1
    _PHONEMES_IPA = 0x02
    # terminator word layout (espeak-ng clause codes; reference constants
    # espeak-phonemizer/src/lib.rs:14-18)
    _INTONATION_MASK = 0x0000F000
    _INTONATION_CHAR = {0x0000: ".", 0x1000: ",", 0x2000: "?", 0x3000: "!"}
    _CLAUSE_TYPE_SENTENCE = 0x00080000

    def __init__(self, library_path: Optional[str] = None):
        path = (
            library_path
            or ctypes.util.find_library("espeak-ng")
            or ctypes.util.find_library("espeak")
        )
        if path is None:
            for cand in ("libespeak-ng.so.1", "libespeak-ng.so", "libespeak.so.1"):
                try:
                    ctypes.CDLL(cand)
                    path = cand
                    break
                except OSError:
                    continue
        if path is None:
            raise PhonemizationError("libespeak-ng not found on this system")
        self._lib = ctypes.CDLL(path)
        self._lock = threading.Lock()
        self._voice: Optional[str] = None
        self._lib.espeak_TextToPhonemes.restype = ctypes.c_char_p
        self._lib.espeak_TextToPhonemes.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int,
            ctypes.c_int,
        ]
        # the reference patches espeak-ng with a terminator-reporting
        # variant (espeak_TextToPhonemesWithTerminator) and derives clause
        # punctuation + sentence breaks from its clause loop
        # (espeak-phonemizer/src/lib.rs:113-137); when the loaded library
        # carries that symbol we use the same loop instead of host-side
        # regex segmentation
        self._with_terminator = getattr(
            self._lib, "espeak_TextToPhonemesWithTerminator", None)
        if self._with_terminator is not None:
            self._with_terminator.restype = ctypes.c_char_p
            self._with_terminator.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
        data_dir = os.environ.get(ESPEAK_DATA_ENV)
        rate = self._lib.espeak_Initialize(
            self._AUDIO_OUTPUT_RETRIEVAL,
            0,
            data_dir.encode() if data_dir else None,
            0,
        )
        if rate <= 0:
            raise PhonemizationError(
                f"espeak_Initialize failed (data dir: {data_dir or 'default'})"
            )

    @property
    def has_terminator_support(self) -> bool:
        return self._with_terminator is not None

    @classmethod
    def decode_terminator(cls, value: int) -> tuple[str, bool]:
        """(terminator char, sentence_end) from an eSpeak clause code —
        the mapping the reference applies at lib.rs:124-136."""
        char = cls._INTONATION_CHAR.get(value & cls._INTONATION_MASK, ".")
        return char, bool(value & cls._CLAUSE_TYPE_SENTENCE)

    def _set_voice_locked(self, voice: str) -> None:
        if voice != self._voice:
            if self._lib.espeak_SetVoiceByName(voice.encode()) != 0:
                raise PhonemizationError(f"unknown eSpeak voice: {voice}")
            self._voice = voice

    def _consume_clauses(self, text: str, call):
        """Drive eSpeak's consume-one-clause-per-call loop over ``text``.

        ``call(ptr_ref)`` performs one library call and returns the raw
        result; yields each decoded non-raw piece.  Callers must hold the
        lock and have set the voice.
        """
        buf = ctypes.create_string_buffer(text.encode("utf-8"))
        ptr = ctypes.c_void_p(ctypes.addressof(buf))
        while ptr.value:
            res = call(ctypes.byref(ptr))
            if res is None:
                break
            yield res.decode("utf-8", errors="replace").strip()

    def phonemize_clauses(self, line: str, voice: str):
        """eSpeak's own clause loop → [(ipa, terminator, sentence_end)].

        Only meaningful when :attr:`has_terminator_support`; mirrors the
        reference's ``_text_to_phonemes`` loop (lib.rs:113-137), so
        non-Latin scripts break sentences exactly where eSpeak does.
        Empty clauses (punctuation-only input) fold their terminator into
        the previous clause, matching the host-side segmentation's
        behavior for stray terminators.
        """
        out = []
        term = ctypes.c_int(0)
        with self._lock:
            self._set_voice_locked(voice)
            for ipa in self._consume_clauses(
                    line,
                    lambda ptr_ref: self._with_terminator(
                        ptr_ref, self._CHARS_UTF8, self._PHONEMES_IPA,
                        ctypes.byref(term))):
                char, sentence_end = self.decode_terminator(term.value)
                if not ipa:
                    if out:  # stray terminator attaches to previous clause
                        prev = out[-1]
                        out[-1] = (prev[0], char, prev[2] or sentence_end)
                    continue
                out.append((ipa, char, sentence_end))
        return out

    def phonemize_clause(self, text: str, voice: str) -> str:
        with self._lock:
            self._set_voice_locked(voice)
            # eSpeak consumes one clause per call, advancing the pointer;
            # we pre-split clauses, but a clause may still span eSpeak's
            # internal limits, so loop until the input is consumed.
            pieces = [p for p in self._consume_clauses(
                text,
                lambda ptr_ref: self._lib.espeak_TextToPhonemes(
                    ptr_ref, self._CHARS_UTF8, self._PHONEMES_IPA)) if p]
            return " ".join(pieces)


_DEFAULT_BACKEND: Optional[G2PBackend] = None
_BACKEND_LOCK = threading.Lock()


def get_default_backend() -> G2PBackend:
    """eSpeak when available, rule-based fallback otherwise."""
    global _DEFAULT_BACKEND
    if _DEFAULT_BACKEND is None:
        with _BACKEND_LOCK:
            if _DEFAULT_BACKEND is None:
                try:
                    _DEFAULT_BACKEND = EspeakBackend()
                except (PhonemizationError, OSError, AttributeError):
                    # OSError: unloadable lib; AttributeError: lib loaded
                    # but missing the phoneme API (legacy espeak builds)
                    _DEFAULT_BACKEND = RuleG2PBackend()
    return _DEFAULT_BACKEND


def text_to_phonemes(
    text: str,
    voice: str = "en-us",
    separator: Optional[str] = None,
    remove_lang_switch_flags: bool = False,
    remove_stress: bool = False,
    backend: Optional[G2PBackend] = None,
) -> Phonemes:
    """Phonemize ``text`` into per-sentence IPA strings.

    Same signature semantics as the reference's ``text_to_phonemes``
    (``espeak-phonemizer/src/lib.rs:65``).
    """
    backend = backend or get_default_backend()
    phonemes = Phonemes()
    for line in text.splitlines():  # newline split first (lib.rs:65-83)
        if not line.strip():
            continue
        _phonemize_line(line, voice, separator, remove_lang_switch_flags,
                        remove_stress, backend, phonemes)
    return phonemes


def _phonemize_line(
    line: str,
    voice: str,
    separator: Optional[str],
    remove_lang_switch_flags: bool,
    remove_stress: bool,
    backend: G2PBackend,
    out: Phonemes,
) -> None:
    current: list[str] = []
    if getattr(backend, "has_terminator_support", False):
        # patched eSpeak: its clause loop is the segmentation authority
        # (parity with the reference's terminator-driven splitting)
        triples = backend.phonemize_clauses(line, voice)
    else:
        triples = [(backend.phonemize_clause(c.text, voice), c.terminator,
                    c.sentence_end) for c in split_clauses(line)]
    for ipa, terminator, sentence_end in triples:
        if remove_lang_switch_flags:
            ipa = LANG_SWITCH_RE.sub("", ipa)  # lib.rs:141-147
        if remove_stress:
            ipa = STRESS_RE.sub("", ipa)  # lib.rs:148-154
        if separator:
            # insert separator between phonemes, as the reference does via
            # phoneme_mode bits (lib.rs:102-105).  A "phoneme" is a base
            # character plus its modifiers — not a code point: affricate
            # ties, length marks, and combining diacritics stay attached.
            ipa = separator.join(split_ipa_segments(ipa))
        # terminator punctuation is a real symbol for VITS (lib.rs:124-133)
        current.append(ipa + terminator)
        if sentence_end:
            out.append(" ".join(current))
            current = []
    if current:
        out.append(" ".join(current))
