"""Hermetic rule-based grapheme→IPA fallback backend (English).

The reference depends unconditionally on a patched eSpeak-ng C library plus
~100 compiled dictionary files vendored in-tree
(``deps/dev/espeak-ng-data``, SURVEY §2.2).  When libespeak-ng is absent this
module provides a deterministic, dependency-free letter-to-sound backend
good enough for tests, benchmarks, and development.  Production deployments
use the eSpeak backend (:class:`.phonemizer.EspeakBackend`) when
libespeak-ng is installed.

This is the PyTorch port's own copy of the JAX package's rule backend, cut
to its English pack: the registry holds ``"en"`` alone, and every other
language code is refused like an unknown one.

Output is genuine IPA over the same symbol inventory Piper voices use in
their ``phoneme_id_map`` (config JSON next to each voice), so phoneme-id
encoding works unchanged with real voice configs.
"""

from __future__ import annotations

import re

# The word lexicon lives in :mod:`.lexicon` (~1.2k stressed base words
# multiplied by morphological derivation).

# -- ordered letter-to-sound rules ------------------------------------------
# (pattern, ipa) — longest-match-first within position scanning.
_RULES: list[tuple[str, str]] = [
    ("tion", "ʃən"), ("sion", "ʒən"), ("ture", "tʃɚ"), ("ought", "ɔːt"),
    ("aught", "ɔːt"), ("eigh", "eɪ"), ("igh", "aɪ"), ("tch", "tʃ"),
    ("dge", "dʒ"), ("sch", "sk"), ("ing", "ɪŋ"),
    ("th", "θ"), ("sh", "ʃ"), ("ch", "tʃ"), ("ph", "f"), ("wh", "w"),
    ("qu", "kw"), ("ck", "k"), ("ng", "ŋ"), ("gh", "ɡ"), ("kn", "n"),
    ("wr", "ɹ"), ("mb", "m"),
    ("ee", "iː"), ("ea", "iː"), ("oo", "uː"), ("ou", "aʊ"), ("ow", "oʊ"),
    ("ai", "eɪ"), ("ay", "eɪ"), ("oa", "oʊ"), ("oi", "ɔɪ"), ("oy", "ɔɪ"),
    ("au", "ɔː"), ("aw", "ɔː"), ("ew", "uː"), ("ey", "eɪ"), ("ie", "iː"),
    ("eu", "uː"), ("ue", "uː"),
    ("ar", "ɑːɹ"), ("er", "ɚ"), ("ir", "ɜː"), ("or", "ɔːɹ"), ("ur", "ɜː"),
    ("a", "æ"), ("b", "b"), ("c", "k"), ("d", "d"), ("e", "ɛ"), ("f", "f"),
    ("g", "ɡ"), ("h", "h"), ("i", "ɪ"), ("j", "dʒ"), ("k", "k"), ("l", "l"),
    ("m", "m"), ("n", "n"), ("o", "ɑː"), ("p", "p"), ("r", "ɹ"), ("s", "s"),
    ("t", "t"), ("u", "ʌ"), ("v", "v"), ("w", "w"), ("x", "ks"),
    ("y", "j"), ("z", "z"),
]

# Suffix-anchored renderings for out-of-lexicon words: Latinate endings
# whose letter-by-letter readings are badly wrong ("quantization" must end
# ˈeɪʃən, not æʃən).  Longest-first; entries carrying ˈ fix the stress too
# (these suffixes attract primary stress onto themselves or leave the stem
# unstressed, which default stress would get wrong).
_SUFFIXES: list[tuple[str, str]] = [
    # a leading "<" sentinel means "primary stress lands on the STEM's
    # last syllable" (the -ic(al) family): mathematical → mæθəmˈæɾɪkəl
    ("ization", "aɪzˈeɪʃən"), ("ification", "ɪfɪkˈeɪʃən"),
    ("ation", "ˈeɪʃən"), ("ition", "ˈɪʃən"), ("ution", "ˈuːʃən"),
    ("icity", "ˈɪsɪti"), ("ibility", "əbˈɪlɪti"),
    ("ability", "əbˈɪlɪti"), ("bility", "bˈɪlɪti"),
    ("cious", "ʃəs"), ("tious", "ʃəs"), ("geous", "dʒəs"),
    ("cial", "ʃəl"), ("tial", "ʃəl"), ("cian", "ʃən"),
    ("ience", "iəns"), ("ient", "iənt"),
    ("ology", "ˈɑːlədʒi"), ("ography", "ˈɑːɡɹəfi"),
    ("ular", "jʊlɚ"),
    ("ically", "<ɪkli"), ("ical", "<ɪkəl"), ("icist", "<ɪsɪst"),
    ("ualize", "juəlaɪz"), ("ual", "juəl"),
    ("ious", "iəs"), ("ous", "əs"),
    ("ative", "<əɾɪv"), ("itive", "<ɪɾɪv"), ("ive", "ɪv"),
    ("able", "əbəl"), ("ible", "əbəl"),
    ("ture", "tʃɚ"), ("sure", "ʒɚ"),
    ("ary", "ˌɛɹi"), ("ory", "ˌɔːɹi"),
    ("ism", "ɪzəm"), ("ist", "ɪst"),
    ("izer", "aɪzɚ"), ("izing", "aɪzɪŋ"), ("izes", "aɪzɪz"),
    ("ize", "aɪz"), ("ise", "aɪz"),
    ("ify", "ɪfaɪ"), ("ity", "ɪti"),
    ("al", "əl"), ("le", "əl"), ("el", "əl"),
]

_VOWEL_UNITS = ("aɪ", "aʊ", "eɪ", "oʊ", "ɔɪ", "iː", "uː", "ɑː",
                     "ɔː", "ɜː", "a", "e", "i", "o", "u", "æ", "ɛ",
                     "ɪ", "ɒ", "ɔ", "ʊ", "ʌ", "ə", "ɚ")


def _stress_stem_last(ipa: str) -> str:
    """Insert ˈ before the onset of the LAST syllable of a stem's IPA
    (the -ic(al)/-ative family attracts stress there)."""
    ipa = ipa.replace("ˈ", "").replace("ˌ", "")
    last = -1
    k = 0
    while k < len(ipa):
        for v in _VOWEL_UNITS:
            if ipa.startswith(v, k):
                last = k
                k += len(v)
                break
        else:
            k += 1
    if last < 0:
        return ipa

    def is_vowelish(k: int) -> bool:
        return any(ipa.startswith(v, k) for v in _VOWEL_UNITS) \
            or ipa[k] in "ːˈˌ"

    # take at most a LEGAL onset: one consonant (affricates dʒ/tʃ count
    # whole), or obstruent+liquid / s+stop pairs — walking back
    # arbitrary clusters would put the mark inside codas (kəˈmpiːt)
    onset = last
    if onset > 0 and not is_vowelish(onset - 1):
        onset -= 1
        if onset > 0 and not is_vowelish(onset - 1):
            pair = ipa[onset - 1] + ipa[onset]
            if pair in ("dʒ", "tʃ") or \
                    (pair[0] in "pbtdkɡf" and pair[1] in "ɹrl") or \
                    (pair[0] == "s" and pair[1] in "ptk"):
                onset -= 1
    return ipa[:onset] + "ˈ" + ipa[onset:]


_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _TENS[t] + (" " + _ONES[o] if o else "")
    if n < 1000:
        h, r = divmod(n, 100)
        return _ONES[h] + " hundred" + (" " + number_to_words(r) if r else "")
    if n < 1_000_000:
        k, r = divmod(n, 1000)
        return number_to_words(k) + " thousand" + (" " + number_to_words(r) if r else "")
    m, r = divmod(n, 1_000_000)
    return number_to_words(m) + " million" + (" " + number_to_words(r) if r else "")


def expand_numbers(text: str, number_words) -> str:
    """Replace integer literals with ``number_words(n)`` renderings —
    the English normalizer's last pass."""
    def _num(m: re.Match) -> str:
        try:
            return " " + number_words(int(m.group(0))) + " "
        except ValueError:
            return " "

    return re.sub(r"\d+", _num, text)


def normalize_text(text: str) -> str:
    """Expand numeric shapes (currency, ordinals, years, decimals via the
    English :class:`.numerics.NumberGrammar`, then bare
    integers), lowercase, drop symbols the G2P cannot speak."""
    from .numerics import en_grammar, expand_numerics

    text = expand_numerics(text, en_grammar())
    return expand_numbers(text, number_to_words).lower()


from .lexicon import IPA_VOWELS as _IPA_VOWEL_STARTS


def _default_stress(ipa: str) -> str:
    """Insert primary stress before the first syllable when a
    rule-generated word has two or more vowel nuclei and no primary mark
    yet (eSpeak marks stress on every content word; Piper voices carry
    ˈ/ˌ in their phoneme maps).  A lone secondary mark — a demoted
    compound second element or a ˌ-bearing suffix — does not count: the
    word still needs its primary."""
    if "ˈ" in ipa:
        return ipa
    nuclei = [i for i, ch in enumerate(ipa) if ch in _IPA_VOWEL_STARTS
              and (i == 0 or ipa[i - 1] not in _IPA_VOWEL_STARTS)]
    if len(nuclei) < 2:
        return ipa  # monosyllables are left unmarked, like the lexicon
    for first in nuclei:
        # place the mark before the syllable onset (the consonant run
        # preceding the nucleus) — unless that syllable already carries
        # the secondary mark (then the primary belongs elsewhere)
        onset = first
        while onset > 0 and ipa[onset - 1] not in _IPA_VOWEL_STARTS + "ːˌ":
            onset -= 1
        if onset > 0 and ipa[onset - 1] == "ˌ":
            continue
        return ipa[:onset] + "ˈ" + ipa[onset:]
    return ipa


def _scan_letters(word: str) -> str:
    """Letter-to-sound scan of one orthographic word (no lexicon)."""
    # doubled consonant letters read as one sound ("connect", "happen");
    # doubled vowels stay — they are real digraphs (ee, oo) — and "cc"
    # stays: before a front vowel its letters are distinct sounds
    # ("access" = /ks/), handled as a digraph below
    word = re.sub(r"([bdfghj-np-tvwxz])\1", r"\1", word)
    out: list[str] = []
    i = 0
    # final silent 'e' lengthens the previous vowel (rough magic-e rule)
    magic_e = len(word) > 2 and word.endswith("e") and word[-2] not in "aeiou"
    body = word[:-1] if magic_e else word
    while i < len(body):
        if body[i] == "y" and i == len(body) - 1:
            out.append("i")  # word-final y is a vowel ("twenty" → …ti)
            break
        # "cc": /ks/ before front vowels ("access"), /k/ otherwise
        if body.startswith("cc", i):
            nxt = body[i + 2] if i + 2 < len(body) else ""
            out.append("ks" if nxt in "eiy" else "k")
            i += 2
            continue
        # context rules: soft c/g before front vowels
        if body[i] == "c" and i + 1 < len(body) and body[i + 1] in "eiy":
            out.append("s")
            i += 1
            continue
        if body[i] == "g" and i + 1 < len(body) and body[i + 1] in "ei":
            out.append("dʒ")
            i += 1
            continue
        for pat, ipa in _RULES:
            if body.startswith(pat, i):
                out.append(ipa)
                i += len(pat)
                break
        else:
            i += 1  # unknown character: drop
    ipa = "".join(out)
    if magic_e:
        # lengthen the rightmost short vowel ("fine" → faɪn, "alone" → əloʊn)
        pairs = (("æ", "eɪ"), ("ɪ", "aɪ"), ("ɑː", "oʊ"), ("ʌ", "uː"),
                 ("ɛ", "iː"))
        best = max(pairs, key=lambda p: ipa.rfind(p[0]))
        idx = ipa.rfind(best[0])
        if idx >= 0:
            ipa = ipa[:idx] + best[1] + ipa[idx + len(best[0]):]
    return ipa


def english_word_to_ipa(word: str) -> str:
    from .lexicon import derive

    hit = derive(word)  # lexicon + morphology + closed compounds
    if hit is not None:
        # a polysyllable derived from an unmarked monosyllable base
        # ("stream" → "streaming") still needs its stress mark
        return _default_stress(hit)
    # suffix-anchored endings before the raw letter scan: the stem scans
    # letter-by-letter, the ending renders from the table (and may carry
    # the stress mark the suffix attracts).  A trailing plural/3sg -s
    # rides along (congratulations = congratulation + z).
    suffix_word = word
    if word.endswith("ies") and len(word) > 5:
        suffix_word = word[:-3] + "y"  # responsibilities → ...ity
    elif word.endswith("s") and not word.endswith("ss") and len(word) > 4:
        suffix_word = word[:-1]
    candidates = [(word, False)]
    if suffix_word != word:
        candidates.append((suffix_word, True))
    for suf, sipa in _SUFFIXES:
        for w, plur in candidates:
            stem = w[: -len(suf)]
            if (w.endswith(suf) and len(stem) >= 3
                    and any(v in stem for v in "aeiouy")):
                base = derive(stem) or derive(stem + "e") \
                    or _scan_letters(stem)
                if sipa.startswith("<"):
                    # the suffix attracts stress onto the stem's last
                    # syllable (the -ic(al)/-ative family)
                    base = _stress_stem_last(base)
                    sipa = sipa[1:]
                elif "ˈ" in sipa:
                    # a stem resolved from the lexicon keeps only its own
                    # secondary prominence when the suffix carries primary
                    base = base.replace("ˈ", "ˌ")
                out = base + sipa
                if plur:
                    from .lexicon import _plural

                    out = _plural(out)  # s/z/ɪz allomorphy
                return _default_stress(out)
    return _default_stress(_scan_letters(word))


# Language registry: language code → (normalizer, word→IPA).  The eSpeak
# backend covers ~100 languages via compiled dictionaries; the hermetic
# backend supports exactly the languages listed here and REFUSES others
# rather than silently rendering them through English letter-to-sound
# rules (which produces confidently wrong phonemes).
_LANGUAGES: dict[str, tuple] = {
    "en": (normalize_text, english_word_to_ipa),
}

#: Env var: set to "1" to let unsupported languages fall back to English
#: letter-to-sound rules (explicitly best-effort) instead of raising.
BEST_EFFORT_ENV = "SONATA_G2P_BEST_EFFORT"


def supported_languages() -> tuple[str, ...]:
    """Language codes the hermetic backend can phonemize."""
    return tuple(sorted(_LANGUAGES))


def phonemize_clause(text: str, voice: str = "en-us") -> str:
    """Phonemize one clause of text into a single IPA string.

    Words become space-separated IPA runs, matching the shape of eSpeak
    output the downstream phoneme-id encoder expects (spaces are real
    symbols in Piper's ``phoneme_id_map``).

    Raises :class:`~sonata_tpu.core.PhonemizationError` for languages the
    hermetic backend has no rules for — silently emitting English-rule
    phonemes for a German voice would be confidently wrong.  Set
    ``SONATA_G2P_BEST_EFFORT=1`` to opt into the English fallback.
    """
    import os

    from ..core import PhonemizationError

    lang = voice.split("-")[0].lower()
    entry = _LANGUAGES.get(lang)
    if entry is None:
        if os.environ.get(BEST_EFFORT_ENV) == "1":
            entry = _LANGUAGES["en"]
        else:
            raise PhonemizationError(
                f"hermetic G2P has no rules for language {lang!r} "
                f"(voice {voice!r}); supported: "
                f"{', '.join(supported_languages())}. Install libespeak-ng "
                f"for full language coverage, or set {BEST_EFFORT_ENV}=1 "
                f"to accept best-effort English letter-to-sound rules."
            )
    normalize, to_ipa = entry
    # \w excludes combining marks (category Mn): include the Arabic
    # harakat (the tashkeel stage inserts them), the Devanagari
    # matras/virama/anusvara (Nepali syllables are meaningless without
    # them — but NOT the danda punctuation U+0964/65), and the general
    # combining range U+0300-036F so NFD-normalized Vietnamese keeps
    # its tone marks
    words = re.findall(
        r"[\w'\u0300-\u036F\u05B0-\u05BD\u05BF\u05C1\u05C2"
        r"\u05C4\u05C5\u05C7\u064B-\u0655\u0670"
        r"\u0900-\u0963\u0966-\u097F]+",
        normalize(text), flags=re.UNICODE)
    ipa_words = [to_ipa(w) for w in words]
    return " ".join(w for w in ipa_words if w)
