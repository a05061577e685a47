"""Hermetic rule-based grapheme→IPA fallback backend.

The reference depends unconditionally on a patched eSpeak-ng C library plus
~100 compiled dictionary files vendored in-tree
(``deps/dev/espeak-ng-data``, SURVEY §2.2).  When libespeak-ng is absent this
module provides a deterministic, dependency-free letter-to-sound backend
good enough for tests, benchmarks, and development.  Production deployments
use the eSpeak backend (:class:`.phonemizer.EspeakBackend`) when
libespeak-ng is installed.

The registry (:data:`_LANGUAGES`) and every language pack
(``rule_g2p_*.py``) are the port's own copies of the JAX package's.

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

# -- Arabic letters → IPA (MSA, broad) --------------------------------------
_ARABIC = {
    "ا": "aː", "ب": "b", "ت": "t", "ث": "θ", "ج": "dʒ", "ح": "ħ", "خ": "x",
    "د": "d", "ذ": "ð", "ر": "r", "ز": "z", "س": "s", "ش": "ʃ", "ص": "sˤ",
    "ض": "dˤ", "ط": "tˤ", "ظ": "ðˤ", "ع": "ʕ", "غ": "ɣ", "ف": "f",
    "ق": "q", "ك": "k", "ل": "l", "م": "m", "ن": "n", "ه": "h", "و": "w",
    "ي": "j", "ء": "ʔ", "ى": "aː", "ة": "a", "أ": "ʔa", "إ": "ʔi",
    "آ": "ʔaː", "ؤ": "ʔ", "ئ": "ʔ",
    # diacritics (possibly inserted by the tashkeel stage)
    "َ": "a", "ُ": "u", "ِ": "i", "ّ": "ː",
    "ً": "an", "ٌ": "un", "ٍ": "in", "ْ": "",
}


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


def epenthesize_runs(units: list, flags: list, *, vowel: str = "e",
                     final_cluster_ok=None) -> str:
    """Break consonant runs with an epenthetic vowel — shared by the
    unvocalized-script packs (Persian/Urdu, Hebrew), whose scripts drop
    short vowels entirely.

    Policy: no initial clusters (the run's first consonant takes the
    epenthetic vowel: سلام → selɒːm, שלום → ʃelom); word-internal and
    final runs keep up to two consonants unless ``final_cluster_ok``
    (a predicate over the final run) rejects them; longer runs break
    before their last member.
    """
    if final_cluster_ok is None:
        final_cluster_ok = lambda run: True  # noqa: E731
    out: list[str] = []
    i = 0
    n = len(units)
    while i < n:
        if flags[i]:
            out.append(units[i])
            i += 1
            continue
        j = i
        while j < n and not flags[j]:
            j += 1
        run = units[i:j]
        at_end = j == n
        if i == 0 and len(run) >= 2:
            out.append(run[0])
            out.append(vowel)
            run = run[1:]
        if len(run) >= 2 and (len(run) > 2 or
                              (at_end and not final_cluster_ok(run))):
            out.extend(run[:-1])
            out.append(vowel)
            out.append(run[-1])
        else:
            out.extend(run)
        i = j
    return "".join(out)


def south_asian_number_words(num: int, *, ones: list, tens: dict,
                             hundred: str, thousand: str, lakh: str,
                             minus: str) -> str:
    """Shared analytic numeral skeleton for the lakh-system languages
    (Nepali, Hindi): exact 0-20, tens + ones, hundreds, thousands,
    lakhs.  Real usage fuses 21-99 irregularly — that needs the
    dictionaries eSpeak carries; analytic stays intelligible."""
    def words(n: int) -> str:
        if n <= 20:
            return ones[n]
        if n < 100:
            t, o = divmod(n, 10)
            return tens[t] + (" " + ones[o] if o else "")
        if n < 1000:
            h, r = divmod(n, 100)
            head = ones[h] + " " + hundred
            return head + (" " + words(r) if r else "")
        if n < 100_000:
            k, r = divmod(n, 1000)
            head = words(k) + " " + thousand
            return head + (" " + words(r) if r else "")
        lk, r = divmod(n, 100_000)
        head = words(lk) + " " + lakh
        return head + (" " + words(r) if r else "")

    if num < 0:
        return minus + " " + words(-num)
    return words(num)


def expand_numbers(text: str, number_words) -> str:
    """Replace integer literals with ``number_words(n)`` renderings —
    shared by every language pack's normalizer."""
    def _num(m: re.Match) -> str:
        try:
            return " " + number_words(int(m.group(0))) + " "
        except ValueError:
            return " "

    return re.sub(r"\d+", _num, text)


def normalize_text(text: str) -> str:
    """Expand numeric shapes (currency, ordinals, years, decimals via the
    English :class:`~sonata_tpu_torch.text.numerics.NumberGrammar`, then bare
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


def arabic_word_to_ipa(word: str) -> str:
    return "".join(_ARABIC.get(ch, "") for ch in word)


_AR_ONES = ["صفر", "واحد", "اثنان", "ثلاثة", "أربعة", "خمسة", "ستة",
            "سبعة", "ثمانية", "تسعة", "عشرة"]
_AR_TENS = ["", "عشرة", "عشرون", "ثلاثون", "أربعون", "خمسون",
            "ستون", "سبعون", "ثمانون", "تسعون"]
_AR_HUNDREDS = ["", "مئة", "مئتان", "ثلاثمئة", "أربعمئة", "خمسمئة",
                "ستمئة", "سبعمئة", "ثمانمئة", "تسعمئة"]


def arabic_number_to_words(num: int) -> str:
    """MSA numerals: ones before tens joined with و (ثلاثة وعشرون)."""
    if num < 0:
        return "سالب " + arabic_number_to_words(-num)
    if num <= 10:
        return _AR_ONES[num]
    if num < 20:
        o = num - 10
        head = "أحد" if o == 1 else ("اثنا" if o == 2 else _AR_ONES[o])
        return head + " عشر"
    if num < 100:
        t, o = divmod(num, 10)
        if o == 0:
            return _AR_TENS[t]
        return _AR_ONES[o] + " و" + _AR_TENS[t]
    if num < 1000:
        h, r = divmod(num, 100)
        head = _AR_HUNDREDS[h]
        return head + (" و" + arabic_number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        if k == 1:
            head = "ألف"
        elif k == 2:
            head = "ألفان"
        elif k <= 10:
            head = _AR_ONES[k] + " آلاف"
        else:
            head = arabic_number_to_words(k) + " ألف"
        return head + (" و" + arabic_number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    if m == 1:
        head = "مليون"
    elif m == 2:
        head = "مليونان"  # dual, like ألفان
    elif m <= 10:
        head = _AR_ONES[m] + " ملايين"  # 3-10 plural
    else:
        head = arabic_number_to_words(m) + " مليون"
    return head + (" و" + arabic_number_to_words(r) if r else "")


def normalize_text_ar(text: str) -> str:
    """Arabic normalizer: digits (ASCII or Arabic-Indic — \\d matches
    any Unicode Nd and int() parses them) become MSA number words; the
    generic English expansion fed the Arabic letter map English words,
    which mapped to silence."""
    return expand_numbers(text, arabic_number_to_words).lower()


def place_stress(units: list, flags: list, target: int, *,
                 liquids: tuple = ("r", "l"),
                 stops: tuple = tuple("pbtdkɡfv"),
                 s_cluster: bool = False,
                 stop_at_length: bool = False) -> str:
    """Insert the primary-stress mark before the syllable onset of the
    nucleus at unit index ``target``.

    Shared by the unit-scanner language packs (it/fr/pt/pl/tr/ro/nl):
    ``units`` are emitted phoneme strings, ``flags`` mark vowel units, so
    the mark can never split a multi-char phoneme.  The onset walk takes
    every consonant unit back to the previous nucleus, then splits
    over-long runs: an obstruent+liquid cluster (``liquids``/``stops``)
    may start the stressed syllable, ``s_cluster`` additionally allows
    s+stop onsets (and keeps bare word-internal s+C pairs whole), and
    ``stop_at_length`` treats a length-marked unit (Cː geminate) as the
    previous syllable's coda.  Word-initial clusters always stay whole.
    """
    onset = target
    while onset > 0 and not flags[onset - 1]:
        if stop_at_length and units[onset - 1].endswith("ː"):
            break
        onset -= 1
    if target - onset > 1 and onset > 0:
        run = units[onset:target]
        if run[-1] in liquids and run[-2] in stops:
            onset = target - 2
        elif s_cluster and run[-1] in ("p", "t", "k") and run[-2] == "s":
            onset = target - 2
        elif s_cluster and run[-2] in ("s", "z") and len(run) == 2:
            pass
        else:
            onset = target - 1
    return "".join(units[:onset]) + "ˈ" + "".join(units[onset:])


def _lazy(module: str, fn: str):
    """Deferred accessor into a language-pack module, so importing the
    registry never pays for packs the process doesn't use."""
    def call(arg: str) -> str:
        import importlib

        mod = importlib.import_module(f".{module}", __package__)
        return getattr(mod, fn)(arg)

    return call


# Language registry: language code → (normalizer, word→IPA).  The eSpeak
# backend covers ~100 languages via compiled dictionaries
# (reference: deps/dev/espeak-ng-data, espeak-phonemizer/build.rs:5-17);
# the hermetic backend supports exactly the languages listed here and
# REFUSES others rather than silently rendering them through English
# letter-to-sound rules (which produces confidently wrong phonemes).
_LANGUAGES: dict[str, tuple] = {
    "en": (normalize_text, english_word_to_ipa),
    "ar": (normalize_text_ar, arabic_word_to_ipa),
    "fa": (_lazy("rule_g2p_fa", "normalize_text"),
           _lazy("rule_g2p_fa", "word_to_ipa")),
    "ur": (_lazy("rule_g2p_fa", "normalize_text_ur"),  # shared script
           _lazy("rule_g2p_fa", "word_to_ipa_ur")),    # pack, Urdu
                                                       # numerals
    "de": (_lazy("rule_g2p_de", "normalize_text"),
           _lazy("rule_g2p_de", "word_to_ipa")),
    "es": (_lazy("rule_g2p_es", "normalize_text"),
           _lazy("rule_g2p_es", "word_to_ipa")),
    "it": (_lazy("rule_g2p_it", "normalize_text"),
           _lazy("rule_g2p_it", "word_to_ipa")),
    "fr": (_lazy("rule_g2p_fr", "normalize_text"),
           _lazy("rule_g2p_fr", "word_to_ipa")),
    "pt": (_lazy("rule_g2p_pt", "normalize_text"),
           _lazy("rule_g2p_pt", "word_to_ipa")),
    "pl": (_lazy("rule_g2p_pl", "normalize_text"),
           _lazy("rule_g2p_pl", "word_to_ipa")),
    "tr": (_lazy("rule_g2p_tr", "normalize_text"),
           _lazy("rule_g2p_tr", "word_to_ipa")),
    "ro": (_lazy("rule_g2p_ro", "normalize_text"),
           _lazy("rule_g2p_ro", "word_to_ipa")),
    "nl": (_lazy("rule_g2p_nl", "normalize_text"),
           _lazy("rule_g2p_nl", "word_to_ipa")),
    "cs": (_lazy("rule_g2p_cs", "normalize_text"),
           _lazy("rule_g2p_cs", "word_to_ipa")),
    "hu": (_lazy("rule_g2p_hu", "normalize_text"),
           _lazy("rule_g2p_hu", "word_to_ipa")),
    "ru": (_lazy("rule_g2p_ru", "normalize_text"),
           _lazy("rule_g2p_ru", "word_to_ipa")),
    "el": (_lazy("rule_g2p_el", "normalize_text"),
           _lazy("rule_g2p_el", "word_to_ipa")),
    "fi": (_lazy("rule_g2p_fi", "normalize_text"),
           _lazy("rule_g2p_fi", "word_to_ipa")),
    "id": (_lazy("rule_g2p_id", "normalize_text"),
           _lazy("rule_g2p_id", "word_to_ipa")),
    "ms": (_lazy("rule_g2p_id", "normalize_text_ms"),  # EYD spelling
           _lazy("rule_g2p_id", "word_to_ipa")),       # shared; Malay
                                                       # numerals differ
    "sw": (_lazy("rule_g2p_sw", "normalize_text"),
           _lazy("rule_g2p_sw", "word_to_ipa")),
    "sk": (_lazy("rule_g2p_sk", "normalize_text"),
           _lazy("rule_g2p_sk", "word_to_ipa")),
    "hr": (_lazy("rule_g2p_hr", "normalize_text"),
           _lazy("rule_g2p_hr", "word_to_ipa")),
    "sr": (_lazy("rule_g2p_hr", "normalize_text"),  # shared BCMS pack
           _lazy("rule_g2p_hr", "word_to_ipa")),
    "bs": (_lazy("rule_g2p_hr", "normalize_text"),
           _lazy("rule_g2p_hr", "word_to_ipa")),
    "uk": (_lazy("rule_g2p_uk", "normalize_text"),
           _lazy("rule_g2p_uk", "word_to_ipa")),
    "bg": (_lazy("rule_g2p_bg", "normalize_text"),
           _lazy("rule_g2p_bg", "word_to_ipa")),
    "sv": (_lazy("rule_g2p_sv", "normalize_text"),
           _lazy("rule_g2p_sv", "word_to_ipa")),
    "no": (_lazy("rule_g2p_no", "normalize_text"),
           _lazy("rule_g2p_no", "word_to_ipa")),
    "nb": (_lazy("rule_g2p_no", "normalize_text"),  # bokmål alias
           _lazy("rule_g2p_no", "word_to_ipa")),
    "da": (_lazy("rule_g2p_da", "normalize_text"),
           _lazy("rule_g2p_da", "word_to_ipa")),
    "is": (_lazy("rule_g2p_is", "normalize_text"),
           _lazy("rule_g2p_is", "word_to_ipa")),
    "sl": (_lazy("rule_g2p_sl", "normalize_text"),
           _lazy("rule_g2p_sl", "word_to_ipa")),
    "ca": (_lazy("rule_g2p_ca", "normalize_text"),
           _lazy("rule_g2p_ca", "word_to_ipa")),
    "cy": (_lazy("rule_g2p_cy", "normalize_text"),
           _lazy("rule_g2p_cy", "word_to_ipa")),
    "ka": (_lazy("rule_g2p_ka", "normalize_text"),
           _lazy("rule_g2p_ka", "word_to_ipa")),
    "kk": (_lazy("rule_g2p_kk", "normalize_text"),
           _lazy("rule_g2p_kk", "word_to_ipa")),
    "lb": (_lazy("rule_g2p_lb", "normalize_text"),
           _lazy("rule_g2p_lb", "word_to_ipa")),
    "vi": (_lazy("rule_g2p_vi", "normalize_text"),
           _lazy("rule_g2p_vi", "word_to_ipa")),
    "ne": (_lazy("rule_g2p_ne", "normalize_text"),
           _lazy("rule_g2p_ne", "word_to_ipa")),
    "zh": (_lazy("rule_g2p_zh", "normalize_text"),  # pinyin input;
           _lazy("rule_g2p_zh", "word_to_ipa")),    # hanzi raises
    "ko": (_lazy("rule_g2p_ko", "normalize_text"),
           _lazy("rule_g2p_ko", "word_to_ipa")),
    "hi": (_lazy("rule_g2p_hi", "normalize_text"),  # Devanagari via
           _lazy("rule_g2p_hi", "word_to_ipa")),    # the ne machinery
    "he": (_lazy("rule_g2p_he", "normalize_text"),
           _lazy("rule_g2p_he", "word_to_ipa")),
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

    Raises :class:`~sonata_tpu_torch.core.PhonemizationError` for languages the
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
