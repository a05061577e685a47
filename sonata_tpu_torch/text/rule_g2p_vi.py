"""Vietnamese (northern) letter-to-sound rules for the hermetic G2P.

Vietnamese is monosyllabic-orthography tonal: every written syllable
carries one of six tones as a diacritic, stacked on top of the vowel-
quality diacritics (ê ô ơ ă â ư).  This pack NFD-decomposes each
syllable, recomposes the quality marks into their letters, extracts
the tone mark, scans onset/nucleus/coda with northern (Hanoi) values
(d/gi/r → z, s/x → s, tr/ch → tʃ), and appends the tone as a Chao
tone-letter string — the reference gets Vietnamese from eSpeak-ng's
compiled ``vi_dict`` (``/root/reference/deps/dev/espeak-ng-data``).

Tone renderings (Chao letters, broad): ngang ˧, huyền ˨˩, sắc ˧˥,
hỏi ˧˩˧, ngã ˧ˀ˥, nặng ˨˩ˀ.
"""

from __future__ import annotations

import unicodedata

# combining marks: tones vs vowel quality
_TONE_MARKS = {"̀": "˨˩", "́": "˧˥", "̉": "˧˩˧",
               "̃": "˧ˀ˥", "̣": "˨˩ˀ"}
_QUALITY_MARKS = {"̂", "̆", "̛"}  # ^ ˘ horn

_ONSETS = [
    ("ngh", "ŋ"), ("ng", "ŋ"), ("nh", "ɲ"), ("gh", "ɣ"), ("gi", "z"),
    ("kh", "x"), ("ph", "f"), ("qu", "kw"), ("th", "tʰ"), ("tr", "tʃ"),
    ("ch", "tʃ"), ("b", "ɓ"), ("c", "k"), ("d", "z"), ("đ", "ɗ"),
    ("g", "ɣ"), ("h", "h"), ("k", "k"), ("l", "l"), ("m", "m"),
    ("n", "n"), ("p", "p"), ("r", "z"), ("s", "s"), ("t", "t"),
    ("v", "v"), ("x", "s"),
]

# nucleus spellings, longest first (after tone extraction/recompose)
_NUCLEI = [
    ("iê", "iə"), ("yê", "iə"), ("uô", "uə"), ("ươ", "ɯə"),
    ("ia", "iə"), ("ya", "iə"), ("ua", "uə"), ("ưa", "ɯə"),
    ("a", "aː"), ("ă", "a"), ("â", "ə"), ("e", "ɛ"), ("ê", "e"),
    ("i", "i"), ("o", "ɔ"), ("ô", "o"), ("ơ", "əː"), ("u", "u"),
    ("ư", "ɯ"), ("y", "i"),
]

_VOWEL_LETTERS = "aăâeêioôơuưy"

_CODAS = [
    ("ch", "k"), ("ng", "ŋ"), ("nh", "ɲ"), ("c", "k"), ("m", "m"),
    ("n", "n"), ("p", "p"), ("t", "t"), ("i", "j"), ("y", "j"),
    ("o", "w"), ("u", "w"),
]


def _strip_tone(syllable: str) -> tuple[str, str]:
    """NFD-decompose, pull out the tone mark, recompose quality marks.
    Returns (toneless_syllable, chao_tone_string)."""
    tone = "˧"  # ngang default
    out_chars: list[str] = []
    for ch in unicodedata.normalize("NFD", syllable):
        t = _TONE_MARKS.get(ch)
        if t is not None:
            tone = t
            continue
        out_chars.append(ch)
    return unicodedata.normalize("NFC", "".join(out_chars)), tone


def word_to_ipa(word: str) -> str:
    """One written word = one syllable (Vietnamese compounds arrive as
    separate tokens)."""
    syl, tone = _strip_tone(word)
    out: list[str] = []
    i = 0
    n = len(syl)
    for spelling, ipa in _ONSETS:
        if syl.startswith(spelling):
            if spelling == "gi" and (n == 2 or
                                     syl[2] not in _VOWEL_LETTERS):
                # the i doubles as the nucleus: gì → zi, gìn → zin
                out.append("z")
                i = 1
                break
            out.append(ipa)
            i = len(spelling)
            break
    # medial glide: o/u before a vowel that does not form a nucleus
    # digraph (hoa → hwaː, tuần → twən; mua keeps its uə nucleus)
    rest = syl[i:]
    if len(rest) >= 2 and rest[0] in "ou" and \
            rest[1] in _VOWEL_LETTERS and \
            not any(rest.startswith(s) for s, _ in _NUCLEI if len(s) > 1):
        out.append("w")
        i += 1
    # nucleus
    rest = syl[i:]
    matched = False
    for spelling, ipa in _NUCLEI:
        if rest.startswith(spelling):
            out.append(ipa)
            i += len(spelling)
            matched = True
            break
    if not matched and i < n:
        # unknown leading char: skip it defensively
        i += 1
    # coda
    rest = syl[i:]
    for spelling, ipa in _CODAS:
        if rest == spelling:
            out.append(ipa)
            i += len(spelling)
            break
    return "".join(out) + tone if out else ""


_DIGITS = ["không", "một", "hai", "ba", "bốn", "năm", "sáu", "bảy",
           "tám", "chín"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "âm " + number_to_words(-num)
    if num < 10:
        return _DIGITS[num]
    if num < 20:
        o = num - 10
        tail = "lăm" if o == 5 else _DIGITS[o]
        return "mười" + (" " + tail if o else "")
    if num < 100:
        t, o = divmod(num, 10)
        head = _DIGITS[t] + " mươi"
        if o == 0:
            return head
        tail = {1: "mốt", 5: "lăm"}.get(o, _DIGITS[o])
        return head + " " + tail
    if num < 1000:
        h, r = divmod(num, 100)
        head = _DIGITS[h] + " trăm"
        if r == 0:
            return head
        if r < 10:
            return head + " lẻ " + _DIGITS[r]
        return head + " " + number_to_words(r)
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = number_to_words(k) + " nghìn"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = number_to_words(m) + " triệu"
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
