"""Serbo-Croatian (hr/sr/bs Latin script) letter-to-sound rules.

The BCMS standard languages share a fully phonemic Latin orthography
(Gaj's alphabet; Serbian Cyrillic transliterates 1:1) — the reference
gets them from eSpeak-ng's compiled ``hr_dict``/``sr_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak conventions.  The pitch-accent
system is reduced to plain initial stress (accent never falls on the
final syllable; word-initial is the dominant default).

Covered phenomena: č/ć as tʃ/tɕ, đ → dʑ, dž → dʒ, š/ž, lj → ʎ,
nj → ɲ, c → ts, syllabic r, and initial stress.
"""

from __future__ import annotations

_CONS = {"b": "b", "c": "ts", "d": "d", "f": "f", "g": "ɡ", "h": "x",
         "j": "j", "k": "k", "l": "l", "m": "m", "n": "n", "p": "p",
         "r": "r", "s": "s", "t": "t", "v": "v", "z": "z",
         "č": "tʃ", "ć": "tɕ", "đ": "dʑ", "š": "ʃ", "ž": "ʒ"}

# Serbian Cyrillic → Gaj's Latin, 1:1 by design (vukovica); the digraph
# letters љ/њ/џ map to their Latin digraphs so one scanner serves both
# scripts
_CYRILLIC = {"а": "a", "б": "b", "в": "v", "г": "g", "д": "d",
             "ђ": "đ", "е": "e", "ж": "ž", "з": "z", "и": "i",
             "ј": "j", "к": "k", "л": "l", "љ": "lj", "м": "m",
             "н": "n", "њ": "nj", "о": "o", "п": "p", "р": "r",
             "с": "s", "т": "t", "ћ": "ć", "у": "u", "ф": "f",
             "х": "h", "ц": "c", "ч": "č", "џ": "dž", "ш": "š"}


def _scan(word: str) -> tuple[list[str], list[bool]]:
    """Scan one lowercase word → (units, vowel_flags).  A syllabic r
    (between consonants: prst) counts as a nucleus."""
    out: list[str] = []
    flags: list[bool] = []
    i = 0
    n = len(word)

    def emit(s: str, vowel: bool = False) -> None:
        out.append(s)
        flags.append(vowel)

    while i < n:
        rest = word[i:]
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""
        prev = word[i - 1] if i > 0 else ""

        if rest.startswith("lj"):
            emit("ʎ"); i += 2; continue
        if rest.startswith("nj"):
            emit("ɲ"); i += 2; continue
        if rest.startswith("dž"):
            emit("dʒ"); i += 2; continue
        if ch == "r":
            # syllabic r between consonants (or word edge + consonant)
            prev_c = not prev or prev not in "aeiou"
            next_c = not nxt or nxt not in "aeiou"
            if prev_c and next_c:
                emit("r", True)  # nucleus: prst → pr̩st (broad r)
            else:
                emit("r")
            i += 1
            continue
        if ch in "aeiou":
            emit(ch, True); i += 1; continue
        c = _CONS.get(ch)
        if c is not None:
            emit(c)
        i += 1
    return out, flags


def word_to_ipa(word: str) -> str:
    if any(ch in _CYRILLIC for ch in word):
        word = "".join(_CYRILLIC.get(ch, ch) for ch in word)
    units, flags = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    ipa = "".join(units)
    if len(nuclei) < 2:
        return ipa
    from .rule_g2p import place_stress

    return place_stress(units, flags, nuclei[0])  # initial default


_ONES = ["nula", "jedan", "dva", "tri", "četiri", "pet", "šest",
         "sedam", "osam", "devet", "deset", "jedanaest", "dvanaest",
         "trinaest", "četrnaest", "petnaest", "šesnaest", "sedamnaest",
         "osamnaest", "devetnaest"]
_TENS = ["", "", "dvadeset", "trideset", "četrdeset", "pedeset",
         "šezdeset", "sedamdeset", "osamdeset", "devedeset"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "minus " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" i " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = "sto" if h == 1 else ("dvjesto" if h == 2
                                     else _ONES[h] + "sto")
        return head + (" " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        if k == 1:
            head = "tisuću"
        else:
            kw = number_to_words(k)
            # tisuća is feminine: jedan/dva agree as jedna/dvije
            if kw.endswith("jedan"):
                kw = kw[:-5] + "jedna"
            elif kw.endswith("dva"):
                kw = kw[:-3] + "dvije"
            if k % 10 in (2, 3, 4) and k % 100 not in (12, 13, 14):
                head = kw + " tisuće"  # paucal
            else:
                head = kw + " tisuća"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("milijun" if m == 1
            else number_to_words(m) + " milijuna")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
