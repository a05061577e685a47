"""Slovak letter-to-sound rules for the hermetic G2P backend.

Slovak shares Czech's phonemic háček orthography and fixed initial
stress, with its own letters (ä, ô, ĺ/ŕ, ľ, dž) and a broader
softening rule (de/te/ne/le soften as well as di/ti/ni/li) — the
reference gets Slovak from eSpeak-ng's compiled ``sk_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``sk`` conventions.

Covered phenomena: háček consonants (č š ž dž, ď ť ň ľ), the
de/te/ne/le + di/ti/ni/li softening, ô → uo diphthong, ä → æ
(conservative), long vowels and syllabic ĺ/ŕ, ch → x, h → ɦ,
word-final obstruent devoicing, and fixed initial stress.
"""

from __future__ import annotations

_DEVOICE = {"b": "p", "d": "t", "ɟ": "c", "ɡ": "k", "v": "f",
            "z": "s", "ʒ": "ʃ", "ɦ": "x", "dʒ": "tʃ", "dz": "ts"}

_SOFT = {"d": "ɟ", "t": "c", "n": "ɲ", "l": "ʎ"}


def _scan(word: str) -> tuple[list[str], list[bool]]:
    """Scan one lowercase word → (units, vowel_flags)."""
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

        if rest.startswith("dž"):
            emit("dʒ"); i += 2; continue
        if rest.startswith("dz"):
            emit("dz"); i += 2; continue
        if rest.startswith("ch"):
            emit("x"); i += 2; continue
        # softening: d/t/n/l before e/i/í (native words)
        if ch in _SOFT and nxt and nxt in "eií":
            emit(_SOFT[ch])
            i += 1
            continue
        if ch == "č":
            emit("tʃ"); i += 1; continue
        if ch == "š":
            emit("ʃ"); i += 1; continue
        if ch == "ž":
            emit("ʒ"); i += 1; continue
        if ch == "ď":
            emit("ɟ"); i += 1; continue
        if ch == "ť":
            emit("c"); i += 1; continue
        if ch == "ň":
            emit("ɲ"); i += 1; continue
        if ch == "ľ":
            emit("ʎ"); i += 1; continue
        if ch == "ô":
            emit("uo", True); i += 1; continue
        if ch == "ä":
            emit("æ", True); i += 1; continue
        if ch == "h":
            emit("ɦ"); i += 1; continue
        if ch == "c":
            emit("ts"); i += 1; continue
        if ch == "j":
            emit("j"); i += 1; continue
        if ch == "y":
            emit("i", True); i += 1; continue
        if ch == "ý":
            emit("iː", True); i += 1; continue
        if ch in "áéíóú":
            base = {"á": "a", "é": "e", "í": "i", "ó": "o",
                    "ú": "u"}[ch]
            emit(base + "ː", True); i += 1; continue
        if ch == "ĺ":
            emit("lː", True); i += 1; continue  # long syllabic l nucleus
        if ch == "ŕ":
            emit("rː", True); i += 1; continue  # long syllabic r nucleus
        if ch in "aeiou":
            emit(ch, True); i += 1; continue
        if ch in "lr":
            # short syllabic liquid between consonants (prst, vlk)
            prev = word[i - 1] if i > 0 else ""
            cons_before = not prev or prev not in "aeiouáéíóúyýôä"
            cons_after = not nxt or nxt not in "aeiouáéíóúyýôä"
            emit(ch, cons_before and cons_after)
            i += 1
            continue
        simple = {"b": "b", "d": "d", "f": "f", "g": "ɡ", "k": "k",
                  "m": "m", "n": "n", "p": "p",
                  "s": "s", "t": "t", "v": "v", "w": "v", "x": "ks",
                  "z": "z"}
        if ch in simple:
            emit(simple[ch])
        i += 1

    # regressive final-cluster devoicing (dážď → daːʃc), like the bg pack
    k = len(out) - 1
    while k >= 0 and not flags[k] and out[k] in _DEVOICE:
        out[k] = _DEVOICE[out[k]]
        k -= 1
    return out, flags


def word_to_ipa(word: str) -> str:
    units, flags = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    ipa = "".join(units)
    if len(nuclei) < 2:
        return ipa
    from .rule_g2p import place_stress

    return place_stress(units, flags, nuclei[0])  # fixed initial stress


_ONES = ["nula", "jeden", "dva", "tri", "štyri", "päť", "šesť",
         "sedem", "osem", "deväť", "desať", "jedenásť", "dvanásť",
         "trinásť", "štrnásť", "pätnásť", "šestnásť", "sedemnásť",
         "osemnásť", "devätnásť"]
_TENS = ["", "", "dvadsať", "tridsať", "štyridsať", "päťdesiat",
         "šesťdesiat", "sedemdesiat", "osemdesiat", "deväťdesiat"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "mínus " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = "sto" if h == 1 else ("dvesto" if h == 2
                                     else _ONES[h] + "sto")
        return head + (" " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        if k == 1:
            head = "tisíc"
        elif k == 2:
            head = "dvetisíc"  # dva → dve before tisíc, joined
        elif k < 10:
            head = _ONES[k] + "tisíc"
        else:
            head = number_to_words(k) + " tisíc"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    if m == 1:
        head = "milión"
    elif m in (2, 3, 4):
        head = number_to_words(m) + " milióny"
    else:
        head = number_to_words(m) + " miliónov"
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
