"""Finnish letter-to-sound rules for the hermetic G2P backend.

Finnish orthography is one of the most phonemic in the world — one
letter per phoneme, doubled letters for length, stress always on the
first syllable — the reference gets Finnish from eSpeak-ng's compiled
``fi_dict`` (``/root/reference/deps/dev/espeak-ng-data``); this is the
hermetic stand-in producing broad IPA in eSpeak ``fi`` conventions.

Covered phenomena: doubled vowels/consonants as length (Vː/Cː), the
front vowels ä/ö/y (æ/ø/y), ng → ŋː and nk → ŋk, and fixed initial
stress.
"""

from __future__ import annotations

_VOWELS = {"a": "ɑ", "e": "e", "i": "i", "o": "o", "u": "u",
           "y": "y", "ä": "æ", "ö": "ø", "å": "oː"}
_CONS = {"b": "b", "d": "d", "f": "f", "g": "ɡ", "h": "h", "j": "j",
         "k": "k", "l": "l", "m": "m", "n": "n", "p": "p", "r": "r",
         "s": "s", "t": "t", "v": "v", "w": "v", "z": "ts", "c": "k",
         "x": "ks", "š": "ʃ", "ž": "ʒ"}


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
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""
        if ch == "n" and nxt == "g":
            emit("ŋː"); i += 2; continue
        if ch == "n" and nxt == "k":
            emit("ŋ"); emit("k"); i += 2; continue
        v = _VOWELS.get(ch)
        if v is not None:
            if nxt == ch:  # doubled vowel → long
                emit(v + "ː", True)
                i += 2
                continue
            emit(v, True)
            i += 1
            continue
        c = _CONS.get(ch)
        if c is not None:
            if nxt == ch:  # doubled consonant → long
                emit(c + "ː")
                i += 2
                continue
            emit(c)
        i += 1
    return out, flags


def word_to_ipa(word: str) -> str:
    units, flags = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    ipa = "".join(units)
    if len(nuclei) < 2:
        return ipa
    from .rule_g2p import place_stress

    return place_stress(units, flags, nuclei[0])  # fixed initial stress


_ONES = ["nolla", "yksi", "kaksi", "kolme", "neljä", "viisi", "kuusi",
         "seitsemän", "kahdeksan", "yhdeksän", "kymmenen"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "miinus " + number_to_words(-num)
    if num <= 10:
        return _ONES[num]
    if num < 20:
        return _ONES[num - 10] + "toista"
    if num < 100:
        t, o = divmod(num, 10)
        head = _ONES[t] + "kymmentä"
        return head + (_ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = "sata" if h == 1 else _ONES[h] + "sataa"
        return head + (number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "tuhat" if k == 1 else number_to_words(k) + "tuhatta"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("miljoona" if m == 1
            else number_to_words(m) + " miljoonaa")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
