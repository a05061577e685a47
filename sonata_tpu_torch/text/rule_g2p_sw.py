"""Swahili letter-to-sound rules for the hermetic G2P backend.

Swahili orthography is fully regular with fixed penultimate stress —
the reference gets Swahili from eSpeak-ng's compiled ``sw_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``sw`` conventions.

Covered phenomena: the digraphs (ch → tʃ, sh → ʃ, ny → ɲ, ng' → ŋ,
th → θ, dh → ð, gh → ɣ, kh → x), j → dʒ, y → j, every vowel a
syllable nucleus (no diphthongs), and fixed penultimate stress.
"""

from __future__ import annotations

_DIGRAPHS = [("ng'", "ŋ"), ("ch", "tʃ"), ("sh", "ʃ"), ("ny", "ɲ"),
             ("th", "θ"), ("dh", "ð"), ("gh", "ɣ"), ("kh", "x")]

_CONS = {"b": "b", "d": "d", "f": "f", "g": "ɡ", "h": "h", "j": "dʒ",
         "k": "k", "l": "l", "m": "m", "n": "n", "p": "p", "r": "r",
         "s": "s", "t": "t", "v": "v", "w": "w", "y": "j", "z": "z"}


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
        hit = False
        for spelling, ipa in _DIGRAPHS:
            if rest.startswith(spelling):
                emit(ipa)
                i += len(spelling)
                hit = True
                break
        if hit:
            continue
        ch = word[i]
        if ch in "aeiou":
            emit(ch, True)  # every vowel is its own syllable nucleus
            i += 1
            continue
        c = _CONS.get(ch)
        if c is not None:
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

    return place_stress(units, flags, nuclei[-2])  # fixed penultimate


_ONES = ["sifuri", "moja", "mbili", "tatu", "nne", "tano", "sita",
         "saba", "nane", "tisa", "kumi"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "kasoro " + number_to_words(-num)
    if num <= 10:
        return _ONES[num]
    if num < 20:
        return "kumi na " + _ONES[num - 10]
    if num < 100:
        t, o = divmod(num, 10)
        head = ("ishirini" if t == 2 else "thelathini" if t == 3
                else "arobaini" if t == 4 else "hamsini" if t == 5
                else "sitini" if t == 6 else "sabini" if t == 7
                else "themanini" if t == 8 else "tisini")
        return head + (" na " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = "mia " + _ONES[h] if h > 1 else "mia moja"
        return head + (" na " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = ("elfu " + number_to_words(k)) if k > 1 else "elfu moja"
        return head + (" na " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = "milioni " + number_to_words(m)
    return head + (" na " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    # typographic apostrophes → ASCII so ng' survives tokenization
    text = text.replace("’", "'").replace("ʼ", "'")
    return expand_numbers(text, number_to_words).lower()
