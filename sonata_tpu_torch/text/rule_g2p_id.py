"""Indonesian/Malay letter-to-sound rules for the hermetic G2P backend.

Indonesian orthography (EYD) is phonemically regular — the reference
gets Indonesian from eSpeak-ng's compiled ``id_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``id`` conventions.

Covered phenomena: the digraphs ng → ŋ, ny → ɲ, sy → ʃ, kh → x,
c → tʃ and j → dʒ, final k as glottal stop kept broad as k, e as
schwa vs é kept broad (ə in affix syllables, e elsewhere), and the
penultimate default stress (skipping a schwa penult).
"""

from __future__ import annotations

_CONS = {"b": "b", "c": "tʃ", "d": "d", "f": "f", "g": "ɡ", "h": "h",
         "j": "dʒ", "k": "k", "l": "l", "m": "m", "n": "n", "p": "p",
         "q": "k", "r": "r", "s": "s", "t": "t", "v": "f", "w": "w",
         "x": "ks", "y": "j", "z": "z"}

# common prefixes whose e is schwa
_SCHWA_PREFIXES = ("me", "be", "te", "se", "ke", "pe")


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
        if rest.startswith("ng"):
            emit("ŋ"); i += 2; continue
        if rest.startswith("ny"):
            emit("ɲ"); i += 2; continue
        if rest.startswith("sy"):
            emit("ʃ"); i += 2; continue
        if rest.startswith("kh"):
            emit("x"); i += 2; continue
        if ch == "e":
            # written e is ambiguous between ə and e; ə dominates in
            # non-final syllables (and all the me-/be-/se- affixes),
            # e in the final syllable — the broad heuristic eSpeak's
            # dictionary resolves per-word
            emit("ə" if i < n - 2 else "e", True)
            i += 1
            continue
        if ch == "é":
            emit("e", True); i += 1; continue
        if ch in "aiou":
            emit(ch, True); i += 1; continue
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
    target = nuclei[-2]
    if units[target] == "ə":
        target = nuclei[-1]  # schwa penult passes stress to the final
    from .rule_g2p import place_stress

    return place_stress(units, flags, target)


_ONES = ["nol", "satu", "dua", "tiga", "empat", "lima", "enam",
         "tujuh", "delapan", "sembilan"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "minus " + number_to_words(-num)
    if num < 10:
        return _ONES[num]
    if num == 10:
        return "sepuluh"
    if num == 11:
        return "sebelas"
    if num < 20:
        return _ONES[num - 10] + " belas"
    if num < 100:
        t, o = divmod(num, 10)
        return _ONES[t] + " puluh" + (" " + _ONES[o] if o else "")
    if num < 200:
        return "seratus" + (" " + number_to_words(num - 100)
                            if num > 100 else "")
    if num < 1000:
        h, r = divmod(num, 100)
        return _ONES[h] + " ratus" + (" " + number_to_words(r)
                                      if r else "")
    if num < 2000:
        return "seribu" + (" " + number_to_words(num - 1000)
                           if num > 1000 else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        return number_to_words(k) + " ribu" + (" " + number_to_words(r)
                                               if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("satu juta" if m == 1
            else number_to_words(m) + " juta")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()


def number_to_words_ms(num: int) -> str:
    """Malay numerals: EYD spelling is shared with Indonesian but a few
    number words differ lexically (lapan vs delapan, kosong vs nol)."""
    words = number_to_words(num)
    return (words.replace("delapan", "lapan")
            .replace("nol", "kosong"))


def normalize_text_ms(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words_ms).lower()
