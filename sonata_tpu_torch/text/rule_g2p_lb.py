"""Luxembourgish letter-to-sound rules for the hermetic G2P backend.

Luxembourgish orthography is German-adjacent with its own diphthongs
(éi → ɜɪ kept broad as ej, ou → əʊ as ow, ue → uə, ie → iə, au/äi)
and the n-deletion sandhi left unapplied (word-level G2P) — the
reference gets Luxembourgish from eSpeak-ng's compiled ``lb_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``lb`` conventions.

Covered phenomena: the Lëtzebuergesch diphthongs, ë → ə, é before
ch/k as eː, sch → ʃ, ch → ɕ/x by context kept broad as ɕ, final
devoicing, initial-stress default with ge-/be- prefixes.
"""

from __future__ import annotations

_LEXICON: dict[str, str] = {
    "ech": "eɕ", "du": "du", "hien": "hiən", "si": "si", "mir": "miɐ",
    "dir": "diɐ", "an": "an", "op": "op", "mat": "mat", "fir": "fiɐ",
    "vun": "fun", "den": "dən", "dem": "dəm", "eng": "eŋ",
    "net": "nət", "dat": "dat", "wat": "vat", "wéi": "vej",
    "moien": "ˈmojən", "äddi": "ˈædi", "merci": "ˈmɛʁsi",
    "lëtzebuerg": "ˈlətsəbuəɕ", "jo": "jo", "nee": "neː",
    "gutt": "ɡut", "dag": "daːx",
}

_UNSTRESSED_PREFIXES = ("ge", "be")
_DEVOICE = {"b": "p", "d": "t", "ɡ": "k", "v": "f", "z": "s"}
_SIMPLE = {"b": "b", "c": "k", "d": "d", "f": "f", "h": "h",
           "j": "j", "k": "k", "l": "l", "m": "m", "n": "n",
           "p": "p", "q": "k", "r": "ʁ", "s": "s", "t": "t",
           "v": "f", "x": "ks"}


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

        if rest.startswith("sch"):
            emit("ʃ"); i += 3; continue
        if rest.startswith("ch"):
            emit("ɕ"); i += 2; continue
        if rest.startswith("éi"):
            emit("ej", True); i += 2; continue
        if rest.startswith("äi"):
            emit("æɪ", True); i += 2; continue
        if rest.startswith("ou"):
            emit("ow", True); i += 2; continue
        if rest.startswith("ue"):
            emit("uə", True); i += 2; continue
        if rest.startswith("ie"):
            emit("iə", True); i += 2; continue
        if rest.startswith("au"):
            emit("aʊ", True); i += 2; continue
        if rest.startswith("ei") or rest.startswith("ai"):
            emit("aɪ", True); i += 2; continue
        if rest.startswith("aa"):
            emit("aː", True); i += 2; continue
        if rest.startswith("ee"):
            emit("eː", True); i += 2; continue
        if rest.startswith("oo"):
            emit("oː", True); i += 2; continue
        if ch == "ë":
            emit("ə", True); i += 1; continue
        if ch == "é":
            emit("eː", True); i += 1; continue
        if ch == "ä":
            emit("æ", True); i += 1; continue
        if ch == "ö":
            emit("ø", True); i += 1; continue
        if ch == "ü":
            emit("y", True); i += 1; continue
        if ch == "w":
            emit("v"); i += 1; continue
        if ch == "g":
            if nxt == "g":
                emit("ɡ"); i += 2; continue
            emit("ɡ"); i += 1; continue
        if ch == "z":
            emit("ts"); i += 1; continue
        if ch in "aeiouy":
            emit({"y": "i"}.get(ch, ch), True)
            i += 1
            continue
        if ch in _SIMPLE:
            if nxt == ch:
                emit(_SIMPLE[ch]); i += 2; continue
            emit(_SIMPLE[ch])
        i += 1

    if out and out[-1] in _DEVOICE:
        out[-1] = _DEVOICE[out[-1]]
    return out, flags


def word_to_ipa(word: str) -> str:
    hit = _LEXICON.get(word)
    if hit is not None:
        return hit
    units, flags = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    ipa = "".join(units)
    if len(nuclei) < 2:
        return ipa
    first = 0
    for pfx in _UNSTRESSED_PREFIXES:
        if word.startswith(pfx) and len(word) > len(pfx) + 2:
            first = 1
            break
    if first >= len(nuclei):
        first = 0
    from .rule_g2p import place_stress

    return place_stress(units, flags, nuclei[first],
                        liquids=("ʁ", "l"))


_ONES = ["null", "eent", "zwee", "dräi", "véier", "fënnef", "sechs",
         "siwen", "aacht", "néng", "zéng", "eelef", "zwielef",
         "dräizéng", "véierzéng", "fofzéng", "siechzéng", "siwwenzéng",
         "uechtzéng", "nonnzéng"]
_TENS = ["", "", "zwanzeg", "drësseg", "véierzeg", "fofzeg",
         "sechzeg", "siwwenzeg", "achtzeg", "nonzeg"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "minus " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        if o == 0:
            return _TENS[t]
        one = "een" if o == 1 else _ONES[o]
        return one + "an" + _TENS[t]  # fënnefanzwanzeg
    if num < 1000:
        h, r = divmod(num, 100)
        head = "honnert" if h == 1 else _ONES[h] + "honnert"
        return head + (number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "dausend" if k == 1 else number_to_words(k) + "dausend"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("eng millioun" if m == 1
            else number_to_words(m) + " milliounen")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
