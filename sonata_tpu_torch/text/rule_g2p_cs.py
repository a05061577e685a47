"""Czech letter-to-sound rules for the hermetic G2P backend.

Czech orthography is phonemic (the háček system was designed for it)
and stress is fixed word-initial, so a rule table reaches dictionary
quality — the reference gets Czech from eSpeak-ng's compiled
``cs_dict`` (``/root/reference/deps/dev/espeak-ng-data``); this is the
hermetic stand-in producing broad IPA in eSpeak ``cs`` conventions.

Covered phenomena: háček consonants (č ř š ž ď ť ň), vowel length via
čárka/kroužek (á é í ó ú ů → Vː), the ě softening vowel (dě/tě/ně →
ɟɛ/cɛ/ɲɛ, bě/pě/vě → bjɛ/pjɛ/vjɛ, mě → mɲɛ), di/ti/ni softening,
ch → x, the syllabic liquids kept broad (r/l), word-final obstruent
devoicing, voicing assimilation left broad, and fixed initial stress.
"""

from __future__ import annotations

_DEVOICE = {"b": "p", "d": "t", "ɟ": "c", "ɡ": "k", "v": "f",
            "z": "s", "ʒ": "ʃ", "ɦ": "x", "r̝": "r̝̊"}

_SOFT = {"d": "ɟ", "t": "c", "n": "ɲ"}


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

        if rest.startswith("ch"):
            emit("x"); i += 2; continue
        # softening ě: dě/tě/ně → soft C + ɛ; bě/pě/vě → Cjɛ; mě → mɲɛ
        if nxt == "ě":
            if ch in _SOFT:
                emit(_SOFT[ch]); emit("ɛ", True); i += 2; continue
            if ch in "bpvf":
                emit(ch); emit("j"); emit("ɛ", True); i += 2; continue
            if ch == "m":
                emit("m"); emit("ɲ"); emit("ɛ", True); i += 2; continue
        # di/ti/ni soften (dívka → ɟiːfka)
        if ch in _SOFT and nxt and nxt in "ií":
            emit(_SOFT[ch])
            i += 1
            continue
        if ch == "č":
            emit("tʃ"); i += 1; continue
        if ch == "ř":
            emit("r̝"); i += 1; continue
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
        if ch == "h":
            emit("ɦ"); i += 1; continue
        if ch == "c":
            emit("ts"); i += 1; continue
        if ch == "j":
            emit("j"); i += 1; continue
        if ch == "ě":
            emit("jɛ", True); i += 1; continue  # after other consonants
        if ch in "áéíóúůý":
            base = {"á": "a", "é": "ɛ", "í": "i", "ó": "o", "ú": "u",
                    "ů": "u", "ý": "i"}[ch]
            emit(base + "ː", True); i += 1; continue
        if ch == "e":
            emit("ɛ", True); i += 1; continue
        if ch == "y":
            emit("i", True); i += 1; continue
        if ch in "aiou":
            emit(ch, True); i += 1; continue
        simple = {"b": "b", "d": "d", "f": "f", "g": "ɡ", "k": "k",
                  "l": "l", "m": "m", "n": "n", "p": "p", "r": "r",
                  "s": "s", "t": "t", "v": "v", "w": "v", "x": "ks",
                  "z": "z"}
        if ch in simple:
            emit(simple[ch])
        i += 1

    if out and out[-1] in _DEVOICE:
        out[-1] = _DEVOICE[out[-1]]
    return out, flags


def word_to_ipa(word: str) -> str:
    units, flags = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    ipa = "".join(units)
    if len(nuclei) < 2:
        return ipa
    # fixed initial stress: mark is only informative at position 0 when
    # an onset precedes the first nucleus
    from .rule_g2p import place_stress

    return place_stress(units, flags, nuclei[0])


_ONES = ["nula", "jedna", "dva", "tři", "čtyři", "pět", "šest", "sedm",
         "osm", "devět", "deset", "jedenáct", "dvanáct", "třináct",
         "čtrnáct", "patnáct", "šestnáct", "sedmnáct", "osmnáct",
         "devatenáct"]
_TENS = ["", "", "dvacet", "třicet", "čtyřicet", "padesát", "šedesát",
         "sedmdesát", "osmdesát", "devadesát"]
_HUNDREDS = ["", "sto", "dvě stě", "tři sta", "čtyři sta", "pět set",
             "šest set", "sedm set", "osm set", "devět set"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "minus " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        return _HUNDREDS[h] + (" " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        if k == 1:
            head = "tisíc"
        elif k in (2, 3, 4):
            head = number_to_words(k) + " tisíce"
        else:
            head = number_to_words(k) + " tisíc"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    if m == 1:
        head = "milion"
    elif m in (2, 3, 4):
        head = number_to_words(m) + " miliony"
    else:
        head = number_to_words(m) + " milionů"
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
