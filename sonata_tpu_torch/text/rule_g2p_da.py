"""Danish letter-to-sound rules for the hermetic G2P backend.

Danish is the least phonemic Nordic orthography (lenited d/g, stød,
extensive vowel allophony), so this pack aims for an intelligible
broad rendering rather than narrow accuracy: soft d → ð, soft g
dropped or → j, r → ʁ (vocalizing finally to ɐ̯ kept broad as ɐ),
the æ/ø/å system, and a function-word lexicon for the irregular core —
the reference gets Danish from eSpeak-ng's compiled ``da_dict``
(``/root/reference/deps/dev/espeak-ng-data``); stød is not marked
(eSpeak's broad IPA output omits it too).

Covered phenomena: intervocalic/final d → ð, final -ig → i, af/av →
ɑw, ej/aj → ɑj, øj → ɔj, soft g after vowels, initial-stress default
with be-/for- prefixes.
"""

from __future__ import annotations

_LEXICON: dict[str, str] = {
    "og": "ɔw", "jeg": "jɑj", "det": "deː", "er": "æɐ", "en": "eːn",
    "et": "ed", "ikke": "ˈeɡə", "som": "sɔm", "på": "pɔː",
    "med": "mɛð", "til": "te", "af": "æː", "har": "hɑː",
    "de": "diː", "du": "duː", "vi": "viː", "han": "han", "hun": "hun",
    "hvad": "væð", "hvor": "vɔː", "så": "sɔː", "men": "mɛn",
    "danmark": "ˈdanmɑːɡ", "dansk": "dansɡ", "hej": "hɑj",
    "tak": "taɡ", "god": "ɡoːð", "dag": "dæː", "mange": "ˈmaŋə",
    "mig": "mɑj", "dig": "dɑj", "ja": "ja", "nej": "nɑj",
}

_UNSTRESSED_PREFIXES = ("be", "for")

_VOWELS = "aeiouyæøå"


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
        prev = word[i - 1] if i > 0 else ""

        if rest.startswith("hv"):
            emit("v"); i += 2; continue  # silent h: hvordan → vordan
        if rest.startswith("ig") and i + 2 == n:
            emit("i", True); i += 2; continue  # final -ig → i
        if rest.startswith("ej") or rest.startswith("aj"):
            emit("ɑj", True); i += 2; continue
        if rest.startswith("øj"):
            emit("ɔj", True); i += 2; continue
        if rest.startswith("av") or rest.startswith("af"):
            after = word[i + 2] if i + 2 < n else ""
            if not after or after not in _VOWELS:
                emit("ɑw", True); i += 2; continue
        if ch == "d":
            # soft d after a vowel (intervocalic or final): ð
            if prev and prev in _VOWELS and (not nxt or nxt in _VOWELS
                                             or i + 1 == n):
                emit("ð")
            elif nxt == "d":
                emit("ð"); i += 1  # dd → ð (hedde)
            else:
                emit("d")
            i += 1
            continue
        if ch == "g":
            # soft g after a vowel weakens; broad: drop finally, j
            # between vowels
            if prev and prev in _VOWELS and i + 1 == n:
                i += 1
                continue
            if prev and prev in _VOWELS and nxt and nxt in _VOWELS:
                emit("j"); i += 1; continue
            if nxt == "g":
                emit("ɡ"); i += 2; continue  # gg collapses (hygge)
            emit("ɡ"); i += 1; continue
        if ch == "r":
            emit("ʁ" if (not prev or prev not in _VOWELS) else "ɐ")
            i += 1
            continue
        if ch == "å":
            emit("ɔː", True); i += 1; continue
        if ch == "æ":
            emit("ɛː", True); i += 1; continue
        if ch == "ø":
            emit("øː", True); i += 1; continue
        if ch == "e":
            if i + 1 == n and n > 2:
                emit("ə", True)
            else:
                emit("eː" if not nxt or nxt in _VOWELS else "ɛ", True)
            i += 1
            continue
        if ch == "a":
            emit("æː" if (nxt and nxt in _VOWELS) or i + 1 == n
                 else "a", True)
            i += 1
            continue
        if ch in "iouy":
            base = {"i": "i", "o": "o", "u": "u", "y": "y"}[ch]
            emit(base + ("ː" if i + 1 == n else ""), True)
            i += 1
            continue
        simple = {"b": "b", "c": "s", "f": "f", "h": "h", "j": "j",
                  "k": "k", "l": "l", "m": "m", "n": "n", "p": "p",
                  "q": "k", "s": "s", "t": "t", "v": "v", "w": "v",
                  "x": "ks", "z": "s"}
        if ch in simple:
            if nxt == ch:
                emit(simple[ch]); i += 2; continue
            emit(simple[ch])
        i += 1
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

    return place_stress(units, flags, nuclei[first], liquids=("ʁ", "l"))


_ONES = ["nul", "en", "to", "tre", "fire", "fem", "seks", "syv",
         "otte", "ni", "ti", "elleve", "tolv", "tretten", "fjorten",
         "femten", "seksten", "sytten", "atten", "nitten"]
_TENS = ["", "", "tyve", "tredive", "fyrre", "halvtreds", "tres",
         "halvfjerds", "firs", "halvfems"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "minus " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        if o == 0:
            return _TENS[t]
        return _ONES[o] + "og" + _TENS[t]  # femogtyve
    if num < 1000:
        h, r = divmod(num, 100)
        head = "hundrede" if h == 1 else _ONES[h] + " hundrede"
        return head + (" og " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "tusind" if k == 1 else number_to_words(k) + " tusind"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("en million" if m == 1
            else number_to_words(m) + " millioner")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
