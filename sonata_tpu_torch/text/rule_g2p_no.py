"""Norwegian (bokmål) letter-to-sound rules for the hermetic G2P.

Norwegian orthography parallels Swedish (soft k/g/sk before front
vowels, length by syllable structure) with its own spellings (kj/skj,
øy/au/ei diphthongs, æ/ø/å); the pitch accents reduce to plain
stress — the reference gets Norwegian from eSpeak-ng's compiled
``no_dict`` (``/root/reference/deps/dev/espeak-ng-data``); this is the
hermetic stand-in producing broad IPA in eSpeak ``nb`` conventions.

Covered phenomena: kj/tj → ç, skj/sj → ʃ, soft k/g/sk before front
vowels, the ei/øy/au diphthongs, silent d in -rd/ld/nd and final -t in
the -et suffix kept broad (pronounced), o → u-ish kept as uː/ɔ, and
initial-stress default with be-/for- unstressed prefixes.
"""

from __future__ import annotations

_LEXICON: dict[str, str] = {
    "og": "ɔ", "jeg": "jæɪ", "det": "deː", "er": "æːr", "en": "eːn",
    "et": "ɛt", "ikke": "ˈɪkɛ", "som": "sɔm", "på": "poː",
    "med": "meː", "til": "tɪl", "av": "ɑːv", "har": "hɑːr",
    "de": "diː", "du": "dʉː", "vi": "viː", "han": "han", "hun": "hʉn",
    "hva": "vɑː", "når": "nɔr", "så": "soː", "men": "mɛn",
    "norge": "ˈnɔrɡɛ", "norsk": "nɔʃk", "hei": "hæɪ", "takk": "tak",
    "bra": "brɑː", "dag": "dɑːɡ", "god": "ɡuː", "meg": "mæɪ",
    "deg": "dæɪ",
}

_UNSTRESSED_PREFIXES = ("be", "for")


def _scan(word: str) -> tuple[list[str], list[bool]]:
    """Scan one lowercase word → (units, vowel_flags)."""
    out: list[str] = []
    flags: list[bool] = []
    i = 0
    n = len(word)

    def emit(s: str, vowel: bool = False) -> None:
        out.append(s)
        flags.append(vowel)

    def long_ctx(glen: int) -> bool:
        j = i + glen
        if j >= n:
            return True
        if word[j] in "aeiouyæøå":
            return True
        k = j + 1
        if k >= n:
            return True
        if word[k] == word[j]:
            return False
        return word[k] in "aeiouyæøå"

    while i < n:
        rest = word[i:]
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""

        if rest.startswith("hv"):
            emit("v"); i += 2; continue  # silent h: hvordan → vordan
        if rest.startswith("skj") or rest.startswith("sj"):
            emit("ʃ")
            i += 3 if rest[1] == "k" else 2
            continue
        if rest.startswith("kj") or rest.startswith("tj"):
            emit("ç"); i += 2; continue
        if rest.startswith("sk") and i + 2 < n and word[i + 2] in "iy":
            emit("ʃ"); i += 2; continue  # ski → ʃiː
        if rest.startswith("ei"):
            emit("æɪ", True); i += 2; continue
        if rest.startswith("øy"):
            emit("œʏ", True); i += 2; continue
        if rest.startswith("au"):
            emit("æʉ", True); i += 2; continue
        if ch == "k":
            if nxt == "k":
                emit("k"); i += 2; continue  # kk collapses
            emit("ç" if nxt and nxt in "iy" else "k")
            i += 1
            continue
        if ch == "g":
            if nxt == "g":
                emit("ɡ"); i += 2; continue  # gg collapses
            if nxt and nxt in "iy":
                emit("j")
            else:
                emit("ɡ")
            i += 1
            continue
        if ch == "å":
            emit("oː" if long_ctx(1) else "ɔ", True); i += 1; continue
        if ch == "æ":
            emit("æː" if long_ctx(1) else "æ", True); i += 1; continue
        if ch == "ø":
            emit("øː" if long_ctx(1) else "œ", True); i += 1; continue
        if ch == "a":
            emit("ɑː" if long_ctx(1) else "a", True); i += 1; continue
        if ch == "e":
            if i + 1 == n and n > 2:
                emit("ɛ", True)
            elif i + 2 == n and nxt in "nrl":
                emit("ə", True)  # final -en/-er/-el reduce
            else:
                emit("eː" if long_ctx(1) else "ɛ", True)
            i += 1
            continue
        if ch == "i":
            emit("iː" if long_ctx(1) else "ɪ", True); i += 1; continue
        if ch == "o":
            emit("uː" if long_ctx(1) else "ɔ", True); i += 1; continue
        if ch == "u":
            emit("ʉː" if long_ctx(1) else "ʉ", True); i += 1; continue
        if ch == "y":
            emit("yː" if long_ctx(1) else "ʏ", True); i += 1; continue
        simple = {"b": "b", "c": "s", "d": "d", "f": "f", "h": "h",
                  "j": "j", "l": "l", "m": "m", "n": "n", "p": "p",
                  "q": "k", "r": "r", "s": "s", "t": "t", "v": "v",
                  "w": "v", "x": "ks", "z": "s"}
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

    return place_stress(units, flags, nuclei[first])


_ONES = ["null", "en", "to", "tre", "fire", "fem", "seks", "sju",
         "åtte", "ni", "ti", "elleve", "tolv", "tretten", "fjorten",
         "femten", "seksten", "sytten", "atten", "nitten"]
_TENS = ["", "", "tjue", "tretti", "førti", "femti", "seksti",
         "sytti", "åtti", "nitti"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "minus " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (_ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = "hundre" if h == 1 else _ONES[h] + " hundre"
        return head + (" og " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "tusen" if k == 1 else number_to_words(k) + " tusen"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("en million" if m == 1
            else number_to_words(m) + " millioner")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
