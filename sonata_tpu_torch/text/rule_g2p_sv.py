"""Swedish letter-to-sound rules for the hermetic G2P backend.

Swedish orthography is moderately regular once the soft/hard k/g/sk
alternation and the sj-sound spellings are handled; the pitch-accent
distinction is reduced to plain stress — the reference gets Swedish
from eSpeak-ng's compiled ``sv_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``sv`` conventions.

Covered phenomena: soft k/g/sk before front vowels (ɕ/j/ɧ), the
sj-spellings (sj/skj/stj → ɧ, tj/kj → ɕ), å → oː/ɔ, ä → ɛ, ö → øː/œ,
long vs short vowels by syllable structure (vowel before single
consonant long, before double/cluster short), final -tion → ʃuːn,
and initial-stress default with the be-/för- unstressed prefixes.
"""

from __future__ import annotations

_FRONT = "eiyäöéj"

_LEXICON: dict[str, str] = {
    "och": "ɔk", "att": "at", "det": "deː", "som": "sɔm", "en": "ɛn",
    "ett": "ɛt", "är": "æːr", "jag": "jɑːɡ", "du": "dʉː", "han": "han",
    "hon": "huːn", "den": "dɛn", "vi": "viː", "ni": "niː", "de": "dɔm",
    "inte": "ˈɪntɛ", "har": "hɑːr", "var": "vɑːr", "på": "poː",
    "med": "meːd", "för": "fœːr", "till": "tɪl", "av": "ɑːv",
    "om": "ɔm", "så": "soː", "men": "mɛn", "kan": "kan",
    "när": "næːr", "vad": "vɑːd", "mycket": "ˈmʏkːɛt",
    "sverige": "ˈsvæːrjɛ", "hej": "hɛj", "tack": "tak",
    "bra": "brɑː", "dag": "dɑːɡ", "god": "ɡuːd",
}

_UNSTRESSED_PREFIXES = ("be", "för")


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
        """Vowel is long in an open syllable or before a single final
        consonant; short before a cluster or doubled consonant."""
        j = i + glen
        if j >= n:
            return True
        if word[j] in "aeiouyåäö":
            return True
        k = j + 1
        if k >= n:
            return True
        if word[k] == word[j]:  # doubled consonant
            return False
        return word[k] in "aeiouyåäö"

    while i < n:
        rest = word[i:]
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""

        if rest.startswith("tion"):
            emit("ʃ"); emit("uː", True); emit("n"); i += 4; continue
        if rest.startswith("skj") or rest.startswith("stj") or \
                rest.startswith("sj"):
            emit("ɧ")
            i += 3 if rest[1] in "kt" else 2
            continue
        if rest.startswith("sk") and i + 2 < n and word[i + 2] in _FRONT:
            emit("ɧ"); i += 2; continue  # soft sk: sked → ɧeːd
        if rest.startswith("tj") or rest.startswith("kj"):
            emit("ɕ"); i += 2; continue
        if rest.startswith("ck"):
            emit("k"); i += 2; continue
        if ch == "k":
            if nxt == "k":
                emit("k"); i += 2; continue  # kk collapses
            emit("ɕ" if nxt and nxt in _FRONT and nxt != "j" else "k")
            i += 1
            continue
        if ch == "g":
            if nxt == "g":
                emit("ɡ"); i += 2; continue  # gg collapses
            emit("j" if nxt and nxt in _FRONT and nxt != "j" else "ɡ")
            i += 1
            continue
        if ch == "é":
            emit("eː", True); i += 1; continue  # idé, kafé
        if ch == "å":
            emit("oː" if long_ctx(1) else "ɔ", True); i += 1; continue
        if ch == "ä":
            emit("ɛː" if long_ctx(1) else "ɛ", True); i += 1; continue
        if ch == "ö":
            emit("øː" if long_ctx(1) else "œ", True); i += 1; continue
        if ch == "a":
            if i + 1 == n and n > 2:
                emit("a", True)  # final unstressed -a stays short
            else:
                emit("ɑː" if long_ctx(1) else "a", True)
            i += 1
            continue
        if ch == "e":
            if i + 1 == n and n > 2:
                emit("ɛ", True)  # final unstressed e
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
            emit("ʉː" if long_ctx(1) else "ɵ", True); i += 1; continue
        if ch == "y":
            emit("yː" if long_ctx(1) else "ʏ", True); i += 1; continue
        simple = {"b": "b", "c": "s", "d": "d", "f": "f", "h": "h",
                  "j": "j", "l": "l", "m": "m", "n": "n", "p": "p",
                  "q": "k", "r": "r", "s": "s", "t": "t", "v": "v",
                  "w": "v", "x": "ks", "z": "s"}
        if ch in simple:
            if nxt == ch:  # doubled consonant letters collapse
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


_ONES = ["noll", "ett", "två", "tre", "fyra", "fem", "sex", "sju",
         "åtta", "nio", "tio", "elva", "tolv", "tretton", "fjorton",
         "femton", "sexton", "sjutton", "arton", "nitton"]
_TENS = ["", "", "tjugo", "trettio", "fyrtio", "femtio", "sextio",
         "sjuttio", "åttio", "nittio"]


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
        head = "hundra" if h == 1 else _ONES[h] + "hundra"
        return head + (number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "tusen" if k == 1 else number_to_words(k) + "tusen"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("en miljon" if m == 1
            else number_to_words(m) + " miljoner")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
