"""Dutch letter-to-sound rules for the hermetic G2P backend.

Dutch orthography is regular once the open/closed-syllable length
system and the vowel digraphs are handled — the reference gets Dutch
from eSpeak-ng's compiled ``nl_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``nl`` conventions.

Covered phenomena: the diphthongs (ij/ei → ɛi, ui → œy, ou/au → ʌu),
long-vowel digraphs (aa/ee/oo/uu, oe → u, eu → øː, ie → i), open
syllable lengthening (water → ˈʋaːtər), g/ch → x, sch → sx, w → ʋ,
final -e(n) reduction to schwa, final devoicing of b/d, initial-stress
default skipping the unstressed prefixes (be-, ge-, ver-, ont-, er-,
her-), and a function-word exception lexicon.
"""

from __future__ import annotations

_LEXICON: dict[str, str] = {
    "de": "də", "het": "ət", "een": "ən", "en": "ɛn", "van": "vɑn",
    "ik": "ɪk", "je": "jə", "is": "ɪs", "dat": "dɑt", "die": "di",
    "in": "ɪn", "te": "tə", "met": "mɛt", "op": "ɔp", "niet": "nit",
    "zijn": "zɛin", "er": "ɛr", "maar": "maːr", "om": "ɔm",
    "ook": "oːk", "als": "ɑls", "dan": "dɑn", "zij": "zɛi",
    "wij": "ʋɛi", "hij": "ɦɛi", "u": "y", "ze": "zə", "we": "ʋə",
    "wat": "ʋɑt", "voor": "voːr", "naar": "naːr", "bij": "bɛi",
    "aan": "aːn", "uit": "œyt", "over": "ˈoːvər", "onder": "ˈɔndər",
    "heeft": "ɦeːft", "hebben": "ˈɦɛbən", "worden": "ˈʋɔrdən",
    "deze": "ˈdeːzə", "veel": "veːl", "goed": "xut", "dag": "dɑx",
    "ja": "jaː", "nee": "neː", "goedemorgen": "xudəˈmɔrxən",
    "goedenavond": "xudənˈaːvɔnt", "één": "eːn",
}

_VOWEL_LETTERS = "aeiouy"
_UNSTRESSED_PREFIXES = ("be", "ge", "ver", "ont", "her")

# word-final devoicing over emitted units
_DEVOICE = {"b": "p", "d": "t", "z": "s", "v": "f"}


def _scan(word: str) -> tuple[list[str], list[bool]]:
    """Scan one lowercase word → (units, vowel_flags)."""
    out: list[str] = []
    flags: list[bool] = []
    i = 0
    n = len(word)

    def emit(s: str, vowel: bool = False) -> None:
        out.append(s)
        flags.append(vowel)

    def open_syllable(glen: int) -> bool:
        """Single vowel letter followed by exactly one consonant then a
        vowel → the vowel is long (open syllable: wa-ter)."""
        j = i + glen
        if j >= n or word[j] in _VOWEL_LETTERS:
            return False
        k = j + 1
        return k < n and word[k] in _VOWEL_LETTERS

    while i < n:
        rest = word[i:]
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""

        # vowel digraphs first
        if rest.startswith("aai"):
            emit("aːj", True); i += 3; continue
        if rest.startswith("ooi"):
            emit("oːj", True); i += 3; continue
        if rest.startswith("oei"):
            emit("uj", True); i += 3; continue
        if rest.startswith("ieuw"):
            emit("iw", True); i += 4; continue
        if rest.startswith("eeuw"):
            emit("eːw", True); i += 4; continue
        if rest.startswith("ij") or rest.startswith("ei"):
            emit("ɛi", True); i += 2; continue
        if rest.startswith("ui"):
            emit("œy", True); i += 2; continue
        if rest.startswith("ou") or rest.startswith("au"):
            emit("ʌu", True); i += 2; continue
        if rest.startswith("oe"):
            emit("u", True); i += 2; continue
        if rest.startswith("eu"):
            emit("øː", True); i += 2; continue
        if rest.startswith("ie"):
            emit("i", True); i += 2; continue
        if rest.startswith("aa"):
            emit("aː", True); i += 2; continue
        if rest.startswith("ee"):
            emit("eː", True); i += 2; continue
        if rest.startswith("oo"):
            emit("oː", True); i += 2; continue
        if rest.startswith("uu"):
            emit("y", True); i += 2; continue

        # consonants
        if rest.startswith("sch"):
            # school → sxoːl; final -isch → is
            if i + 3 == n and i >= 1 and word[i - 1] == "i":
                emit("s"); i += 3; continue
            emit("s"); emit("x"); i += 3; continue
        if rest.startswith("ch"):
            emit("x"); i += 2; continue
        if rest.startswith("ng"):
            emit("ŋ"); i += 2; continue
        if ch == "g":
            emit("x"); i += 1; continue
        if ch == "w":
            emit("ʋ"); i += 1; continue
        if ch == "v":
            emit("v"); i += 1; continue
        if ch == "j":
            emit("j"); i += 1; continue
        if ch == "h":
            emit("ɦ"); i += 1; continue
        if ch == "c":
            emit("s" if nxt and nxt in "ei" else "k"); i += 1; continue
        if ch == "y":
            emit("i", True); i += 1; continue
        if ch == "ë":
            emit("ə", True); i += 1; continue  # drieën → driən
        if ch == "ï":
            emit("i", True); i += 1; continue
        if rest.startswith("ig") and i + 2 == n:
            emit("ə", True); emit("x"); i += 2; continue  # -ig → əx

        # single vowels: open-syllable lengthening, final -e → ə
        if ch == "e":
            if i + 1 == n:
                emit("ə", True)  # final e reduces
            elif i + 2 == n and nxt in "nrlm":
                emit("ə", True)  # final -en/-er/-el/-em: schwa
            elif open_syllable(1):
                emit("eː", True)
            else:
                emit("ɛ", True)
            i += 1
            continue
        if ch == "a":
            # word-final single a and open syllables are long
            emit("aː" if i + 1 == n or open_syllable(1) else "ɑ", True)
            i += 1
            continue
        if ch == "o":
            emit("oː" if i + 1 == n or open_syllable(1) else "ɔ", True)
            i += 1
            continue
        if ch == "u":
            emit("y" if i + 1 == n or open_syllable(1) else "ʏ", True)
            i += 1
            continue
        if ch == "i":
            emit("i" if open_syllable(1) else "ɪ", True); i += 1
            continue
        simple = {"b": "b", "d": "d", "f": "f", "k": "k", "l": "l",
                  "m": "m", "n": "n", "p": "p", "r": "r", "s": "s",
                  "t": "t", "z": "z"}
        if ch in simple:
            # doubled consonant letters collapse (water vs watter)
            if nxt == ch:
                emit(simple[ch]); i += 2; continue
            emit(simple[ch])
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
    # initial stress, skipping unstressed verbal prefixes (whose e
    # reduces to schwa: gezellig → xəˈzɛləx)
    first = 0
    for pfx in _UNSTRESSED_PREFIXES:
        if word.startswith(pfx) and len(nuclei) >= 2 and \
                len(word) > len(pfx) + 2:
            first = 1
            break
    # never stress a schwa nucleus
    while first < len(nuclei) - 1 and units[nuclei[first]] == "ə":
        first += 1
    if first > 0 and units[nuclei[first]] == "ə":
        # everything after the "prefix" is schwa (beter, geven): the
        # be-/ge- was the stem's own first syllable, not a prefix
        first = 0
    elif first > 0 and units[nuclei[0]] in ("eː", "ɛ"):
        units[nuclei[0]] = "ə"  # real prefix: its vowel reduces
    target = nuclei[first]
    from .rule_g2p import place_stress

    return place_stress(units, flags, target,
                        stops=tuple("pbtdkxfv"), s_cluster=True)


_ONES = ["nul", "een", "twee", "drie", "vier", "vijf", "zes", "zeven",
         "acht", "negen", "tien", "elf", "twaalf", "dertien",
         "veertien", "vijftien", "zestien", "zeventien", "achttien",
         "negentien"]
_TENS = ["", "", "twintig", "dertig", "veertig", "vijftig", "zestig",
         "zeventig", "tachtig", "negentig"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "min " + number_to_words(-num)
    if num == 1:
        return "één"  # accented: the bare spelling is the article /ən/
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        if o == 0:
            return _TENS[t]
        head = _ONES[o]
        join = "ën" if head[-1] == "e" else "en"  # drieëntwintig
        return head + join + _TENS[t]
    if num < 1000:
        h, r = divmod(num, 100)
        head = "honderd" if h == 1 else _ONES[h] + "honderd"
        return head + (number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "duizend" if k == 1 else number_to_words(k) + "duizend"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("een miljoen" if m == 1
            else number_to_words(m) + " miljoen")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
