"""Icelandic letter-to-sound rules for the hermetic G2P backend.

Icelandic orthography is conservative but highly regular: the accented
vowels are fixed diphthongs (á → au, ó → ou, é → jɛ, æ → ai, au → øy),
þ/ð survive, ll → tl and nn → tn after accented vowels, and stress is
always word-initial — the reference gets Icelandic from eSpeak-ng's
compiled ``is_dict`` (``/root/reference/deps/dev/espeak-ng-data``);
this is the hermetic stand-in producing broad IPA in eSpeak ``is``
conventions.

Covered phenomena: the accented-vowel diphthongs, þ → θ, ð → ð,
hv → kv, ll → tl, nn → tn after accented vowels/diphthongs, f → v
between vowels, g softening between vowels, fixed initial stress.
"""

from __future__ import annotations

_VOWEL_MAP = {"a": "a", "á": "au", "e": "ɛ", "é": "jɛ", "i": "ɪ",
              "í": "i", "o": "ɔ", "ó": "ou", "u": "ʏ", "ú": "u",
              "y": "ɪ", "ý": "i", "æ": "ai", "ö": "œ"}
_ACCENTED = "áéíóúýæö"
_VOWEL_LETTERS = "aáeéiíoóuúyýæö"


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
            emit("kv"); i += 2; continue
        if rest.startswith("au"):
            emit("øy", True); i += 2; continue
        if rest.startswith("ei") or rest.startswith("ey"):
            emit("ei", True); i += 2; continue
        # pre-stopping context: an accented vowel letter OR a just-
        # emitted diphthong unit (ei/ey/au → einn, steinn)
        after_diph = bool(out) and flags[-1] and \
            out[-1] in ("ei", "øy", "au", "ou", "ai", "jɛ")
        if rest.startswith("ll"):
            if (prev and prev in _ACCENTED) or after_diph or i + 2 == n:
                emit("t"); emit("l")
            else:
                emit("l")
            i += 2
            continue
        if rest.startswith("nn") and ((prev and prev in _ACCENTED)
                                      or after_diph):
            emit("t"); emit("n"); i += 2; continue
        if ch == "þ":
            emit("θ"); i += 1; continue
        if ch == "ð":
            emit("ð"); i += 1; continue
        if ch == "f":
            if prev and prev in _VOWEL_LETTERS and nxt and \
                    nxt in _VOWEL_LETTERS:
                emit("v")  # intervocalic f voices: höfum
            else:
                emit("f")
            i += 1
            continue
        if ch == "g":
            if prev and prev in _VOWEL_LETTERS and nxt and \
                    nxt in "ij":
                emit("j")  # softened g: segja
            else:
                emit("ɡ")
            i += 1
            continue
        v = _VOWEL_MAP.get(ch)
        if v is not None:
            emit(v, True)
            i += 1
            continue
        simple = {"b": "p", "d": "t", "h": "h", "j": "j", "k": "kʰ",
                  "l": "l", "m": "m", "n": "n", "p": "pʰ", "r": "r",
                  "s": "s", "t": "tʰ", "v": "v", "x": "ks"}
        # Icelandic b/d/g are voiceless unaspirated; p/t/k aspirate
        # word-initially (broad: everywhere)
        if ch in simple:
            c = simple[ch]
            if ch in "ptk" and i > 0:
                c = c[0]  # aspiration only word-initially (broad)
            if nxt == ch:
                emit(c); i += 2; continue
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


_ONES = ["núll", "einn", "tveir", "þrír", "fjórir", "fimm", "sex",
         "sjö", "átta", "níu", "tíu", "ellefu", "tólf", "þrettán",
         "fjórtán", "fimmtán", "sextán", "sautján", "átján", "nítján"]
_TENS = ["", "", "tuttugu", "þrjátíu", "fjörutíu", "fimmtíu",
         "sextíu", "sjötíu", "áttatíu", "níutíu"]


def _neuter(k: int) -> str:
    """hundruð/þúsund count with neuter numerals: tvö, þrjú, fjögur."""
    return {2: "tvö", 3: "þrjú", 4: "fjögur"}.get(k, _ONES[k])


def number_to_words(num: int) -> str:
    if num < 0:
        return "mínus " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" og " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = "hundrað" if h == 1 else _neuter(h) + " hundruð"
        return head + (" og " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        if k == 1:
            head = "þúsund"
        elif k < 20:
            head = _neuter(k) + " þúsund"
        else:
            # compound counts agree in neuter too: tuttugu og eitt
            kw = number_to_words(k)
            for masc, neut in (("einn", "eitt"), ("tveir", "tvö"),
                               ("þrír", "þrjú"), ("fjórir", "fjögur")):
                if kw.endswith(masc):
                    kw = kw[: -len(masc)] + neut
                    break
            head = kw + " þúsund"
        return head + (" og " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("ein milljón" if m == 1
            else number_to_words(m) + " milljónir")
    return head + (" og " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
