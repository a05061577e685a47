"""Catalan letter-to-sound rules for the hermetic G2P backend.

Catalan orthography is regular once the vowel-reduction system is
tied to stress (unstressed a/e → ə, unstressed o → u in the central
standard) — the reference gets Catalan from eSpeak-ng's compiled
``ca_dict`` (``/root/reference/deps/dev/espeak-ng-data``); this is
the hermetic stand-in producing broad Central Catalan IPA in eSpeak
``ca`` conventions.

Covered phenomena: ny → ɲ, l·l → l, ll → ʎ, ix after vowel → ʃ,
tx → tʃ, tg/tj → dʒ, ç → s, soft c/g, j/g → ʒ, x → ʃ initial or
after consonant, the accent system (à è é í ò ó ú) driving stress,
ending-based default stress (vowel/-s/-en → penult), and
stress-conditioned reduction (a/e → ə, o → u) applied afterwards.
"""

from __future__ import annotations

_ACCENTED = {"à": ("a", "a"), "è": ("e", "ɛ"), "é": ("e", "e"),
             "í": ("i", "i"), "ò": ("o", "ɔ"), "ó": ("o", "o"),
             "ú": ("u", "u")}
_VOWEL_LETTERS = "aeiouàèéíòóú"


def _scan(word: str) -> tuple[list[str], list[bool], int]:
    """Scan one lowercase word → (units, vowel_flags, accent_unit)."""
    out: list[str] = []
    flags: list[bool] = []
    accent_unit = -1
    i = 0
    n = len(word)

    def emit(s: str, vowel: bool = False, accented: bool = False) -> None:
        nonlocal accent_unit
        if vowel and accented:
            accent_unit = len(out)
        out.append(s)
        flags.append(vowel)

    while i < n:
        rest = word[i:]
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""
        prev = word[i - 1] if i > 0 else ""

        if rest.startswith("ll"):
            emit("ʎ"); i += 2; continue
        if rest.startswith("rr"):
            emit("r"); i += 2; continue  # orthographic rr is the trill
        if rest.startswith("ny"):
            emit("ɲ"); i += 2; continue
        if rest.startswith("tx"):
            emit("tʃ"); i += 2; continue
        if rest.startswith("tg") and nxt and i + 2 < n and \
                word[i + 2] in "ei":
            emit("dʒ"); i += 2; continue
        if rest.startswith("tj"):
            emit("dʒ"); i += 2; continue
        if rest.startswith("ig") and i + 2 == n and prev and \
                prev in _VOWEL_LETTERS:
            emit("tʃ"); i += 2; continue  # final -ig: puig → putʃ
        if rest.startswith("ix") and prev and prev in _VOWEL_LETTERS:
            emit("ʃ"); i += 2; continue  # caixa → kaʃə
        if rest.startswith("qü") or (rest.startswith("qu") and nxt and
                                     i + 2 < n and word[i + 2] in "aoà"):
            emit("kw"); i += 2; continue  # quatre → kwatrə, qüestió
        if rest.startswith("qu") and nxt and i + 2 < n and \
                word[i + 2] in "ei":
            emit("k"); i += 2; continue
        if rest.startswith("gü"):
            emit("ɡw"); i += 2; continue  # pingüí
        if rest.startswith("gu") and nxt and i + 2 < n and \
                word[i + 2] in "ei":
            emit("ɡ"); i += 2; continue
        if ch == "ç":
            emit("s"); i += 1; continue
        if ch == "c":
            emit("s" if nxt and nxt in "eiéèí" else "k"); i += 1; continue
        if ch == "g":
            emit("ʒ" if nxt and nxt in "eiéèí" else "ɡ"); i += 1; continue
        if ch == "j":
            emit("ʒ"); i += 1; continue
        if ch == "x":
            emit("ʃ"); i += 1; continue
        if ch == "h":
            i += 1; continue  # silent
        if ch == "r":
            if i + 1 == n and n > 2:
                i += 1; continue  # final -r usually silent (parlar)
            emit("r" if i == 0 or prev in "nls" else "ɾ")
            i += 1
            continue
        if ch == "s":
            if prev and prev in _VOWEL_LETTERS and nxt and \
                    nxt in _VOWEL_LETTERS:
                emit("z")
            elif nxt == "s":
                emit("s"); i += 2; continue
            else:
                emit("s")
            i += 1
            continue
        if ch in _ACCENTED:
            letter, ipa = _ACCENTED[ch]
            emit(ipa, True, accented=True)
            i += 1
            continue
        if ch in "aeiou":
            if ch == "i" and prev and prev in "aeou":
                emit("j"); i += 1; continue  # glide after vowel
            if ch == "u" and prev and prev in "aeio":
                emit("w"); i += 1; continue
            emit(ch, True)
            i += 1
            continue
        if ch == "ï":
            emit("i", True); i += 1; continue  # hiatus: països
        if ch == "ü":
            emit("u", True); i += 1; continue
        simple = {"b": "b", "d": "d", "f": "f", "k": "k", "l": "l",
                  "m": "m", "n": "n", "p": "p", "q": "k", "t": "t",
                  "v": "b", "w": "w", "y": "j", "z": "z"}
        if ch in simple:
            emit(simple[ch])
        i += 1
    return out, flags, accent_unit


def word_to_ipa(word: str) -> str:
    units, flags, accent = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    ipa = "".join(units)
    if not nuclei:
        return ipa
    falling_diph = len(word) >= 2 and word[-1] in "iu" and \
        word[-2] in "aeou"
    if accent >= 0 and accent in nuclei:
        target = accent
    elif falling_diph:
        target = nuclei[-1]  # -ai/-ui/-eu… count as one final syllable
    elif word[-1] in "aeiou" or word.endswith(("es", "en", "as", "os")):
        target = nuclei[-2] if len(nuclei) >= 2 else nuclei[-1]
    else:
        target = nuclei[-1]
    # Central Catalan reduction in unstressed syllables: a/e → ə, o → u
    for k in nuclei:
        if k == target:
            continue
        if units[k] in ("a", "e", "ɛ"):
            units[k] = "ə"
        elif units[k] in ("o", "ɔ"):
            units[k] = "u"
    if len(nuclei) < 2:
        return "".join(units)
    from .rule_g2p import place_stress

    return place_stress(units, flags, target)


_ONES = ["zero", "un", "dos", "tres", "quatre", "cinc", "sis", "set",
         "vuit", "nou", "deu", "onze", "dotze", "tretze", "catorze",
         "quinze", "setze", "disset", "divuit", "dinou"]
_TENS = ["", "", "vint", "trenta", "quaranta", "cinquanta",
         "seixanta", "setanta", "vuitanta", "noranta"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "menys " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        if o == 0:
            return _TENS[t]
        joiner = "-i-" if t == 2 else "-"  # vint-i-tres, trenta-dos
        return _TENS[t] + joiner + _ONES[o]
    if num < 1000:
        h, r = divmod(num, 100)
        head = "cent" if h == 1 else _ONES[h] + "-cents"
        return head + (" " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "mil" if k == 1 else number_to_words(k) + " mil"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("un milió" if m == 1
            else number_to_words(m) + " milions")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    text = expand_numbers(text, number_to_words).lower()
    # geminate l·l reads as plain l; folding here keeps the word whole
    # through the tokenizer (the middle dot is not a word character)
    return text.replace("l·l", "l")
