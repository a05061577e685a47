"""Welsh letter-to-sound rules for the hermetic G2P backend.

Welsh orthography is regular with a distinctive consonant inventory
(ll → ɬ, dd → ð, ch → x, f → v, ff → f, th → θ, rh → r̥ kept broad as
r) and penultimate stress — the reference gets Welsh from eSpeak-ng's
compiled ``cy_dict`` (``/root/reference/deps/dev/espeak-ng-data``);
this is the hermetic stand-in producing broad IPA in eSpeak ``cy``
conventions (northern u/y values).

Covered phenomena: the digraphs (ll/dd/ch/ff/th/ph/ngh/ng/rh), w as
the vowel u (cwm → kum) vs consonant w before vowels, y as ə in
non-final syllables and ɨ finally (northern), u → ɨ, si+vowel → ʃ,
and fixed penultimate stress.
"""

from __future__ import annotations

_VOWEL_LETTERS = "aeiouwyâêîôûŵŷ"


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

        if rest.startswith("ngh"):
            emit("ŋ"); i += 3; continue
        if rest.startswith("ng"):
            emit("ŋ"); i += 2; continue
        if rest.startswith("ll"):
            emit("ɬ"); i += 2; continue
        if rest.startswith("dd"):
            emit("ð"); i += 2; continue
        if rest.startswith("ch"):
            emit("x"); i += 2; continue
        if rest.startswith("ff") or rest.startswith("ph"):
            emit("f"); i += 2; continue
        if rest.startswith("th"):
            emit("θ"); i += 2; continue
        if rest.startswith("rh"):
            emit("r"); i += 2; continue
        if rest.startswith("si") and i + 2 < n and \
                word[i + 2] in "aeouw":
            emit("ʃ"); i += 2; continue  # siarad → ʃarad
        if ch == "f":
            emit("v"); i += 1; continue
        if ch == "w":
            # consonant before a vowel (gwynt), vowel otherwise (cwm)
            if nxt and nxt in "aeiouyâêîôûŷ":
                emit("w")
            else:
                emit("u", True)
            i += 1
            continue
        if ch == "y":
            # final syllable: ɨ (north); elsewhere: ə (y fach)
            rest_has_vowel = any(c in _VOWEL_LETTERS
                                 for c in word[i + 1:])
            emit("ə" if rest_has_vowel else "ɨ", True)
            i += 1
            continue
        if ch == "u":
            emit("ɨ", True); i += 1; continue
        if ch in "âêîôû":
            base = {"â": "aː", "ê": "eː", "î": "iː", "ô": "oː",
                    "û": "ɨː"}[ch]
            emit(base, True)
            i += 1
            continue
        if ch == "ŵ":
            emit("uː", True); i += 1; continue
        if ch == "ŷ":
            emit("ɨː", True); i += 1; continue
        if ch in "aeio":
            emit(ch, True); i += 1; continue
        simple = {"b": "b", "c": "k", "d": "d", "g": "ɡ", "h": "h",
                  "j": "dʒ", "k": "k", "l": "l", "m": "m", "n": "n",
                  "p": "p", "r": "r", "s": "s", "t": "t", "z": "z"}
        if ch in simple:
            emit(simple[ch])
        i += 1
    return out, flags


def word_to_ipa(word: str) -> str:
    units, flags = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    ipa = "".join(units)
    if len(nuclei) < 2:
        return ipa
    from .rule_g2p import place_stress

    return place_stress(units, flags, nuclei[-2])  # penultimate


_ONES = ["dim", "un", "dau", "tri", "pedwar", "pump", "chwech",
         "saith", "wyth", "naw", "deg", "un deg un", "un deg dau",
         "un deg tri", "un deg pedwar", "un deg pump", "un deg chwech",
         "un deg saith", "un deg wyth", "un deg naw"]


def number_to_words(num: int) -> str:
    """Modern decimal Welsh counting (ugain-free school system)."""
    if num < 0:
        return "minws " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        head = _ONES[t] + " deg"
        return head + (" " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = ("cant" if h == 1 else _ONES[h] + " cant")
        return head + (" " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "mil" if k == 1 else number_to_words(k) + " mil"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("miliwn" if m == 1
            else number_to_words(m) + " miliwn")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
