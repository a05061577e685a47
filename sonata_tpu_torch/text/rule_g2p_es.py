"""Spanish letter-to-sound rules for the hermetic G2P backend.

Spanish orthography is close to phonemic, so a rule table gets near-eSpeak
quality without dictionary data — the reference gets Spanish from
eSpeak-ng's compiled ``es_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this module is the hermetic
stand-in, producing Castilian broad IPA (``c``/``z`` → θ, ``ll`` → ʝ)
matching the eSpeak ``es`` voice conventions.

Covered phenomena: digraphs (ch, ll, rr, qu, gu+e/i, gü), soft c/g before
front vowels (θ/x), silent h, b/v merger, ñ, intervocalic single-r as tap
ɾ vs trill r word-initially and after n/l/s, y as ʝ/i, diphthong vs
accent-broken hiatus syllabification, orthographic accent stress, and the
vowel/n/s → penultimate, otherwise final default stress rule.
"""

from __future__ import annotations

import re

_ACCENT_MAP = {"á": "a", "é": "e", "í": "i", "ó": "o", "ú": "u"}
_VOWEL_LETTERS = "aeiouáéíóúü"
_IPA_VOWELS = "aeiou"


def _scan(word: str) -> tuple[str, list[int], int]:
    """Scan one lowercase word → (ipa, nucleus_start_positions,
    accent_nucleus).

    ``nucleus_start_positions`` are indices into the IPA string where each
    syllable nucleus begins (diphthongs count once; an orthographic accent
    on a weak vowel breaks the diphthong — "día" is two syllables).
    ``accent_nucleus`` is the nucleus index carrying a written accent, or
    -1 when none is present.
    """
    out: list[str] = []
    pos = 0  # running length of "".join(out)
    nucleus_pos: list[int] = []
    accent_nucleus = -1
    last_vowel: tuple[str, bool] | None = None  # (letter, accented)
    i = 0
    n = len(word)

    def emit(s: str, vowel: tuple[str, bool] | None = None) -> None:
        nonlocal pos, last_vowel, accent_nucleus
        if vowel is None:
            last_vowel = None
        else:
            letter, accented = vowel
            weak = letter in "iuü"
            prev = last_vowel
            same_syllable = False
            if prev is not None:
                prev_weak = prev[0] in "iuü"
                # diphthong when either member is an unaccented weak vowel
                same_syllable = (weak and not accented) or (
                    prev_weak and not prev[1])
            if not same_syllable:
                nucleus_pos.append(pos)
            if accented:
                accent_nucleus = len(nucleus_pos) - 1
            last_vowel = vowel
        out.append(s)
        pos += len(s)

    while i < n:
        rest = word[i:]
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""
        at_start = i == 0
        prev_letter = word[i - 1] if i > 0 else ""

        if rest.startswith("ch"):
            emit("tʃ"); i += 2; continue
        if rest.startswith("ll"):
            emit("ʝ"); i += 2; continue
        if rest.startswith("rr"):
            emit("r"); i += 2; continue
        if rest.startswith("qu"):
            emit("k"); i += 2; continue
        if rest.startswith("gü"):
            emit("ɡ"); i += 1; continue  # the ü itself emits as /w/-vowel
        after_gu = word[i + 2] if i + 2 < n else ""
        if rest.startswith("gu") and after_gu and after_gu in "eéií":
            emit("ɡ"); i += 2; continue

        if ch == "c":
            emit("θ" if nxt and nxt in "eéií" else "k"); i += 1; continue
        if ch == "g":
            emit("x" if nxt and nxt in "eéií" else "ɡ"); i += 1; continue
        if ch == "z":
            emit("θ"); i += 1; continue
        if ch == "j":
            emit("x"); i += 1; continue
        if ch == "h":
            i += 1; continue  # silent; does not break a diphthong
        if ch in "bv":
            emit("b"); i += 1; continue
        if ch == "ñ":
            emit("ɲ"); i += 1; continue
        if ch == "y":
            if i == n - 1:
                emit("i", vowel=("i", False))
            else:
                emit("ʝ")
            i += 1
            continue
        if ch == "x":
            emit("ks"); i += 1; continue
        if ch == "r":
            emit("r" if at_start or prev_letter in "nls" else "ɾ")
            i += 1
            continue
        if ch in _ACCENT_MAP:
            emit(_ACCENT_MAP[ch], vowel=(_ACCENT_MAP[ch], True))
            i += 1
            continue
        if ch in "aeiou":
            emit(ch, vowel=(ch, False))
            i += 1
            continue
        if ch == "ü":
            emit("w", vowel=("ü", False))
            i += 1
            continue
        simple = {"d": "d", "f": "f", "k": "k", "l": "l", "m": "m",
                  "n": "n", "p": "p", "s": "s", "t": "t", "w": "w"}
        emit(simple.get(ch, ""))
        i += 1
    return "".join(out), nucleus_pos, accent_nucleus


def word_to_ipa(word: str) -> str:
    ipa, positions, accent = _scan(word)
    if not positions:
        return ipa
    if len(positions) < 2 and accent < 0:
        return ipa
    if accent >= 0:
        target = min(accent, len(positions) - 1)
    elif word[-1] in _VOWEL_LETTERS or word[-1] in "ns":
        target = len(positions) - 2  # penultimate
    else:
        target = len(positions) - 1  # final
    if target < 0:
        target = 0
    # place the mark before the stressed syllable's onset
    onset_start = positions[target]
    while onset_start > 0 and ipa[onset_start - 1] not in _IPA_VOWELS:
        onset_start -= 1
    if positions[target] - onset_start > 1:
        # multi-consonant run between nuclei: split so at most the legal
        # cluster (obstruent+liquid) starts the stressed syllable
        run = ipa[onset_start:positions[target]]
        if len(run) >= 2 and run[-1] in "ɾrl" and run[-2] in "pbtdkɡfθ":
            onset_start = positions[target] - 2
        else:
            onset_start = positions[target] - 1
    return ipa[:onset_start] + "ˈ" + ipa[onset_start:]


_ONES = ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete",
         "ocho", "nueve", "diez", "once", "doce", "trece", "catorce",
         "quince", "dieciséis", "diecisiete", "dieciocho", "diecinueve"]
_TENS = ["", "", "veinte", "treinta", "cuarenta", "cincuenta", "sesenta",
         "setenta", "ochenta", "noventa"]
_HUNDREDS = ["", "ciento", "doscientos", "trescientos", "cuatrocientos",
             "quinientos", "seiscientos", "setecientos", "ochocientos",
             "novecientos"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "menos " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 30:
        composed = {21: "veintiuno", 22: "veintidós", 23: "veintitrés",
                    26: "veintiséis"}
        return composed.get(num, "veinti" + _ONES[num - 20])
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" y " + _ONES[o] if o else "")
    if num == 100:
        return "cien"
    if num < 1000:
        h, r = divmod(num, 100)
        return _HUNDREDS[h] + (" " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "mil" if k == 1 else number_to_words(k) + " mil"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = "un millón" if m == 1 else number_to_words(m) + " millones"
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .numerics import es_grammar, expand_numerics
    from .rule_g2p import expand_numbers

    text = expand_numerics(text, es_grammar())
    return expand_numbers(text, number_to_words).lower()
