"""Romanian letter-to-sound rules for the hermetic G2P backend.

Romanian orthography is close to phonemic (the 1993 reform settled
â/î), so a rule table approaches eSpeak quality — the reference gets
Romanian from eSpeak-ng's compiled ``ro_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``ro`` conventions.

Covered phenomena: the central vowels (ă → ə, â/î → ɨ), soft c/g before
e/i (tʃ/dʒ) with the che/chi/ghe/ghi hard spellings, ș/ț, the
semivocalic diphthongs (ea → e̯a kept broad as ja-like "ea", oa → wa,
ie → je), final asyllabic -i after a consonant, intervocalic s kept
voiceless (Romanian, unlike its Romance siblings, does not voice it),
and the vowel-final-penult / consonant-final-final default stress rule.
"""

from __future__ import annotations

_VOWEL_LETTERS = "aeiouăâî"


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

        if rest.startswith("che") or rest.startswith("chi"):
            emit("k"); i += 2; continue  # the e/i re-scan as vowels
        if rest.startswith("ghe") or rest.startswith("ghi"):
            emit("ɡ"); i += 2; continue
        if ch == "c":
            if nxt and nxt in "ei":
                # mute e/i before another vowel: ciorbă → tʃorbə,
                # cea → tʃa
                if i + 2 < n and word[i + 2] in "aouăâ":
                    emit("tʃ"); i += 2; continue
                emit("tʃ"); i += 1; continue
            emit("k"); i += 1; continue
        if ch == "g":
            if nxt and nxt in "ei":
                if i + 2 < n and word[i + 2] in "aouăâ":
                    emit("dʒ"); i += 2; continue  # george → dʒordʒe
                emit("dʒ"); i += 1; continue
            emit("ɡ"); i += 1; continue
        if ch == "ș":
            emit("ʃ"); i += 1; continue
        if ch == "ț":
            emit("ts"); i += 1; continue
        if ch == "j":
            emit("ʒ"); i += 1; continue
        if ch == "x":
            emit("ks"); i += 1; continue
        if ch == "h":
            emit("h"); i += 1; continue
        if ch == "ă":
            emit("ə", True); i += 1; continue
        if ch in "âî":
            emit("ɨ", True); i += 1; continue
        if rest.startswith("oa"):
            emit("wa", True); i += 2; continue
        if rest.startswith("ea"):
            emit("ea", True); i += 2; continue  # broad e̯a
        if rest.startswith("ie") and (i == 0 or prev not in
                                      _VOWEL_LETTERS):
            emit("je", True); i += 2; continue
        if ch == "i":
            if i + 1 == n and prev and prev not in _VOWEL_LETTERS and \
                    len([f for f in flags if f]) > 0:
                # final asyllabic -i (plural/2sg marker): broad ʲ
                emit("ʲ")
                i += 1
                continue
            if prev and prev in _VOWEL_LETTERS:
                emit("j")  # glide after a vowel: pâine → pɨjne, mai → maj
                i += 1
                continue
            emit("i", True); i += 1; continue
        if ch == "u" and prev and prev in _VOWEL_LETTERS and i + 1 < n:
            emit("w"); i += 1; continue  # ziua → ziwa
        if ch in "aeou":
            emit(ch, True); i += 1; continue
        simple = {"b": "b", "d": "d", "f": "f", "k": "k", "l": "l",
                  "m": "m", "n": "n", "p": "p", "r": "r", "s": "s",
                  "t": "t", "v": "v", "w": "w", "y": "j", "z": "z"}
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
    # vowel-final (including the asyllabic plural -ʲ, which keeps the
    # stem's stress) → penultimate; true consonant-final → final.
    # The -zeci tens keep their stem stress on ze (douăzeci).
    if word.endswith("zeci"):
        target = nuclei[-1]
    elif flags[-1] or units[-1] == "ʲ":
        target = nuclei[-2]
    else:
        target = nuclei[-1]
    from .rule_g2p import place_stress

    return place_stress(units, flags, target)


_ONES = ["zero", "unu", "doi", "trei", "patru", "cinci", "șase",
         "șapte", "opt", "nouă", "zece", "unsprezece", "doisprezece",
         "treisprezece", "paisprezece", "cincisprezece", "șaisprezece",
         "șaptesprezece", "optsprezece", "nouăsprezece"]
_TENS = ["", "", "douăzeci", "treizeci", "patruzeci", "cincizeci",
         "șaizeci", "șaptezeci", "optzeci", "nouăzeci"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "minus " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" și " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        if h == 1:
            head = "o sută"
        elif h == 2:
            head = "două sute"
        else:
            head = _ONES[h] + " sute"
        return head + (" " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        if k == 1:
            head = "o mie"
        elif k == 2:
            head = "două mii"
        else:
            head = number_to_words(k) + " mii"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = "un milion" if m == 1 else number_to_words(m) + " milioane"
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    # cedilla legacy forms → comma-below standard (both cases: the
    # replacement runs before lowercasing)
    text = (text.replace("ş", "ș").replace("ţ", "ț")
            .replace("Ş", "Ș").replace("Ţ", "Ț")
            .replace("Ș", "ș").replace("Ț", "ț"))
    return expand_numbers(text, number_to_words).lower()
