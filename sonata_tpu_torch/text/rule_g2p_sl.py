"""Slovenian letter-to-sound rules for the hermetic G2P backend.

Slovenian shares Gaj's Latin orthography with BCMS (č/š/ž, no ć/đ)
with its own l/v vocalization (final -l → w: bil → biw) and a schwa
for unwritten vowels in -əC clusters kept broad; stress is lexical —
handled with a frequent-word lexicon and a penultimate default — the
reference gets Slovenian from eSpeak-ng's compiled ``sl_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``sl`` conventions.

Covered phenomena: č/š/ž, lj/nj kept as l+j/n+j (Slovenian, unlike
BCMS, has no palatal ʎ/ɲ phonemes), final/preconsonantal l and v → w,
syllabic r with schwa (ərː kept broad as r-nucleus), e/o open-closed
kept broad as ɛ/ɔ.
"""

from __future__ import annotations

_STRESS: dict[str, int] = {
    "dober": 1, "hvala": 1, "prosim": 1, "slovenija": 3, "ljubljana": 2,
    "slovensko": 2, "danes": 1, "jutri": 1, "včeraj": 2, "dobro": 1,
    "lepo": 2, "zelo": 2, "voda": 1, "jezik": 2, "beseda": 2,
}

_CONS = {"b": "b", "c": "ts", "č": "tʃ", "d": "d", "f": "f",
         "g": "ɡ", "h": "x", "j": "j", "k": "k", "m": "m", "n": "n",
         "p": "p", "s": "s", "š": "ʃ", "t": "t", "z": "z", "ž": "ʒ"}

_VOWELS = "aeiou"


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
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""
        prev = word[i - 1] if i > 0 else ""

        if ch == "l":
            # final or preconsonantal l vocalizes: bil → biw, poln →
            # powːn (broad pown)
            if prev and prev in _VOWELS and (not nxt or
                                             nxt not in _VOWELS
                                             and nxt != "j"):
                emit("w")
            else:
                emit("l")
            i += 1
            continue
        if ch == "v":
            # preconsonantal/final v vocalizes too: vse stays v, but
            # siv → siw
            if prev and prev in _VOWELS and (not nxt or
                                             nxt not in _VOWELS):
                emit("w")
            else:
                emit("v")
            i += 1
            continue
        if ch == "r":
            prev_c = not prev or prev not in _VOWELS
            next_c = not nxt or nxt not in _VOWELS
            if prev_c and next_c:
                emit("ər", True)  # syllabic r carries a schwa: trg
            else:
                emit("r")
            i += 1
            continue
        if ch == "e":
            emit("ɛ", True); i += 1; continue
        if ch == "o":
            emit("ɔ", True); i += 1; continue
        if ch in "aiu":
            emit(ch, True); i += 1; continue
        c = _CONS.get(ch)
        if c is not None:
            emit(c)
        i += 1
    return out, flags


def word_to_ipa(word: str) -> str:
    units, flags = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    if not nuclei:
        return "".join(units)
    if len(nuclei) == 1:
        return "".join(units)
    stress_pos = _STRESS.get(word)
    if stress_pos is not None:
        target_n = min(stress_pos - 1, len(nuclei) - 1)
    else:
        target_n = len(nuclei) - 2  # penultimate default
    from .rule_g2p import place_stress

    return place_stress(units, flags, nuclei[target_n])


_ONES = ["nič", "ena", "dve", "tri", "štiri", "pet", "šest", "sedem",
         "osem", "devet", "deset", "enajst", "dvanajst", "trinajst",
         "štirinajst", "petnajst", "šestnajst", "sedemnajst",
         "osemnajst", "devetnajst"]
_TENS = ["", "", "dvajset", "trideset", "štirideset", "petdeset",
         "šestdeset", "sedemdeset", "osemdeset", "devetdeset"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "minus " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        if o == 0:
            return _TENS[t]
        head = "ena" if o == 1 else _ONES[o]
        if o == 2:
            head = "dva"
        return head + "in" + _TENS[t]  # petindvajset
    if num < 1000:
        h, r = divmod(num, 100)
        head = "sto" if h == 1 else ("dvesto" if h == 2
                                     else _ONES[h] + "sto")
        return head + (" " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        if k == 1:
            head = "tisoč"
        elif k == 2:
            head = "dva tisoč"
        else:
            head = number_to_words(k) + " tisoč"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("milijon" if m == 1
            else number_to_words(m) + " milijonov")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
