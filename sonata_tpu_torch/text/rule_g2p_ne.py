"""Nepali (Devanagari) letter-to-sound rules for the hermetic G2P.

Devanagari is an abugida: consonants carry an inherent vowel (Nepali
ʌ) unless a dependent vowel sign (matra) or the virama follows, and
the word-final inherent vowel deletes — the reference gets Nepali
from eSpeak-ng's compiled ``ne_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``ne`` conventions (aspiration
as ʰ/ʱ, retroflex ʈ/ɖ, no ipa-narrow murmur marks beyond ʱ).

Covered phenomena: the full consonant inventory incl. aspirated and
breathy series, independent vs dependent vowels, virama conjuncts,
anusvara as homorganic nasal (broad n/m), candrabindu nasalization,
word-final schwa deletion, and weak initial stress.
"""

from __future__ import annotations

_INDEP_VOWELS = {"अ": "ʌ", "आ": "aː", "इ": "i", "ई": "iː", "उ": "u",
                 "ऊ": "uː", "ऋ": "ri", "ए": "e", "ऐ": "ʌi",
                 "ओ": "o", "औ": "ʌu"}
_MATRAS = {"ा": "aː", "ि": "i", "ी": "iː", "ु": "u", "ू": "uː",
           "ृ": "ri", "े": "e", "ै": "ʌi", "ो": "o", "ौ": "ʌu"}
_CONS = {"क": "k", "ख": "kʰ", "ग": "ɡ", "घ": "ɡʱ", "ङ": "ŋ",
         "च": "tʃ", "छ": "tʃʰ", "ज": "dʒ", "झ": "dʒʱ", "ञ": "n",
         "ट": "ʈ", "ठ": "ʈʰ", "ड": "ɖ", "ढ": "ɖʱ", "ण": "n",
         "त": "t", "थ": "tʰ", "द": "d", "ध": "dʱ", "न": "n",
         "प": "p", "फ": "pʰ", "ब": "b", "भ": "bʱ", "म": "m",
         "य": "j", "र": "r", "ल": "l", "व": "w", "श": "s",
         "ष": "s", "स": "s", "ह": "ɦ"}
_VIRAMA = "्"
_NUKTA = "़"
# nukta letters carry Perso-Arabic loan values (ज़ → z, फ़ → f …)
_NUKTA_CONS = {"ज": "z", "फ": "f", "क": "q", "ख": "x", "ग": "ɣ",
               "ड": "ɽ", "ढ": "ɽʱ"}
_ANUSVARA = "ं"
_CANDRABINDU = "ँ"
_VISARGA = "ः"


def _scan(word: str) -> tuple[list[str], list[bool]]:
    """Scan one Devanagari word → (units, vowel_flags)."""
    out: list[str] = []
    flags: list[bool] = []
    chars = list(word)
    i = 0
    n = len(chars)

    def emit(s: str, vowel: bool = False) -> None:
        out.append(s)
        flags.append(vowel)

    while i < n:
        ch = chars[i]
        v = _INDEP_VOWELS.get(ch)
        if v is not None:
            emit(v, True)
            i += 1
            continue
        c = _CONS.get(ch)
        if c is not None:
            nxt = chars[i + 1] if i + 1 < n else ""
            if nxt == _NUKTA:
                # nukta letters (Perso-Arabic loan sounds): swap the
                # consonant value and keep scanning from the char AFTER
                # the nukta so the following matra still applies
                c = _NUKTA_CONS.get(ch, c)
                i += 1
                nxt = chars[i + 1] if i + 1 < n else ""
            emit(c)
            if nxt in _MATRAS:
                emit(_MATRAS[nxt], True)
                i += 2
                continue
            if nxt == _VIRAMA:
                i += 2  # conjunct: no inherent vowel
                continue
            # inherent vowel, deleted word-finally (and before a final
            # nasal sign) — but never from a word's ONLY syllable
            # (the copula छ is tʃʰʌ, not a bare consonant)
            at_end = i + 1 >= n or (i + 2 >= n and
                                    nxt in (_ANUSVARA, _CANDRABINDU))
            if not at_end or not any(flags):
                emit("ʌ", True)
            i += 1
            continue
        if ch == _ANUSVARA:
            # homorganic nasal, broad: n (m before labials)
            nxt = chars[i + 1] if i + 1 < n else ""
            emit("m" if _CONS.get(nxt, "") in ("p", "pʰ", "b", "bʱ",
                                               "m") else "n")
            i += 1
            continue
        if ch == _CANDRABINDU:
            # nasalize the preceding vowel
            if out and flags[-1]:
                out[-1] = out[-1] + "̃"
            i += 1
            continue
        if ch == _VISARGA:
            emit("h")
            i += 1
            continue
        i += 1
    return out, flags


def word_to_ipa(word: str) -> str:
    units, flags = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    ipa = "".join(units)
    if len(nuclei) < 2:
        return ipa
    from .rule_g2p import place_stress

    return place_stress(units, flags, nuclei[0])  # weak initial stress


_ONES = ["शून्य", "एक", "दुई", "तीन", "चार", "पाँच", "छ", "सात",
         "आठ", "नौ", "दश", "एघार", "बाह्र", "तेह्र", "चौध", "पन्ध्र",
         "सोह्र", "सत्र", "अठार", "उन्नाइस", "बीस"]


_TENS = {2: "बीस", 3: "तीस", 4: "चालीस", 5: "पचास",
         6: "साठी", 7: "सत्तरी", 8: "असी", 9: "नब्बे"}


def number_to_words(num: int) -> str:
    from .rule_g2p import south_asian_number_words

    return south_asian_number_words(
        num, ones=_ONES, tens=_TENS, hundred="सय", thousand="हजार",
        lakh="लाख", minus="माइनस")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    # Devanagari digits → ASCII first
    for d, a in zip("०१२३४५६७८९", "0123456789"):
        text = text.replace(d, a)
    return expand_numbers(text, number_to_words).lower()
