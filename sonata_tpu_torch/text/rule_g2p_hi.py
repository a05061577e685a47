"""Hindi letter-to-sound rules for the hermetic G2P backend.

Hindi shares the Devanagari abugida machinery with Nepali
(:mod:`.rule_g2p_ne`): the same consonant inventory, matras, virama
conjuncts, anusvara/candrabindu nasals, and word-final schwa deletion.
The differences this wrapper applies: the inherent vowel is the Hindi
schwa ə (Nepali uses ʌ) and numbers render with Hindi words (analytic
tens + ones; real Hindi fuses 21-99 irregularly, which needs the
dictionary eSpeak's ``hi_dict`` carries).
"""

from __future__ import annotations

from .rule_g2p_ne import word_to_ipa as _ne_word_to_ipa


def word_to_ipa(word: str) -> str:
    # identical scan; the diphthongs ऐ/औ monophthongize in standard
    # Hindi (ɛː/ɔː) and the inherent vowel surfaces as ə
    ipa = _ne_word_to_ipa(word)
    return (ipa.replace("ʌi", "ɛː").replace("ʌu", "ɔː")
            .replace("ʌ", "ə"))


_ONES = ["शून्य", "एक", "दो", "तीन", "चार", "पाँच", "छह", "सात",
         "आठ", "नौ", "दस", "ग्यारह", "बारह", "तेरह", "चौदह", "पंद्रह",
         "सोलह", "सत्रह", "अठारह", "उन्नीस", "बीस"]
_TENS = {2: "बीस", 3: "तीस", 4: "चालीस", 5: "पचास", 6: "साठ",
         7: "सत्तर", 8: "अस्सी", 9: "नब्बे"}


def number_to_words(num: int) -> str:
    from .rule_g2p import south_asian_number_words

    return south_asian_number_words(
        num, ones=_ONES, tens=_TENS, hundred="सौ", thousand="हज़ार",
        lakh="लाख", minus="माइनस")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
