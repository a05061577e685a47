"""Kazakh (Cyrillic) letter-to-sound rules for the hermetic G2P.

Kazakh Cyrillic is phonemic with nine extra letters for the vowel-
harmony pairs (ә ө ү ұ і) and uvular/velar consonants (қ ғ ң һ);
stress falls on the final syllable — the reference gets Kazakh from
eSpeak-ng's compiled ``kk_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``kk`` conventions.

Covered phenomena: the full Kazakh letter inventory including the
front/back vowel pairs (а/ә, о/ө, ұ/ү, ы/і), қ → q, ғ → ʁ, ң → ŋ,
у as the glide w after vowels and the vowel u elsewhere, и → i,
final-syllable stress.
"""

from __future__ import annotations

_PLAIN = {"а": "ɑ", "ә": "æ", "е": "e", "о": "o", "ө": "ø",
          "ұ": "ʊ", "ү": "y", "ы": "ə", "і": "ɪ", "э": "e"}
_IOTATED = {"я": "ɑ", "ю": "u", "ё": "o"}
_CONS = {"б": "b", "в": "v", "г": "ɡ", "ғ": "ʁ", "д": "d", "ж": "ʒ",
         "з": "z", "й": "j", "к": "k", "қ": "q", "л": "l", "м": "m",
         "н": "n", "ң": "ŋ", "п": "p", "р": "r", "с": "s", "т": "t",
         "ф": "f", "х": "x", "һ": "h", "ц": "ts", "ч": "tʃ",
         "ш": "ʃ", "щ": "ʃ"}
_VOWEL_LETTERS = "аәеоөұүыіэияюё"


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
        prev = word[i - 1] if i > 0 else ""
        if ch == "у":
            # glide after a vowel (тау → taw), vowel+glide otherwise
            if prev and prev in _VOWEL_LETTERS:
                emit("w")
            else:
                emit("u", True)
            i += 1
            continue
        if ch == "и":
            emit("i", True)
            i += 1
            continue
        if ch in _PLAIN:
            emit(_PLAIN[ch], True)
            i += 1
            continue
        if ch in _IOTATED:
            emit("j")
            emit(_IOTATED[ch], True)
            i += 1
            continue
        c = _CONS.get(ch)
        if c is not None:
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

    return place_stress(units, flags, nuclei[-1])  # final stress


_ONES = ["нөл", "бір", "екі", "үш", "төрт", "бес", "алты", "жеті",
         "сегіз", "тоғыз"]
_TENS = ["", "он", "жиырма", "отыз", "қырық", "елу", "алпыс",
         "жетпіс", "сексен", "тоқсан"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "минус " + number_to_words(-num)
    if num < 10:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = "жүз" if h == 1 else _ONES[h] + " жүз"
        return head + (" " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "мың" if k == 1 else number_to_words(k) + " мың"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("миллион" if m == 1
            else number_to_words(m) + " миллион")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
