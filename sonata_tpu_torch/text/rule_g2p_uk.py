"""Ukrainian letter-to-sound rules for the hermetic G2P backend.

Ukrainian Cyrillic is markedly more phonemic than Russian — no strong
vowel reduction (unstressed о stays o), г is the glottal ɦ, и is the
fixed ɪ — so rules cover it better than its neighbor; stress remains
lexical, handled with a frequent-word lexicon plus a penultimate
default.  The reference gets Ukrainian from eSpeak-ng's compiled
``uk_dict`` (``/root/reference/deps/dev/espeak-ng-data``); this is the
hermetic stand-in producing broad IPA in eSpeak ``uk`` conventions.

Covered phenomena: г → ɦ vs ґ → ɡ, и → ɪ, і → i, ї → ji, є → jɛ,
щ → ʃtʃ, palatalization via ь and iotated vowels, the apostrophe as
a non-palatalization separator (м'ята → mjata), and no akanie.
"""

from __future__ import annotations

import re

_STRESS: dict[str, int] = {
    "привіт": 2, "дякую": 1, "будь": 1, "ласка": 1, "добре": 1,
    "сьогодні": 2, "завтра": 1, "вчора": 1, "мова": 1, "країна": 2,
    "україна": 3, "людина": 2, "дитина": 2, "робота": 2, "вода": 2,
    "голова": 3, "добрий": 1, "гарний": 1, "великий": 2, "маленький": 2,
    "земля": 2, "школа": 1, "любов": 2, "життя": 2, "народ": 2,
    "вулиця": 1, "новий": 2, "старий": 2,
}

_PLAIN = {"а": "a", "е": "ɛ", "и": "ɪ", "і": "i", "о": "o", "у": "u"}
_IOTATED = {"я": "a", "є": "ɛ", "ю": "u", "ї": "i"}
_CONS = {"б": "b", "в": "ʋ", "г": "ɦ", "ґ": "ɡ", "д": "d", "ж": "ʒ",
         "з": "z", "й": "j", "к": "k", "л": "l", "м": "m", "н": "n",
         "п": "p", "р": "r", "с": "s", "т": "t", "ф": "f", "х": "x",
         "ц": "ts", "ч": "tʃ", "ш": "ʃ"}
_ALWAYS_HARD = {"ж", "ш", "ч"}


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

        if rest.startswith("щ"):
            emit("ʃ"); emit("tʃ"); i += 1; continue
        if ch in _CONS:
            c = _CONS[ch]
            if ch not in _ALWAYS_HARD and nxt and nxt in "єюяіь":
                c += "ʲ"
            emit(c)
            i += 1
            continue
        if ch in _PLAIN:
            emit(_PLAIN[ch], True)
            i += 1
            continue
        if ch in _IOTATED:
            prev = word[i - 1] if i > 0 else ""
            # the apostrophe blocks palatalization and forces /j/
            if i == 0 or prev in "аеиіоуяєюї'ʼь":
                emit("j")
            emit(_IOTATED[ch], True)
            i += 1
            continue
        # ь handled via lookahead; apostrophe is a separator
        i += 1
    return out, flags


def word_to_ipa(word: str) -> str:
    word = word.replace("’", "'")
    units, flags = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    if not nuclei:
        return "".join(units)
    if len(nuclei) == 1:
        return "".join(units)
    stress_pos = _STRESS.get(word)
    if stress_pos is not None:
        target_n = min(stress_pos - 1, len(nuclei) - 1)
    elif (m := re.search(
            "ц(і(?:я|ї|ю|єю|ям|ях|ями))$", word)) and \
            len(nuclei) >= 3:
        # -ція nouns (any case form) stress the syllable before the
        # suffix; the suffix vowel count varies by case (ія=2, ією=3)
        sv = sum(1 for ch in m.group(1) if ch in "аеиіоуюяєї")
        target_n = max(0, len(nuclei) - sv - 1)
    elif word.endswith(("ти", "ла", "ло", "ли")):
        target_n = len(nuclei) - 1  # verb endings lean final
    else:
        target_n = len(nuclei) - 2  # penultimate default
    from .rule_g2p import place_stress

    return place_stress(units, flags, nuclei[target_n],
                        liquids=("r", "l", "j", "ʋ"))


_ONES = ["нуль", "один", "два", "три", "чотири", "п'ять", "шість",
         "сім", "вісім", "дев'ять", "десять", "одинадцять",
         "дванадцять", "тринадцять", "чотирнадцять", "п'ятнадцять",
         "шістнадцять", "сімнадцять", "вісімнадцять", "дев'ятнадцять"]
_TENS = ["", "", "двадцять", "тридцять", "сорок", "п'ятдесят",
         "шістдесят", "сімдесят", "вісімдесят", "дев'яносто"]
_HUNDREDS = ["", "сто", "двісті", "триста", "чотириста", "п'ятсот",
             "шістсот", "сімсот", "вісімсот", "дев'ятсот"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "мінус " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        return _HUNDREDS[h] + (" " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        if k == 1:
            head = "тисяча"
        else:
            kw = number_to_words(k)
            if kw.endswith("один"):
                kw = kw[:-4] + "одна"
            elif kw.endswith("два"):
                kw = kw[:-3] + "дві"
            if k % 10 in (2, 3, 4) and k % 100 not in (12, 13, 14):
                head = kw + " тисячі"
            elif k % 10 == 1 and k % 100 != 11:
                head = kw + " тисяча"
            else:
                head = kw + " тисяч"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    if m == 1:
        head = "мільйон"
    elif m % 10 == 1 and m % 100 != 11:
        head = number_to_words(m) + " мільйон"
    elif m % 10 in (2, 3, 4) and m % 100 not in (12, 13, 14):
        head = number_to_words(m) + " мільйони"
    else:
        head = number_to_words(m) + " мільйонів"
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    text = text.replace("’", "'")
    return expand_numbers(text, number_to_words).lower()
