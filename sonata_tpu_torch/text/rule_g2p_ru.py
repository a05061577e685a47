"""Russian letter-to-sound rules for the hermetic G2P backend.

Russian Cyrillic maps near-phonemically to consonants, but vowel
quality depends on lexical stress (akanie: unstressed о → a), which no
rule system can fully recover — eSpeak itself carries a large Russian
stress dictionary (``ru_dict``, the largest dict in
``/root/reference/deps/dev/espeak-ng-data``).  This hermetic stand-in
combines the letter/palatalization system (exact) with a stressed-word
lexicon for frequent words and a penultimate default elsewhere, so
consonants are right and vowels are right wherever stress is known.

Covered phenomena: the full consonant map (ж/ш/щ/ц/ч), palatalization
via soft vowels and ь (Cʲ), iotated vowels word-initial / after vowels
(я → ja), akanie (unstressed о → a) and ikanie (unstressed е/я → ɪ)
applied AFTER stress assignment, final obstruent devoicing, and the
в→f assimilation before voiceless obstruents.
"""

from __future__ import annotations

import re

# stress positions (1-based nucleus index) for frequent words where the
# penultimate default is wrong; eSpeak resolves these from ru_dict
_STRESS: dict[str, int] = {
    "хорошо": 3, "говорит": 3, "говорить": 3, "человек": 3,
    "молоко": 3, "голова": 3, "борода": 3, "города": 3, "язык": 2,
    "утро": 1, "вечер": 1, "город": 1, "слово": 1, "небо": 1,
    "время": 1, "место": 1, "дело": 1, "море": 1, "поле": 1,
    "мама": 1, "папа": 1, "книга": 1, "школа": 1, "мир": 1,
    "привет": 2, "спасибо": 2, "пожалуйста": 2, "здравствуйте": 2,
    "сегодня": 2, "погода": 2, "работа": 2, "собака": 2, "дорога": 2,
    "свобода": 2, "природа": 2, "минута": 2, "машина": 2,
    "вода": 2, "рука": 2, "нога": 2, "глаза": 2, "окно": 2,
    "объект": 2, "земля": 2, "вопрос": 2, "ответ": 2, "россия": 2,
    "москва": 2, "страна": 2, "музыка": 1, "история": 2,
    "математика": 3, "университет": 5, "метро": 2, "улица": 1,
    "театр": 2, "музей": 2, "поезд": 1, "площадь": 1,
    "столица": 2, "литература": 4, "библиотека": 4,
    "интернет": 3, "институт": 3, "совет": 2, "момент": 2,
}

_PLAIN = {"а": "a", "о": "o", "у": "u", "ы": "ɨ", "э": "e"}
_IOTATED = {"я": "a", "е": "e", "ё": "o", "ю": "u", "и": "i"}
_CONS = {"б": "b", "в": "v", "г": "ɡ", "д": "d", "ж": "ʒ", "з": "z",
         "й": "j", "к": "k", "л": "l", "м": "m", "н": "n", "п": "p",
         "р": "r", "с": "s", "т": "t", "ф": "f", "х": "x", "ц": "ts",
         "ч": "tʃ", "ш": "ʃ", "щ": "ɕ"}
# letters that never palatalize (always-hard consonants)
_ALWAYS_HARD = {"ж", "ш", "ц"}
_DEVOICE = {"b": "p", "bʲ": "pʲ", "d": "t", "dʲ": "tʲ", "ɡ": "k",
            "v": "f", "vʲ": "fʲ", "z": "s", "zʲ": "sʲ", "ʒ": "ʃ"}
_VOICELESS_LETTERS = set("пткфсшщцчх")


def _scan(word: str) -> tuple[list[str], list[bool]]:
    """Scan one lowercase word → (units, vowel_flags).  Vowels are
    emitted in their STRESSED quality; word_to_ipa applies reduction
    after stress assignment."""
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
        if ch in _CONS:
            c = _CONS[ch]
            if ch not in _ALWAYS_HARD and ch != "й" and nxt and \
                    nxt in "еёюяиь":
                c += "ʲ"
            # в assimilates to f before voiceless obstruents (всё → fsʲo)
            if ch == "в" and nxt in _VOICELESS_LETTERS:
                c = "f"
            emit(c)
            i += 1
            continue
        if ch in _PLAIN:
            emit(_PLAIN[ch], True)
            i += 1
            continue
        if ch in _IOTATED:
            prev = word[i - 1] if i > 0 else ""
            iotate = (i == 0 or prev in "аоуыэяеёюиьъ")
            if ch == "и":
                # и never iotates after a consonant; after ь it does
                if prev == "ь":
                    emit("j")
                emit("i", True)
            elif iotate:
                emit("j")
                emit(_IOTATED[ch], True)
            else:
                emit(_IOTATED[ch], True)
            i += 1
            continue
        # ъ hard sign: separates (объект → objekt); ь handled via nxt
        i += 1
    if out and out[-1] in _DEVOICE:
        out[-1] = _DEVOICE[out[-1]]
    return out, flags


# spelling-vs-sound exceptions the scanner cannot derive: г → [v] in
# the frozen сегодня, and the что/конечно [ʃ] class
_SPELLING = {"сегодня": "севодня", "что": "што", "чтобы": "штобы",
             "конечно": "конешно", "скучно": "скушно"}

# -ого words that are adverbs/particles, not genitives: г stays [ɡ]
_OGO_NOT_GENITIVE = {"много", "немного", "дорого", "недорого",
                     "строго", "долго", "надолго", "ненадолго",
                     "убого", "полого"}

# ё-restoration: Russian text overwhelmingly writes е for ё, which is
# a VOWEL QUALITY error here, not just stress (мед [mʲet] vs мёд
# [mʲot]).  eSpeak's ru_dict restores ё lexically; this is the hermetic
# subset over the high-frequency core.  Exact forms, stem prefixes
# (noun paradigms keep ё in the stem), adjective stems over the
# agreement endings, and the -шел past family.
_YO_EXACT = {
    "еще": "ещё", "мед": "мёд", "лед": "лёд", "елка": "ёлка",
    "ежик": "ёжик", "нес": "нёс", "вез": "вёз", "пес": "пёс",
    "звезды": "звёзды", "слезы": "слёзы", "сестры": "сёстры",
    "жены": "жёны", "озера": "озёра", "весла": "вёсла",
    "идет": "идёт", "идешь": "идёшь", "идем": "идём",
    "идете": "идёте", "живет": "живёт", "живешь": "живёшь",
    "живем": "живём", "дает": "даёт", "даешь": "даёшь",
    "берет": "берёт", "берешь": "берёшь", "несет": "несёт",
    "везет": "везёт", "ведет": "ведёт", "поет": "поёт",
    "пьет": "пьёт", "бьет": "бьёт", "льет": "льёт",
    "шьет": "шьёт", "встает": "встаёт", "зовет": "зовёт",
    "ждет": "ждёт", "врет": "врёт", "растет": "растёт",
    "цветет": "цветёт", "течет": "течёт", "печет": "печёт",
    "придет": "придёт", "пойдет": "пойдёт", "найдет": "найдёт",
    "придем": "придём", "пойдем": "пойдём", "начнет": "начнёт",
    "вернется": "вернётся", "остается": "остаётся",
    "смеется": "смеётся", "проснется": "проснётся",
    "трехсот": "трёхсот", "все-таки": "всё-таки",
}
_YO_PREFIXES = {
    "самолет": "самолёт", "вертолет": "вертолёт",
    "ребенк": "ребёнк", "ребенок": "ребёнок",
    "котенок": "котёнок",
    "счет": "счёт", "отчет": "отчёт", "расчет": "расчёт",
    "учет": "учёт", "зачет": "зачёт", "полет": "полёт",
    "партнер": "партнёр", "шофер": "шофёр", "актер": "актёр",
    "режиссер": "режиссёр",
}
# a prefix rewrite only fires when the remainder is a noun case ending
# (полета ✓) — never mid-verb (полетел keeps its е: полете́л)
_NOUN_CASE_ENDS = ("", "а", "у", "е", "ом", "ы", "и", "ов", "ам",
                   "ами", "ах", "ой", "ою")
_YO_ADJ_STEMS = {
    "черн": "чёрн", "зелен": "зелён", "желт": "жёлт",
    "тепл": "тёпл", "темн": "тёмн", "легк": "лёгк",
    "тяжел": "тяжёл", "дешев": "дешёв", "жестк": "жёстк",
    "тверд": "твёрд", "четк": "чётк", "надежн": "надёжн",
}
_ADJ_AGREE = ("ый", "ого", "ому", "ым", "ом", "ая", "ой", "ую",
              "ое", "ые", "ых", "ыми", "ий", "его", "ему", "им",
              "ем", "яя", "ее", "ие", "их", "ими")


def _restore_yo(word: str) -> str:
    if "ё" in word:
        return word
    hit = _YO_EXACT.get(word)
    if hit is not None:
        return hit
    for pre, yo in _YO_PREFIXES.items():
        if word.startswith(pre) and word[len(pre):] in _NOUN_CASE_ENDS:
            return yo + word[len(pre):]
    for stem, yo in _YO_ADJ_STEMS.items():
        if word.startswith(stem) and word[len(stem):] in _ADJ_AGREE:
            return yo + word[len(stem):]
    # пошел/нашел/пришел/ушел → -шёл; вы́шел keeps е (вы- takes stress)
    if word.endswith("шел") and not word.startswith("вы"):
        return word[:-3] + "шёл"
    return word


def word_to_ipa(word: str) -> str:
    word = _restore_yo(word)  # е-for-ё restoration (quality + stress)
    orig = word
    word = _SPELLING.get(word, word)
    # genitive -ого/-его endings read г as [v] (нового → novava) —
    # except the adverbs/particles whose -ого is not a case ending
    # (мно́го, до́рого: г stays [ɡ])
    if word.endswith(("ого", "его")) and len(word) > 3 and \
            word not in _OGO_NOT_GENITIVE:
        word = word[:-2] + "во"
    units, flags = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    if not nuclei:
        return "".join(units)
    if len(nuclei) == 1:
        return "".join(units)
    # round-5 frequency-swept lexicon (exact forms + stem matches over
    # inflection endings) first; the small legacy table second
    from .rule_g2p_ru_stress import lookup_stress

    stress_pos = lookup_stress(orig)
    if stress_pos is None:
        stress_pos = _STRESS.get(orig)
    if stress_pos is not None:
        target_n = min(stress_pos - 1, len(nuclei) - 1)
    elif "ё" in orig:
        # ё is ALWAYS the stressed vowel in Russian orthography
        target_n = sum(1 for ch in orig[:orig.index("ё")]
                       if ch in "аеёиоуыэюя")
        target_n = min(target_n, len(nuclei) - 1)
    elif (m := re.search(
            "ц(и(?:я|и|ю|ей|ям|ях|ями))$", orig)) and \
            len(nuclei) >= 3:
        # -ция nouns (any case form) stress the syllable before the
        # suffix (инфорМАция, стАнциями): subtract the suffix's own
        # vowel count, which varies by case (ия=2, иями=3)
        sv = sum(1 for ch in m.group(1) if ch in "аеёиоуыэюя")
        target_n = max(0, len(nuclei) - sv - 1)
    elif orig.endswith(("он", "ин", "ан")) and len(nuclei) >= 3 and \
            not orig.endswith(("ован", "исан", "азан", "иван")):
        # polysyllabic loanword nouns with these codas lean final
        # (телефон, магазин, ресторан); -ет/-ут/-ал are left out (verb
        # inflections: будет, работал), and the passive-participle
        # endings -ован/-исан/-азан/-иван are excluded too (напИсан)
        target_n = len(nuclei) - 1
    elif word.endswith("дцать"):
        target_n = len(nuclei) - 2  # the -дцать numerals stay penult
    elif word.endswith(("ть", "л", "ла", "ло", "ли")) and \
            len(nuclei) >= 2:
        target_n = len(nuclei) - 1  # verbs lean final/near-final
    elif word.endswith("ой"):
        target_n = len(nuclei) - 1  # -ой adjectives stress the ending
    else:
        target_n = len(nuclei) - 2  # penultimate default
    # vowel reduction AFTER stress: unstressed о → a (akanie),
    # unstressed е → ɪ (ikanie); я (the 'a' after j or a soft
    # consonant) reduces to ɪ likewise
    for k, u in enumerate(nuclei):
        if k == target_n:
            continue
        if units[u] == "o":
            units[u] = "a"
        elif units[u] == "e":
            units[u] = "ɪ"
        elif units[u] == "a" and u > 0 and (
                units[u - 1] == "j" or units[u - 1].endswith("ʲ")):
            units[u] = "ɪ"
    from .rule_g2p import place_stress

    return place_stress(units, flags, nuclei[target_n],
                        liquids=("r", "l", "rʲ", "lʲ", "j"))


_ONES = ["ноль", "один", "два", "три", "четыре", "пять", "шесть",
         "семь", "восемь", "девять", "десять", "одиннадцать",
         "двенадцать", "тринадцать", "четырнадцать", "пятнадцать",
         "шестнадцать", "семнадцать", "восемнадцать", "девятнадцать"]
_TENS = ["", "", "двадцать", "тридцать", "сорок", "пятьдесят",
         "шестьдесят", "семьдесят", "восемьдесят", "девяносто"]
_HUNDREDS = ["", "сто", "двести", "триста", "четыреста", "пятьсот",
             "шестьсот", "семьсот", "восемьсот", "девятьсот"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "минус " + number_to_words(-num)
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
            head = "тысяча"
        else:
            kw = number_to_words(k)
            # тысяча is feminine: один/два agree as одна/две
            if kw.endswith("один"):
                kw = kw[:-4] + "одна"
            elif kw.endswith("два"):
                kw = kw[:-3] + "две"
            if k % 10 in (2, 3, 4) and k % 100 not in (12, 13, 14):
                head = kw + " тысячи"
            elif k % 10 == 1 and k % 100 != 11:
                head = kw + " тысяча"
            else:
                head = kw + " тысяч"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    if m == 1:
        head = "миллион"
    elif m % 10 == 1 and m % 100 != 11:
        head = number_to_words(m) + " миллион"  # двадцать один миллион
    elif m % 10 in (2, 3, 4) and m % 100 not in (12, 13, 14):
        head = number_to_words(m) + " миллиона"
    else:
        head = number_to_words(m) + " миллионов"
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
