"""Bulgarian letter-to-sound rules for the hermetic G2P backend.

Bulgarian Cyrillic is close to phonemic — no letter ы/э/ё, щ is ʃt,
ъ is the characteristic ɤ vowel — with lexical stress handled via a
frequent-word lexicon plus a penultimate default, and mild unstressed
а/ъ merging left unapplied (broad).  The reference gets Bulgarian from
eSpeak-ng's compiled ``bg_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``bg`` conventions.

Covered phenomena: щ → ʃt, ъ → ɤ, ю/я iotated or palatalizing, ь only
as the palatal marker in -ьо, ч/ш/ж as hard postalveolars, дж → dʒ,
дз → dz, word-final obstruent devoicing.
"""

from __future__ import annotations

_STRESS: dict[str, int] = {
    "здравей": 2, "здравейте": 2, "благодаря": 4, "добре": 2,
    "довиждане": 2, "извинете": 3, "българия": 2, "език": 2,
    "добър": 2, "голям": 2, "малък": 1, "хубав": 1, "вода": 2,
    "човек": 2, "жена": 2, "дете": 2, "книга": 1, "маса": 1,
    "щастие": 1, "ябълка": 1, "момче": 2, "момиче": 2,
    "софия": 1, "луна": 2, "звезда": 2, "сърце": 2, "любов": 2,
    "живот": 2, "народ": 2, "площад": 2, "история": 2, "училище": 2,
    "страна": 2, "ръка": 2, "глава": 2,
}

_PLAIN = {"а": "a", "е": "ɛ", "и": "i", "о": "o", "у": "u", "ъ": "ɤ"}
_CONS = {"б": "b", "в": "v", "г": "ɡ", "д": "d", "ж": "ʒ", "з": "z",
         "й": "j", "к": "k", "л": "l", "м": "m", "н": "n", "п": "p",
         "р": "r", "с": "s", "т": "t", "ф": "f", "х": "x", "ц": "ts",
         "ч": "tʃ", "ш": "ʃ"}
_DEVOICE = {"b": "p", "d": "t", "ɡ": "k", "v": "f", "z": "s",
            "ʒ": "ʃ"}


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

        if ch == "щ":
            emit("ʃ"); emit("t"); i += 1; continue
        if rest.startswith("дж"):
            emit("dʒ"); i += 2; continue
        if rest.startswith("дз"):
            emit("dz"); i += 2; continue
        if ch in _CONS:
            emit(_CONS[ch])
            i += 1
            continue
        if ch in _PLAIN:
            emit(_PLAIN[ch], True)
            i += 1
            continue
        if ch in "юя":
            prev = word[i - 1] if i > 0 else ""
            v = "u" if ch == "ю" else "a"
            if i == 0 or prev in "аеиоуъюя":
                emit("j")
            elif out and not flags[-1]:
                out[-1] = out[-1] + "ʲ"  # palatalizes the consonant
            emit(v, True)
            i += 1
            continue
        if ch == "ь":
            # only occurs as Cьо: palatalize the preceding consonant
            if out and not flags[-1]:
                out[-1] = out[-1] + "ʲ"
            i += 1
            continue
        i += 1
    # word-final devoicing is regressive through the whole final
    # cluster: дъжд → dɤʃt, not dɤʒt
    k = len(out) - 1
    while k >= 0 and not flags[k] and out[k] in _DEVOICE:
        out[k] = _DEVOICE[out[k]]
        k -= 1
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


_ONES = ["нула", "едно", "две", "три", "четири", "пет", "шест",
         "седем", "осем", "девет", "десет", "единадесет",
         "дванадесет", "тринадесет", "четиринадесет", "петнадесет",
         "шестнадесет", "седемнадесет", "осемнадесет",
         "деветнадесет"]
_TENS = ["", "", "двадесет", "тридесет", "четиридесет", "петдесет",
         "шестдесет", "седемдесет", "осемдесет", "деветдесет"]
_HUNDREDS = ["", "сто", "двеста", "триста", "четиристотин",
             "петстотин", "шестстотин", "седемстотин", "осемстотин",
             "деветстотин"]


def _join(head: str, r: int) -> str:
    """Bulgarian places "и" only before the FINAL component: сто и едно
    but сто двадесет и три (the tens level supplies its own и)."""
    single = r < 20 or (r < 100 and r % 10 == 0) or \
        (r < 1000 and r % 100 == 0)
    return head + (" и " if single else " ") + number_to_words(r)


def number_to_words(num: int) -> str:
    if num < 0:
        return "минус " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" и " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        return _join(_HUNDREDS[h], r) if r else _HUNDREDS[h]
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "хиляда" if k == 1 else number_to_words(k) + " хиляди"
        return _join(head, r) if r else head
    m, r = divmod(num, 1_000_000)
    if m == 1:
        head = "един милион"
    elif m == 2:
        head = "два милиона"  # masculine два, not neuter две
    else:
        head = number_to_words(m) + " милиона"
    return _join(head, r) if r else head


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
