"""Portuguese (Brazilian) letter-to-sound rules for the hermetic G2P.

Portuguese orthography is regular enough for a rule table once the nasal
system is handled — the reference gets Portuguese from eSpeak-ng's
compiled ``pt_dict``/``pt-br``
(``/root/reference/deps/dev/espeak-ng-data``); this module is the
hermetic stand-in producing broad Brazilian IPA in eSpeak conventions.

Covered phenomena: nasal vowels and diphthongs (ão → ɐ̃w, õe → õj,
ãe → ɐ̃j, vowel+m/n in coda), lh/nh/ch digraphs, soft c/g and ç,
initial/doubled r → ʁ vs intervocalic tap ɾ, intervocalic s-voicing,
BR palatalization (ti/di → tʃi/dʒi, including the raised final
unstressed e), final unstressed vowel raising (o → u, e → i, a → ɐ),
written-accent stress with open é/ó, and the ending-driven default
stress rule (vowel/s/m/ns → penultimate, else final).
"""

from __future__ import annotations

_ACCENTED = {"á": ("a", "a"), "â": ("a", "ɐ"), "à": ("a", "a"),
             "é": ("e", "ɛ"), "ê": ("e", "e"),
             "í": ("i", "i"), "ó": ("o", "ɔ"), "ô": ("o", "o"),
             "ú": ("u", "u")}
_VOWEL_LETTERS = "aeiouáâàãéêíóôõú"
_NASAL_MAP = {"a": "ɐ̃", "e": "e\u0303", "i": "i\u0303", "o": "o\u0303", "u": "u\u0303"}


def _scan(word: str) -> tuple[list[str], list[bool], list[int], int]:
    """Scan one lowercase word → (units, vowel_flags,
    nucleus_start_units, accent_nucleus).  Unit-based like the Italian
    scanner so stress can never split a multi-char phoneme."""
    out: list[str] = []
    flags: list[bool] = []
    nucleus_pos: list[int] = []
    acute_nucleus = -1  # written acute/circumflex: always wins
    til_nucleus = -1    # til nasals attract stress when no acute
    last_was_vowel = False
    i = 0
    n = len(word)

    def emit(s: str, vowel: bool = False, accented: bool = False,
             til: bool = False, glide: bool = False) -> None:
        nonlocal last_was_vowel, acute_nucleus, til_nucleus
        if vowel:
            # a glide (diphthong off-vowel) continues the open nucleus
            if not (glide and last_was_vowel):
                nucleus_pos.append(len(out))
            if accented:
                acute_nucleus = len(nucleus_pos) - 1
            if til:
                til_nucleus = len(nucleus_pos) - 1
            last_was_vowel = True
        else:
            last_was_vowel = False
        out.append(s)
        flags.append(vowel)

    def nasal_coda(glen: int) -> bool:
        """vowel + m/n nasalises when the m/n closes the syllable —
        not before a vowel, and not when the n opens an nh digraph."""
        j = i + glen
        if j >= n:
            return True
        if word[i + glen - 1] == "n" and word[j] == "h":
            return False  # banho: the nh is ɲ, the a stays oral
        return word[j] not in _VOWEL_LETTERS

    while i < n:
        rest = word[i:]
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""
        prev = word[i - 1] if i > 0 else ""

        # nasal diphthongs (til marks attract default stress)
        if rest.startswith("ão") or (rest.startswith("am") and i + 2 == n):
            emit("ɐ̃w", True, til=rest.startswith("ão")); i += 2; continue
        if rest.startswith("õe"):
            emit("o\u0303j", True, til=True); i += 2; continue
        if rest.startswith("ãe"):
            emit("ɐ̃j", True, til=True); i += 2; continue
        if rest.startswith("em") and i + 2 == n:
            emit("e\u0303j", True); i += 2; continue
        if (rest.startswith("ém") or rest.startswith("êm")) and i + 2 == n:
            emit("e\u0303j", True, accented=True); i += 2; continue  # também
        if ch == "ã":
            emit("ɐ̃", True, til=True); i += 1; continue
        if ch == "õ":
            emit("o\u0303", True, til=True); i += 1; continue
        # vowel + coda m/n → nasal vowel
        if ch in "aeiou" and nxt and nxt in "mn" and nasal_coda(2):
            emit(_NASAL_MAP[ch], True)
            i += 2
            continue

        # consonant digraphs
        if rest.startswith("lh"):
            emit("ʎ"); i += 2; continue
        if rest.startswith("nh"):
            emit("ɲ"); i += 2; continue
        if rest.startswith("ch"):
            emit("ʃ"); i += 2; continue
        if rest.startswith("qu") and nxt and i + 2 < n and \
                word[i + 2] in "eéêií":
            emit("k"); i += 2; continue
        if rest.startswith("qu"):
            emit("kw"); i += 2; continue
        if rest.startswith("gu") and nxt and i + 2 < n and \
                word[i + 2] in "eéêií":
            emit("ɡ"); i += 2; continue
        if rest.startswith("rr"):
            emit("ʁ"); i += 2; continue
        if rest.startswith("ss"):
            emit("s"); i += 2; continue

        if ch == "c":
            emit("s" if nxt and nxt in "eéêiíy" else "k"); i += 1; continue
        if ch == "ç":
            emit("s"); i += 1; continue
        if ch == "g":
            emit("ʒ" if nxt and nxt in "eéêiíy" else "ɡ"); i += 1; continue
        if ch == "j":
            emit("ʒ"); i += 1; continue
        if ch == "x":
            emit("ʃ"); i += 1; continue
        if ch == "h":
            i += 1; continue  # silent
        if ch == "r":
            if i == 0 or prev in "nls":
                emit("ʁ")
            else:
                emit("ɾ")
            i += 1
            continue
        if ch == "s":
            if prev and prev in _VOWEL_LETTERS and nxt and \
                    nxt in _VOWEL_LETTERS:
                emit("z")
            else:
                emit("s")
            i += 1
            continue
        if ch == "t":
            # BR palatalization: ti → tʃi (also final -te, raised to i)
            if nxt == "i" or nxt == "í" or (nxt == "e" and i + 2 == n):
                emit("tʃ")
            else:
                emit("t")
            i += 1
            continue
        if ch == "d":
            if nxt == "i" or nxt == "í" or (nxt == "e" and i + 2 == n):
                emit("dʒ")
            else:
                emit("d")
            i += 1
            continue
        if ch in _ACCENTED:
            _letter, ipa = _ACCENTED[ch]
            emit(ipa, True, accented=True)
            i += 1
            continue
        if ch in "aeiou":
            # final vowel, or final vowel + plural s: unstressed raising
            # (the stress pass rewrites it back when it ends up stressed)
            at_end = i + 1 == n or (i + 2 == n and nxt == "s")
            if at_end:
                reduced = {"o": "u", "e": "i", "a": "ɐ"}.get(ch, ch)
                emit(reduced, True)
            elif ch == "i" and prev and prev in "aeou":
                emit("j", True, glide=True)
            elif ch == "u" and prev and prev in "aeio":
                emit("w", True, glide=True)
            else:
                emit(ch, True)
            i += 1
            continue
        simple = {"b": "b", "f": "f", "k": "k", "l": "l", "m": "m",
                  "n": "n", "p": "p", "v": "v", "w": "w", "y": "i",
                  "z": "z"}
        if ch in simple:
            emit(simple[ch])
        i += 1
    accent = acute_nucleus if acute_nucleus >= 0 else til_nucleus
    return out, flags, nucleus_pos, accent


def word_to_ipa(word: str) -> str:
    units, flags, positions, accent = _scan(word)
    ipa = "".join(units)
    if not positions:
        return ipa
    if len(positions) < 2 and accent < 0:
        return ipa
    if accent >= 0:
        target = min(accent, len(positions) - 1)
    elif word[-1] in "aeious" or word.endswith(("am", "em", "ns")):
        target = len(positions) - 2  # penultimate default
    else:
        target = len(positions) - 1  # -r/-l/-z/-i/-u/nasal-final → final
    if target < 0:
        target = 0
    from .rule_g2p import place_stress

    return place_stress(units, flags, positions[target],
                        liquids=("ɾ", "l"))


_ONES = ["zero", "um", "dois", "três", "quatro", "cinco", "seis", "sete",
         "oito", "nove", "dez", "onze", "doze", "treze", "catorze",
         "quinze", "dezesseis", "dezessete", "dezoito", "dezenove"]
_TENS = ["", "", "vinte", "trinta", "quarenta", "cinquenta", "sessenta",
         "setenta", "oitenta", "noventa"]
_HUNDREDS = ["", "cento", "duzentos", "trezentos", "quatrocentos",
             "quinhentos", "seiscentos", "setecentos", "oitocentos",
             "novecentos"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "menos " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" e " + _ONES[o] if o else "")
    if num == 100:
        return "cem"
    if num < 1000:
        h, r = divmod(num, 100)
        return _HUNDREDS[h] + (" e " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "mil" if k == 1 else number_to_words(k) + " mil"
        return head + (" e " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = "um milhão" if m == 1 else number_to_words(m) + " milhões"
    return head + (" e " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
