"""French letter-to-sound rules for the hermetic G2P backend.

French orthography is far less phonemic than Spanish/Italian — silent
final consonants, nasal vowels, and context-dependent ``e`` make a pure
rule table noisier than for the sibling packs — so this module pairs an
ordered longest-match grapheme table with (a) an ending-normalisation
pass for the regular silent-letter patterns and (b) a function-word
lexicon covering the highest-frequency irregulars.  The reference gets
French from eSpeak-ng's compiled ``fr_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``fr`` voice conventions
(ʁ for r, nasal ɑ̃/ɛ̃/ɔ̃/œ̃, final-syllable stress).

Covered phenomena: nasal vowels with denasalisation before a vowel or
doubled n/m (bon → bɔ̃ but bonne → bɔn), vowel digraphs (ou, oi, au,
eau, ai/ei, eu/œu), the -ill-/-ail/-eil glide family with the
ville/mille exceptions, soft c/g, ç, ch/ph/th/gn/qu, intervocalic
s-voicing, silent h, -tion → sjɔ̃, silent final consonants and -er/-ez
→ e, and schwa handling (final e silent, monosyllabic clitics keep ə).
"""

from __future__ import annotations

# the ~60 highest-frequency words, most of them irregular under the
# letter rules (est → ɛ, les → le, ils → il ...).  Clitics carry no
# stress; content words get their mark from word_to_ipa's caller path.
_LEXICON: dict[str, str] = {
    "le": "lə", "la": "la", "les": "le", "un": "œ̃", "une": "yn",
    "des": "de", "du": "dy", "de": "də", "et": "e", "est": "ɛ",
    "sont": "sɔ̃", "être": "ɛtʁ", "avoir": "avwaʁ", "a": "a", "à": "a",
    "au": "o", "aux": "o", "dans": "dɑ̃", "que": "kə", "qui": "ki",
    "ne": "nə", "pas": "pa", "ce": "sə", "cet": "sɛt", "cette": "sɛt",
    "se": "sə", "sa": "sa", "son": "sɔ̃", "ses": "se", "mes": "me",
    "mon": "mɔ̃", "ma": "ma", "tes": "te", "ton": "tɔ̃", "ta": "ta",
    "nos": "no", "vos": "vo", "ces": "se", "leur": "lœʁ",
    "leurs": "lœʁ",
    "je": "ʒə", "tu": "ty", "il": "il", "elle": "ɛl", "on": "ɔ̃",
    "nous": "nu", "vous": "vu", "ils": "il", "elles": "ɛl",
    "avec": "avɛk", "pour": "puʁ", "sur": "syʁ", "par": "paʁ",
    "plus": "ply", "mais": "mɛ", "ou": "u", "où": "u", "si": "si",
    "tout": "tu", "tous": "tus", "toute": "tut", "toutes": "tut",
    "très": "tʁɛ", "bien": "bjɛ̃", "comme": "kɔm", "faire": "fɛʁ",
    "y": "i", "en": "ɑ̃", "eau": "o", "eux": "ø", "deux": "dø",
    "monsieur": "məsjø", "messieurs": "mesjø", "femme": "fam",
    "temps": "tɑ̃", "fois": "fwa", "hier": "jɛʁ", "fils": "fis",
    "six": "sis", "dix": "dis", "huit": "ɥit", "oui": "wi",
    "non": "nɔ̃", "pays": "pei", "août": "ut", "ville": "vil",
    "mille": "mil", "tranquille": "tʁɑ̃kil", "second": "səɡɔ̃",
    "question": "kɛsˈtjɔ̃", "aujourd'hui": "oʒuʁˈdɥi",
    "client": "kliˈjɑ̃", "argent": "aʁˈʒɑ̃", "parent": "paˈʁɑ̃",
    "parents": "paˈʁɑ̃", "gens": "ʒɑ̃", "fier": "fjɛʁ", "mer": "mɛʁ",
    "cher": "ʃɛʁ", "hiver": "ivɛʁ", "sept": "sɛt", "neuf": "nœf",
    "cinq": "sɛ̃k", "vingt": "vɛ̃", "cent": "sɑ̃", "vent": "vɑ̃",
    "dent": "dɑ̃", "lent": "lɑ̃",
}

# elision clitics: l'homme → l + word_to_ipa("homme")
_ELISION = {"l": "l", "j": "ʒ", "d": "d", "c": "s", "n": "n", "s": "s",
            "m": "m", "t": "t", "qu": "k"}

_VOWELS = "aeiouyàâéèêëîïôûùœ"
_IPA_NUCLEI = ("ɑ̃", "ɛ̃", "ɔ̃", "œ̃", "wa", "wɛ̃", "ɥi", "aj", "ɛj",
               "œj", "uj", "ij", "je", "jɛ", "jø", "a", "e", "ɛ", "i",
               "o", "ɔ", "u", "y", "ø", "œ", "ə")


def _nasal_ctx(word: str, i: int, glen: int) -> bool:
    """True when the n/m ending the group at word[i:i+glen] nasalises:
    followed by a consonant or end-of-word, but NOT by a vowel or by
    another n/m (bonne/comme denasalise)."""
    j = i + glen
    if j >= len(word):
        return True
    nxt = word[j]
    if nxt in _VOWELS or nxt in "nm":
        return False
    return True


def _scan(word: str) -> tuple[list[str], list[bool]]:
    """Scan one lowercase word → (units, vowel_flags).  Each unit is one
    emitted phoneme string; stress placement walks whole units."""
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

        # ---- vowel digraph / nasal families, longest match first ----
        if rest.startswith("eaux"):
            emit("o", True); i += 4; continue
        if rest.startswith("eau"):
            emit("o", True); i += 3; continue
        if rest.startswith("aux") and i + 3 == n:
            emit("o", True); i += 3; continue
        if rest.startswith("au"):
            emit("o", True); i += 2; continue
        if rest.startswith("oin") and _nasal_ctx(word, i, 3):
            emit("wɛ̃", True); i += 3; continue
        if rest.startswith("ouill"):
            emit("uj", True); i += 5; continue
        if rest.startswith("ouil") and i + 4 == n:
            emit("uj", True); i += 4; continue
        if rest.startswith("euill") or rest.startswith("ueill"):
            emit("œj", True); i += 5; continue
        if rest.startswith("euil") or (rest.startswith("ueil")
                                       and i + 4 == n):
            emit("œj", True); i += 4; continue
        if rest.startswith("eill"):
            emit("ɛj", True); i += 4; continue
        if rest.startswith("eil") and i + 3 == n:
            emit("ɛj", True); i += 3; continue
        if rest.startswith("aill"):
            emit("aj", True); i += 4; continue
        if rest.startswith("ail") and i + 3 == n:
            emit("aj", True); i += 3; continue
        if rest.startswith("ill") and prev and prev not in _VOWELS:
            # fille → fij (the ville/mille family sits in the lexicon)
            emit("ij", True); i += 3; continue
        if rest.startswith("ien") and _nasal_ctx(word, i, 3):
            emit("jɛ̃", True); i += 3; continue
        if (rest.startswith("ain") or rest.startswith("ein")) and \
                _nasal_ctx(word, i, 3):
            emit("ɛ̃", True); i += 3; continue
        if (rest.startswith("aim") or rest.startswith("eim")) and \
                _nasal_ctx(word, i, 3):
            emit("ɛ̃", True); i += 3; continue
        if rest.startswith("oî") or rest.startswith("oi"):
            emit("wa", True); i += 2; continue
        if rest.startswith("oy") and nxt and i + 2 < n and \
                word[i + 2] in _VOWELS:
            emit("waj", True); i += 2; continue
        if rest.startswith("où") or rest.startswith("oû") or \
                rest.startswith("ou"):
            emit("u", True); i += 2; continue
        if rest.startswith("aî") or rest.startswith("ai") or \
                rest.startswith("ei"):
            emit("ɛ", True); i += 2; continue
        if rest.startswith("œu") or rest.startswith("eu"):
            glen = 2
            # closed syllable before a pronounced consonant → œ
            # (vendeur); open / word-final → ø (bleu, heureux)
            after = word[i + glen:] if i + glen < n else ""
            # closed syllable (-eur etc.) → œ; open (heureux) → ø
            if after and after[0] == "r" and (len(after) == 1 or
                                              after[1] not in _VOWELS):
                emit("œ", True)
            else:
                emit("ø", True)
            i += glen
            continue
        if ch == "œ":
            emit("œ", True); i += 1; continue
        if (rest.startswith("an") or rest.startswith("am") or
                rest.startswith("en") or rest.startswith("em")) and \
                _nasal_ctx(word, i, 2):
            emit("ɑ̃", True); i += 2; continue
        if (rest.startswith("in") or rest.startswith("im") or
                rest.startswith("yn") or rest.startswith("ym")) and \
                _nasal_ctx(word, i, 2):
            emit("ɛ̃", True); i += 2; continue
        if (rest.startswith("on") or rest.startswith("om")) and \
                _nasal_ctx(word, i, 2):
            emit("ɔ̃", True); i += 2; continue
        if (rest.startswith("un") or rest.startswith("um")) and \
                _nasal_ctx(word, i, 2):
            emit("œ̃", True); i += 2; continue

        # ---- consonant digraphs ----
        if rest.startswith("ch"):
            emit("ʃ"); i += 2; continue
        if rest.startswith("ph"):
            emit("f"); i += 2; continue
        if rest.startswith("th"):
            emit("t"); i += 2; continue
        if rest.startswith("gn"):
            emit("ɲ"); i += 2; continue
        if rest.startswith("qu"):
            emit("k"); i += 2; continue
        if rest.startswith("gu") and nxt and i + 2 < n and \
                word[i + 2] in "eiéèêy":
            emit("ɡ"); i += 2; continue
        if rest.startswith("ge") and i + 2 < n and word[i + 2] in "aou":
            emit("ʒ"); i += 2; continue  # mute e: mangeons → mɑ̃ʒɔ̃
        if rest.startswith("tion"):
            # nation → nasjɔ̃; the -stion words (question) are lexicon
            # material, not rule material
            emit("s"); emit("jɔ̃", True); i += 4; continue

        # ---- single letters ----
        if ch == "c":
            emit("s" if nxt and nxt in "eiyéèê" else "k"); i += 1; continue
        if ch == "ç":
            emit("s"); i += 1; continue
        if ch == "g":
            emit("ʒ" if nxt and nxt in "eiyéèê" else "ɡ"); i += 1; continue
        if ch == "j":
            emit("ʒ"); i += 1; continue
        if ch == "s":
            if nxt == "s":
                emit("s"); i += 2; continue  # ss never voices
            if prev and prev in _VOWELS and nxt and nxt in _VOWELS:
                emit("z")  # intervocalic
            else:
                emit("s")
            i += 1
            continue
        if ch == "x":
            if i == 1 and word[0] == "e" or (prev == "e" and nxt and
                                             nxt in _VOWELS):
                emit("ɡz")  # examen
            else:
                emit("ks")
            i += 1
            continue
        if ch == "h":
            i += 1; continue  # silent (no h-aspiré distinction)
        if ch == "r":
            emit("ʁ"); i += 2 if nxt == "r" else 1; continue
        if ch == "y":
            if prev and prev in _VOWELS or (nxt and nxt in _VOWELS):
                emit("j")
            else:
                emit("i", True)
            i += 1
            continue
        if ch == "é":
            emit("e", True); i += 1; continue
        if ch in "èêë":
            emit("ɛ", True); i += 1; continue
        if ch in "àâ":
            emit("a", True); i += 1; continue
        if ch in "îï":
            emit("i", True); i += 1; continue
        if ch == "ô":
            emit("o", True); i += 1; continue
        if ch in "ûù":
            emit("y", True); i += 1; continue
        if ch == "e":
            if i + 1 == n:
                i += 1; continue  # final e silent (schwa dropped)
            closed = (nxt and nxt not in _VOWELS and nxt != "h" and
                      (i + 2 >= n or word[i + 2] not in _VOWELS))
            if closed:
                emit("ɛ", True)  # closed syllable: belle, merci, mer
            else:
                emit("ə", True)
            i += 1
            continue
        if rest.startswith("ui"):
            emit("ɥi", True); i += 2; continue  # nuit, suis
        if ch == "u":
            emit("y", True); i += 1; continue
        if ch == "o":
            # closed syllable → ɔ (bonne, porte); open/final → o; the
            # C+mute-e case counts as closed EXCEPT before s→z (rose,
            # chose keep the long close o)
            closed = (nxt and nxt not in _VOWELS and nxt != "h" and
                      (i + 2 >= n or word[i + 2] not in _VOWELS or
                       (i + 3 >= n and word[i + 2] == "e"
                        and nxt != "s")))
            emit("ɔ" if closed else "o", True)
            i += 1
            continue
        if ch in "ai":
            emit(ch, True); i += 1; continue
        simple = {"b": "b", "d": "d", "f": "f", "k": "k", "l": "l",
                  "m": "m", "n": "n", "p": "p", "t": "t", "v": "v",
                  "w": "w", "z": "z"}
        if ch in simple:
            emit(simple[ch])
            continue_at = i + 1
            # doubled consonant letters collapse (belle → bɛl)
            if nxt == ch:
                continue_at += 1
            i = continue_at
            continue
        i += 1
    return out, flags


_SILENT_FINAL = "dtpgbsxz"


def _strip_endings(word: str) -> str:
    """Normalise the regular silent-ending patterns before scanning."""
    if len(word) >= 5 and word.endswith("er"):
        return word[:-2] + "é"  # infinitives/agentives: parler → parlé
    if len(word) >= 3 and word.endswith("ez"):
        return word[:-2] + "é"  # parlez → parlé
    if len(word) >= 6 and word.endswith("ent") and not \
            word.endswith("ment"):
        # 3pl verb ending is silent (parlent → paʁl); -ment adverbs
        # keep their nasal, and the short -ent nouns (vent, cent)
        # plus frequent long ones (argent, client) sit in the lexicon
        return word[:-3] + "e"
    # iteratively strip silent final consonants: temps → temp → tem
    w = word
    while len(w) > 2 and w[-1] in _SILENT_FINAL:
        # final consonant after a consonant like "rs"/"ts" also silent
        w = w[:-1]
        if w[-1] in _VOWELS:
            break
    return w


def word_to_ipa(word: str) -> str:
    hit = _LEXICON.get(word)
    if hit is not None:
        return hit
    if "'" in word:
        head, _, tail = word.partition("'")
        onset = _ELISION.get(head)
        if onset is not None and tail:
            return onset + word_to_ipa(tail)
    units, flags = _scan(_strip_endings(word))
    nuclei = [k for k, f in enumerate(flags) if f]
    ipa = "".join(units)
    if len(nuclei) < 2:
        return ipa
    # final-syllable prominence, skipping a word-final schwa nucleus
    target = nuclei[-1]
    if units[target] == "ə" and len(nuclei) >= 2:
        target = nuclei[-2]
    from .rule_g2p import place_stress

    return place_stress(units, flags, target, liquids=("ʁ", "l"))


_ONES = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept",
         "huit", "neuf", "dix", "onze", "douze", "treize", "quatorze",
         "quinze", "seize", "dix-sept", "dix-huit", "dix-neuf"]
_TENS = ["", "", "vingt", "trente", "quarante", "cinquante", "soixante"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "moins " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 70:
        t, o = divmod(num, 10)
        if o == 0:
            return _TENS[t]
        if o == 1:
            return _TENS[t] + " et un"
        return _TENS[t] + "-" + _ONES[o]
    if num < 80:  # soixante-dix .. soixante-dix-neuf
        if num == 71:
            return "soixante et onze"
        return "soixante-" + _ONES[num - 60]
    if num < 100:  # quatre-vingts .. quatre-vingt-dix-neuf
        r = num - 80
        if r == 0:
            return "quatre-vingts"
        return "quatre-vingt-" + _ONES[r]
    if num < 1000:
        h, r = divmod(num, 100)
        head = "cent" if h == 1 else _ONES[h] + " cent"
        if r == 0:
            return head + ("s" if h > 1 else "")
        return head + " " + number_to_words(r)
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "mille" if k == 1 else number_to_words(k) + " mille"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = "un million" if m == 1 else number_to_words(m) + " millions"
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    # typographic apostrophe → ASCII so elision tokens (l’homme) survive
    # the tokenizer's [\w']+ word pattern
    text = text.replace("’", "'")
    from .numerics import expand_numerics, fr_grammar

    text = expand_numerics(text, fr_grammar())
    return expand_numbers(text, number_to_words).lower()
