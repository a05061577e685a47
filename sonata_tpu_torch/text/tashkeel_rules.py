"""Heuristic Arabic diacritization rules.

The reference ships libtashkeel's trained neural model; a real training
corpus (Tashkeela etc.) cannot be fetched in this environment, so the
out-of-the-box Arabic chain uses this deterministic rule engine instead —
a simplified rendering of MSA orthographic regularities:

- the definite article ``ال``: bare alif, lam takes sukun before moon
  letters; before sun letters the lam assimilates and the sun letter
  takes shadda;
- word-final letters take sukun (pausal form); final ``ة`` is preceded
  by fatha;
- long-vowel carriers (ا و ي) after a consonant are left unmarked and
  suppress the preceding default vowel mark where they lengthen it;
- other consonants take a default short vowel chosen per letter class
  (emphatic/pharyngeal → fatha, labial → damma-leaning, else kasra/fatha
  alternation) — deterministic, so output is stable and reversible.

These rules double as the synthetic supervision for the bundled neural
tagger (``tools/train_tashkeel.py``): the tagger learns to reproduce them
exactly, which exercises the full train→save→load→serve loop and gives
``TashkeelEngine`` a functional default model.  Swap in a real
libtashkeel ONNX artifact (``SONATA_TASHKEEL_MODEL``) for production
Arabic quality.
"""

from __future__ import annotations

FATHA, DAMMA, KASRA, SUKUN, SHADDA = "َ", "ُ", "ِ", "ْ", "ّ"
_ALL_MARKS = set("ًٌٍَُِّْـ")  # harakat/tanwin/shadda/sukun/tatweel

ARABIC_LETTERS = set("ءآأؤإئابةتثجحخدذرزسشصضطظعغفقكلمنهويى")
# sun letters assimilate the article's lam (t, th, d, dh, r, z, s, sh,
# s., d., t., z., l, n)
SUN_LETTERS = set("تثدذرزسشصضطظلن")
LONG_VOWELS = set("اويى")
_LENGTHEN_MARK = {"ا": FATHA, "و": DAMMA, "ي": KASRA, "ى": FATHA}
_EMPHATIC = set("صضطظقحعغخ")  # fatha-colored
_LABIAL = set("بمو")          # damma-leaning


def _default_mark(ch: str, idx: int) -> str:
    if ch in _EMPHATIC:
        return FATHA
    if ch in _LABIAL:
        return DAMMA
    return KASRA if idx % 2 else FATHA


FATHATAN, DAMMATAN, KASRATAN = "ً", "ٌ", "ٍ"

# Function words with exact vocalization — the highest-frequency tokens
# of any MSA text, and the ones default-vowel rules garble worst.
FUNCTION_WORDS = {
    "إلى": "إِلَى", "في": "فِي", "على": "عَلَى", "عن": "عَنْ",
    "من": "مِنْ", "أمام": "أَمَامَ", "فوق": "فَوْقَ", "بين": "بَيْنَ",
    "تحت": "تَحْتَ", "مع": "مَعَ", "بعد": "بَعْدَ", "قبل": "قَبْلَ",
    "عند": "عِنْدَ", "هو": "هُوَ", "هي": "هِيَ", "أنا": "أَنَا",
    "نحن": "نَحْنُ", "هذا": "هَذَا", "هذه": "هَذِهِ", "ذلك": "ذَلِكَ",
    "التي": "الَّتِي", "الذي": "الَّذِي", "إن": "إِنَّ", "أن": "أَنَّ",
    "كان": "كَانَ", "قد": "قَدْ", "لا": "لَا", "ما": "مَا",
    "أو": "أَوْ", "يا": "يَا", "ثم": "ثُمَّ", "كل": "كُلُّ",
}
PREPOSITIONS = {"إلى", "في", "على", "عن", "من", "أمام", "فوق", "بين",
                "تحت", "مع", "بعد", "قبل", "عند"}
# prevocalized liaison forms before the definite article's hamzat al-wasl
_BEFORE_ARTICLE = {"من": "مِنَ", "عن": "عَنِ"}

_SENTENCE_ENDERS = set(".!?؟۔\n")


def diacritize_word(word: str, ending: "str | None" = "pausal",
                    verb: bool = False) -> str:
    """Apply the rule set to one undiacritized Arabic word.

    ``ending``: mark string for the final letter — ``"pausal"`` (sukun,
    the context-free default), an explicit case vowel/tanwin, or None for
    bare.  Tanwin fatha on words ending in plain alif lands on the
    preceding consonant, standard orthography.  ``verb=True`` switches
    default medial vowels to the fatha-heavy past-verb pattern (فَعَلَ)
    with form-IV/VIII sukun after an initial alif/hamza.
    """
    out = []
    n = len(word)
    i = 0
    # the definite article may follow a one-letter conjunction/preposition
    # prefix (و ف ب ل ك): وَالقمر, بِالبيت…
    base = 1 if (n > 4 and word[0] in "وفبلك"
                 and word[1:].startswith("ال")) else 0
    article = word.startswith("ال", base) and n - base > 3
    # accusative-tanwin spelling: the ً rides the consonant before a
    # final bare alif (خبزًا، طويلًا)
    tanwin_on_penult = (ending == FATHATAN and n >= 3 and word[-1] == "ا")
    while i < n:
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""
        out.append(ch)
        if ch not in ARABIC_LETTERS:
            i += 1
            continue
        if article and base == 1 and i == 0:  # the prefix letter itself
            out.append(FATHA if ch in "وف" else KASRA)
            i += 1
            continue
        if article and i == base:          # article alif: bare
            i += 1
            continue
        if article and i == base + 1:      # article lam
            if nxt in SUN_LETTERS:
                pass                       # assimilated: no mark on lam
            else:
                out.append(SUKUN)
            i += 1
            continue
        if article and i == base + 2 and ch in SUN_LETTERS:
            out.append(SHADDA)
            if i == n - 1:
                out.append(_ending_mark(ending, ch))
            else:
                out.append(_default_mark(ch, i))
            i += 1
            continue
        if tanwin_on_penult and i == n - 2:
            out.append(FATHATAN)
            i += 1
            continue
        # long-vowel carriers stay bare; و/ي are consonantal (w/y) at
        # word start and as the first stem letter after the article
        # (الْوَلَد), where a long vowel cannot begin a syllable
        if ch in "اىآ" or (ch in "وي" and 0 < i < n - 1
                           and not (article and i == base + 2)):
            i += 1
            continue
        if i == n - 1:                     # word-final letter
            if ch in "اىآ" or (ch in "وي"
                               and ending in (None, "pausal")):
                pass                       # final long vowel: bare (أَبِي)
            else:
                out.append(_ending_mark(ending, ch))
            i += 1
            continue
        if nxt == "ة":                     # fatha before ta marbuta
            out.append(FATHA)
            i += 1
            continue
        if verb and i == 1 and n >= 4 and word[0] in "اأإ":
            out.append(SUKUN)              # انْتظر / أَغْلق augment forms
            i += 1
            continue
        if nxt in LONG_VOWELS:             # lengthened: mark matches vowel
            out.append(_LENGTHEN_MARK.get(nxt, FATHA))
            i += 1
            continue
        out.append(FATHA if verb else _default_mark(ch, i))
        i += 1
    return "".join(out)


def _ending_mark(ending: "str | None", ch: str) -> str:
    if ending is None:
        return ""
    if ending == "pausal":
        return "" if ch == "ة" else SUKUN
    return ending


def _split_conj_prefix(word: str) -> tuple[str, str]:
    """Split a leading single-letter conjunction (و/ف) off ``word`` when
    the remainder is itself a plausible word."""
    if len(word) > 2 and word[0] in "وف" and not word.startswith("ال"):
        rest = word[1:]
        if rest in FUNCTION_WORDS or rest.startswith("ال") or len(rest) >= 3:
            return word[0], rest
    return "", word


def diacritize(text: str) -> str:
    """Rule-diacritize running text; non-Arabic spans pass through.

    Existing diacritics are stripped first (same contract as the neural
    taggers) so pre-marked input is re-diacritized, never double-marked.

    Words are marked with sentence context (the earlier per-word pass
    scored 13.5% case-ending accuracy on the gold corpus — iʿrāb is not a
    word-local property): an exact lexicon covers function words;
    prepositions put the next noun in the genitive (kasra, or kasratan if
    indefinite); a verb-initial sentence reads VSO — first definite noun
    nominative, the next accusative; a definite-noun-initial sentence is
    nominal — subject and indefinite predicate nominative; indefinite
    direct objects take fathatan (on the preceding consonant when spelled
    with final alif); a bare indefinite directly after a tanwin-marked
    noun agrees with it (adjective).
    """
    text = "".join(ch for ch in text if ch not in _ALL_MARKS)
    # tokenize into alternating separators and Arabic words
    tokens: list[tuple[bool, str]] = []  # (is_word, text)
    word: list[str] = []
    for ch in text:
        if ch in ARABIC_LETTERS:
            word.append(ch)
        else:
            if word:
                tokens.append((True, "".join(word)))
                word = []
            if tokens and not tokens[-1][0]:
                tokens[-1] = (False, tokens[-1][1] + ch)
            else:
                tokens.append((False, ch))
    if word:
        tokens.append((True, "".join(word)))

    words = [i for i, (is_w, _) in enumerate(tokens) if is_w]
    out = [t for _, t in tokens]

    # sentence-context state
    first_content = True     # the verb slot of a verbal sentence
    after_prep = False
    nominal = False          # sentence opened with a definite noun
    def_count = 0            # definite nouns seen in this sentence
    last_tanwin: "str | None" = None

    for wi, ti in enumerate(words):
        w = tokens[ti][1]
        nxt_word = tokens[words[wi + 1]][1] if wi + 1 < len(words) else ""
        prefix, core = _split_conj_prefix(w)
        prefix_voc = (prefix + FATHA) if prefix else ""

        if core in FUNCTION_WORDS:
            voc = FUNCTION_WORDS[core]
            if nxt_word.startswith("ال") and core in _BEFORE_ARTICLE:
                voc = _BEFORE_ARTICLE[core]
            out[ti] = prefix_voc + voc
            after_prep = core in PREPOSITIONS
            last_tanwin = None  # function words don't consume the verb slot
        else:
            has_article = (core.startswith("ال") and len(core) > 3) or (
                len(core) > 4 and core[0] in "بلك"
                and core[1:].startswith("ال"))
            genitive_prefix = len(core) > 4 and core[0] in "بل" \
                and core[1:].startswith("ال")
            verb = False
            if has_article:
                if after_prep or genitive_prefix:
                    ending: "str | None" = KASRA
                else:
                    ending = DAMMA if def_count == 0 else FATHA
                    if def_count == 0 and first_content:
                        nominal = True
                def_count += 1
                last_tanwin = None
            elif first_content:
                verb = True
                # suffixed -t verb: liaison kasra before the article's
                # hamzat al-wasl (قَرَأَتِ الْبِنْتُ), pausal sukun else
                ending = (KASRA if core.endswith("ت")
                          and nxt_word.startswith("ال") else
                          (SUKUN if core.endswith("ت") else FATHA))
            elif after_prep:
                ending = KASRATAN
                last_tanwin = KASRATAN
            elif last_tanwin is not None:
                ending = last_tanwin       # adjective agreement
            elif nominal and def_count > 0:
                ending = DAMMATAN          # indefinite predicate
                last_tanwin = DAMMATAN
            elif def_count > 0:
                ending = FATHATAN          # indefinite direct object
                last_tanwin = FATHATAN
            else:
                ending = "pausal"
            out[ti] = prefix_voc + diacritize_word(core, ending=ending,
                                                   verb=verb)
            first_content = False
            after_prep = False

        # sentence boundary resets the syntax state
        if ti + 1 < len(tokens) and not tokens[ti + 1][0] and \
                any(c in _SENTENCE_ENDERS for c in tokens[ti + 1][1]):
            first_content, after_prep = True, False
            nominal, def_count, last_tanwin = False, 0, None

    return "".join(out)
