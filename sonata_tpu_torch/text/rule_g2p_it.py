"""Italian letter-to-sound rules for the hermetic G2P backend.

Italian orthography, like Spanish, is close to phonemic, so a rule table
approaches eSpeak quality without dictionary data — the reference gets
Italian from eSpeak-ng's compiled ``it_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this module is the hermetic
stand-in, producing broad IPA matching eSpeak ``it`` voice conventions.

Covered phenomena: soft c/g before front vowels (tʃ/dʒ) with silent
mute-i (``ciao`` → tʃao), digraphs/trigraphs (ch, gh, gn, gli, sci/sce),
qu → kw, word-initial z → dz vs internal ts, intervocalic s-voicing,
geminate consonants as length (Cː), silent h, written-accent stress with
open-mid è/ò qualities, and the penultimate default stress rule.
"""

from __future__ import annotations

_ACCENT_MAP = {"à": ("a", "a"), "è": ("e", "ɛ"), "é": ("e", "e"),
               "ì": ("i", "i"), "ò": ("o", "ɔ"), "ó": ("o", "o"),
               "ù": ("u", "u")}
_VOWEL_LETTERS = "aeiouàèéìòóù"
_IPA_VOWELS = "aeiouɛɔ"


def _scan(word: str) -> tuple[list[str], list[bool], list[int], int]:
    """Scan one lowercase word → (units, vowel_flags,
    nucleus_start_units, accent_nucleus).

    ``units`` is a list of emitted phoneme strings — each a single scan
    decision, so a multi-char affricate (tʃ) or geminate (kː) is one
    unit and stress placement can never split it.
    ``nucleus_start_units`` are unit indices where each syllable nucleus
    begins (diphthongs with an unstressed weak vowel i/u count once).
    ``accent_nucleus`` is the nucleus carrying a written accent, or -1.
    """
    out: list[str] = []
    vowel_flags: list[bool] = []
    nucleus_pos: list[int] = []
    accent_nucleus = -1
    last_vowel: tuple[str, bool] | None = None
    i = 0
    n = len(word)

    def emit(s: str, vowel: tuple[str, bool] | None = None) -> None:
        nonlocal last_vowel, accent_nucleus
        if vowel is None:
            last_vowel = None
        else:
            letter, accented = vowel
            weak = letter in "iu"
            prev = last_vowel
            same_syllable = False
            if prev is not None:
                prev_weak = prev[0] in "iu"
                same_syllable = (weak and not accented) or (
                    prev_weak and not prev[1])
            if not same_syllable:
                nucleus_pos.append(len(out))
            if accented:
                accent_nucleus = len(nucleus_pos) - 1
            last_vowel = vowel
        out.append(s)
        vowel_flags.append(vowel is not None)

    def emit_consonant(sound: str, advance: int) -> None:
        """Emit a consonant, folding an orthographic geminate (same letter
        doubled) into phonemic length (Cː)."""
        nonlocal i
        start_letter = word[i]
        i += advance
        if i < n and word[i] == start_letter and advance == 1 and \
                start_letter not in _VOWEL_LETTERS:
            i += 1
            emit(sound + "ː")
        else:
            emit(sound)

    while i < n:
        rest = word[i:]
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""
        prev_letter = word[i - 1] if i > 0 else ""

        # trigraphs / digraphs first (longest match)
        if rest.startswith("sci") and i + 3 < n and word[i + 3] in \
                _VOWEL_LETTERS:
            emit("ʃ"); i += 3; continue  # mute i: "lascia" → laʃa
        if rest.startswith("sc") and i + 2 < n and word[i + 2] in "eèéiìy":
            emit("ʃ"); i += 2; continue
        if rest.startswith("gli"):
            after = word[i + 3] if i + 3 < n else ""
            if after and after in _VOWEL_LETTERS:
                emit("ʎ"); i += 3; continue  # mute i: "figlia" → fiʎa
            emit("ʎ"); i += 2; continue      # "gli" final: ʎ + vowel i
        if rest.startswith("gn"):
            emit("ɲ"); i += 2; continue
        if rest.startswith("ch"):
            emit_consonant("k", 2); continue
        if rest.startswith("gh"):
            emit_consonant("ɡ", 2); continue
        if rest.startswith("ci") and i + 2 < n and word[i + 2] in \
                _VOWEL_LETTERS:
            emit("tʃ"); i += 2; continue  # mute i: "ciao" → tʃao
        if rest.startswith("gi") and i + 2 < n and word[i + 2] in \
                _VOWEL_LETTERS:
            emit("dʒ"); i += 2; continue
        if rest.startswith("qu"):
            emit("kw"); i += 2; continue

        if ch == "c":
            if nxt and nxt in "eèéiìy":
                emit_consonant("tʃ", 1)
            else:
                emit_consonant("k", 1)
            continue
        if ch == "g":
            if nxt and nxt in "eèéiìy":
                emit_consonant("dʒ", 1)
            else:
                emit_consonant("ɡ", 1)
            continue
        if ch == "z":
            # word-initial z voices (zero → dzɛro); geminate zz and
            # internal z are voiceless affricates
            if i == 0:
                emit_consonant("dz", 1)
            else:
                emit_consonant("ts", 1)
            continue
        if ch == "s":
            if nxt == "s":
                emit("sː"); i += 2; continue
            if prev_letter and prev_letter in _VOWEL_LETTERS and nxt \
                    and nxt in _VOWEL_LETTERS:
                emit("z"); i += 1; continue  # intervocalic voicing
            if nxt and nxt in "bdɡglmnrv":
                emit("z"); i += 1; continue  # voiced before voiced cons
            emit("s"); i += 1; continue
        if ch == "h":
            i += 1; continue  # silent
        if ch == "r":
            emit_consonant("r", 1); continue
        if ch in _ACCENT_MAP:
            letter, ipa = _ACCENT_MAP[ch]
            emit(ipa, vowel=(letter, True))
            i += 1
            continue
        if ch in "aeiou":
            emit(ch, vowel=(ch, False))
            i += 1
            continue
        simple = {"b": "b", "d": "d", "f": "f", "j": "j", "k": "k",
                  "l": "l", "m": "m", "n": "n", "p": "p", "t": "t",
                  "v": "v", "w": "w", "x": "ks", "y": "i"}
        if ch in simple:
            emit_consonant(simple[ch], 1)
            continue
        i += 1
    return out, vowel_flags, nucleus_pos, accent_nucleus


# Common "parole sdrucciole" — antepenultimate stress that Italian
# orthography does NOT mark (unlike Spanish, which writes the accent).
# The penultimate default is wrong for these; eSpeak gets them from its
# dictionary, the hermetic backend from this list.
_SDRUCCIOLE = frozenset({
    "essere", "piccolo", "piccola", "piccoli", "piccole", "numero",
    "camera", "camere", "musica", "medico", "medici", "ultimo", "ultima",
    "ultimi", "ultime", "subito", "popolo", "tavola", "tavolo", "albero",
    "alberi", "attimo", "facile", "facili", "difficile", "difficili",
    "fragile", "giovane", "giovani", "macchina", "macchine", "pagina",
    "pagine", "possibile", "possibili", "probabile", "rapido", "rapida",
    "secolo", "secoli", "semplice", "semplici", "simile", "simili",
    "solito", "solita", "stupido", "stupida", "telefono", "termine",
    "termini", "timido", "titolo", "titoli", "utile", "utili", "vedova",
    "visita", "zucchero", "angolo", "angoli", "articolo", "articoli",
    "debole", "deboli", "undici", "dodici", "tredici", "quindici",
    "sedici", "opera", "opere", "ordine", "ordini", "isola", "isole",
    "lettera", "lettere", "libero", "libera", "limite", "limiti",
    "massimo", "massima", "minimo", "minima", "monaco", "nobile",
    "nuvola", "nuvole", "ottimo", "ottima", "povero", "povera",
    "pubblico", "pubblica", "regola", "regole", "spirito", "sabato",
    "sindaco", "vescovo", "vittima", "anima", "anime", "genere",
    "generi", "abito", "abiti", "epoca", "modulo", "moduli",
})


def word_to_ipa(word: str) -> str:
    units, vowel_flags, positions, accent = _scan(word)
    ipa = "".join(units)
    if not positions:
        return ipa
    if len(positions) < 2 and accent < 0:
        return ipa
    if accent >= 0:
        target = min(accent, len(positions) - 1)
    elif word in _SDRUCCIOLE and len(positions) >= 3:
        target = len(positions) - 3  # antepenultimate
    else:
        target = len(positions) - 2  # penultimate default
    if target < 0:
        target = 0
    from .rule_g2p import place_stress

    # stop_at_length: a geminate (Cː) closes the PREVIOUS syllable;
    # s_cluster: s-impura clusters start the stressed syllable whole
    return place_stress(units, vowel_flags, positions[target],
                        stop_at_length=True, s_cluster=True)


_ONES = ["zero", "uno", "due", "tre", "quattro", "cinque", "sei", "sette",
         "otto", "nove", "dieci", "undici", "dodici", "tredici",
         "quattordici", "quindici", "sedici", "diciassette", "diciotto",
         "diciannove"]
_TENS = ["", "", "venti", "trenta", "quaranta", "cinquanta", "sessanta",
         "settanta", "ottanta", "novanta"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "meno " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        head = _TENS[t]
        if o == 0:
            return head
        if o in (1, 8):  # vowel elision: ventuno, ventotto
            head = head[:-1]
        tail = _ONES[o]
        if o == 3:
            tail = "tré"  # accent on compound-final tre
        return head + tail
    if num < 1000:
        h, r = divmod(num, 100)
        head = "cento" if h == 1 else _ONES[h] + "cento"
        return head + (number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "mille" if k == 1 else number_to_words(k) + "mila"
        return head + (number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = "un milione" if m == 1 else number_to_words(m) + " milioni"
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
