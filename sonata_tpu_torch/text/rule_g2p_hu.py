"""Hungarian letter-to-sound rules for the hermetic G2P backend.

Hungarian orthography is phonemic with a fixed digraph inventory and
fixed word-initial stress — the reference gets Hungarian from
eSpeak-ng's compiled ``hu_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``hu`` conventions.

Covered phenomena: the digraph/trigraph set (sz → s, zs → ʒ, cs → tʃ,
dzs → dʒ, gy → ɟ, ny → ɲ, ty → c, ly → j, dz), s → ʃ, long consonants
written doubled (including the ssz/nny doubled-digraph spellings),
short-a as ɒ and long á as aː, é → eː, ö/ő → ø/øː, ü/ű → y/yː, and
fixed initial stress.
"""

from __future__ import annotations

_VOWELS = {"a": "ɒ", "á": "aː", "e": "ɛ", "é": "eː", "i": "i",
           "í": "iː", "o": "o", "ó": "oː", "ö": "ø", "ő": "øː",
           "u": "u", "ú": "uː", "ü": "y", "ű": "yː"}

# digraphs/trigraphs, longest first; doubled forms collapse to length
_DIGRAPHS = [
    ("dzs", "dʒ"), ("ssz", "sː"), ("zzs", "ʒː"), ("ccs", "tʃː"),
    ("ggy", "ɟː"), ("nny", "ɲː"), ("tty", "cː"), ("lly", "jː"),
    ("sz", "s"), ("zs", "ʒ"), ("cs", "tʃ"), ("gy", "ɟ"), ("ny", "ɲ"),
    ("ty", "c"), ("ly", "j"), ("dz", "dz"),
]

_CONS = {"b": "b", "c": "ts", "d": "d", "f": "f", "g": "ɡ", "h": "h",
         "j": "j", "k": "k", "l": "l", "m": "m", "n": "n", "p": "p",
         "r": "r", "s": "ʃ", "t": "t", "v": "v", "w": "v", "x": "ks",
         "z": "z"}


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
        hit = False
        for spelling, ipa in _DIGRAPHS:
            if rest.startswith(spelling):
                emit(ipa)
                i += len(spelling)
                hit = True
                break
        if hit:
            continue
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""
        v = _VOWELS.get(ch)
        if v is not None:
            emit(v, True)
            i += 1
            continue
        c = _CONS.get(ch)
        if c is not None:
            if nxt == ch:  # doubled letter → long consonant
                emit(c + "ː")
                i += 2
                continue
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

    return place_stress(units, flags, nuclei[0])  # fixed initial stress


_ONES = ["nulla", "egy", "kettő", "három", "négy", "öt", "hat", "hét",
         "nyolc", "kilenc", "tíz", "tizenegy", "tizenkettő",
         "tizenhárom", "tizennégy", "tizenöt", "tizenhat", "tizenhét",
         "tizennyolc", "tizenkilenc"]
_TENS = ["", "", "húsz", "harminc", "negyven", "ötven", "hatvan",
         "hetven", "nyolcvan", "kilencven"]
_TENS_COMBINED = ["", "", "huszon", "harminc", "negyven", "ötven",
                  "hatvan", "hetven", "nyolcvan", "kilencven"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "mínusz " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        if o == 0:
            return _TENS[t]
        return _TENS_COMBINED[t] + _ONES[o]
    if num < 1000:
        h, r = divmod(num, 100)
        # kettő takes its compound form két before száz/ezer/millió
        head = "száz" if h == 1 else \
            ("két" if h == 2 else _ONES[h]) + "száz"
        return head + (number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        if k == 1:
            head = "ezer"
        elif k == 2:
            head = "kétezer"
        else:
            head = number_to_words(k) + "ezer"
        # Hungarian joins compounds under 2000, hyphen-joins above
        return head + (("-" if num > 2000 else "") + number_to_words(r)
                       if r else "")
    m, r = divmod(num, 1_000_000)
    if m == 1:
        head = "egymillió"
    elif m == 2:
        head = "kétmillió"
    else:
        head = number_to_words(m) + "millió"
    return head + ("-" + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
