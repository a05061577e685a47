"""Persian (Farsi) letter-to-sound rules for the hermetic G2P backend.

Persian uses the Arabic script plus four letters (پ چ ژ گ) and reads
several shared letters differently (و → v, ث/س/ص → s, ذ/ز/ض/ظ → z,
ق/غ → ɢ kept broad as ɣ, ع → ʔ); short vowels are unwritten, so a
vowelless consonant skeleton is rendered with a broad epenthetic e
between consonant clusters (the reference's eSpeak ``fa_dict`` carries
a real vocalization dictionary; this is the hermetic approximation) —
``/root/reference/deps/dev/espeak-ng-data``.

Urdu (ur) extends the same inventory with retroflexes (ٹ ڈ ڑ) and its
own letter shapes (ہ ھ ے ں ک ی); see :data:`_URDU_EXTRA`.
"""

from __future__ import annotations

_LETTERS = {
    "ا": "ɒː", "آ": "ʔɒː", "ب": "b", "پ": "p", "ت": "t", "ث": "s",
    "ج": "dʒ", "چ": "tʃ", "ح": "h", "خ": "x", "د": "d", "ذ": "z",
    "ر": "r", "ز": "z", "ژ": "ʒ", "س": "s", "ش": "ʃ", "ص": "s",
    "ض": "z", "ط": "t", "ظ": "z", "ع": "ʔ", "غ": "ɣ", "ف": "f",
    "ق": "ɣ", "ک": "k", "ك": "k", "گ": "ɡ", "ل": "l", "م": "m",
    "ن": "n", "و": "v", "ه": "h", "ی": "j", "ي": "j", "ء": "ʔ",
    "أ": "ʔ", "ؤ": "ʔ", "ئ": "ʔ", "ة": "e",
    # harakat (rare in Persian text but legal)
    "َ": "æ", "ُ": "o", "ِ": "e", "ّ": "ː", "ْ": "",
}

# Urdu additions/overrides (retroflexes, aspiration marker, yeh/heh forms)
_URDU_EXTRA = {
    "ٹ": "ʈ", "ڈ": "ɖ", "ڑ": "ɽ", "ں": "̃", "ہ": "h", "ھ": "ʰ",
    "ے": "eː", "ۓ": "eː", "ۂ": "h", "و": "ʋ", "ق": "q", "غ": "ɣ",
    "ث": "s", "ا": "aː", "آ": "ʔaː",
}

_VOWELISH = ("ɒː", "aː", "eː", "æ", "e", "o", "i", "u")


def _render(word: str, table: dict) -> str:
    """Map letters, then patch the big unwritten-vowel gap with a
    syllable-shape heuristic: Persian syllables are (C)V(C)(C) — no
    initial clusters — so an initial consonant run gets an epenthetic e
    after its first member, word-internal runs of 3+ break after the
    coda, and a fully vowelless word alternates C e C.  و/ی between
    consonants read as the vowels uː/iː (real vocalization needs the
    dictionary eSpeak carries; this keeps every word speakable)."""
    if word.startswith("ای"):
        word = "ی" + word[2:]  # initial اي is the vowel iː (ایران)
        initial_i = True
    else:
        initial_i = False
    units: list[str] = []
    raw: list[str] = []
    for ch in word:
        ipa = table.get(ch)
        if ipa is None:
            continue
        if ipa == "̃" and units:  # nun ghunna nasalizes the previous
            units[-1] = units[-1] + "̃"
            continue
        if ipa == "ʰ" and units:  # do-chashmi he aspirates the previous
            units[-1] = units[-1] + "ʰ"
            continue
        if not ipa:
            continue  # sukun and other zero-sound marks
        units.append(ipa)
        raw.append(ch)
    # final ه is usually the vowel -e (خانه → xɒːne)
    if word.endswith("ه") and len(units) >= 2 and units[-1] == "h":
        units[-1] = "e"
    # و / ی flanked by consonants (or word edge after a consonant) are
    # the long vowels uː / iː: ممنون → mamnuːn, فارسی → fɒːrsiː
    def vowelish(u: str) -> bool:
        u = u.replace("̃", "")  # a nasalized vowel is still a vowel
        return u in _VOWELISH or (u.endswith("ː") and u[0] in "aeiouɒ")

    for k, (u, ch) in enumerate(zip(units, raw)):
        if ch in "وی" and (k == 0 or not vowelish(units[k - 1])):
            nxt_v = k + 1 < len(units) and vowelish(units[k + 1])
            if not nxt_v:
                nasal = "̃" if "̃" in units[k] else ""
                units[k] = ("uː" if ch == "و" else "iː") + nasal
    if initial_i and units and units[0] == "j":
        units[0] = "iː"
    # epenthesis over consonant runs: shared helper; a final
    # obstruent+sonorant pair is no Persian coda (mɒːder, peder)
    from .rule_g2p import epenthesize_runs

    def coda_ok(run):
        return not (len(run) == 2 and run[1][0] in "rlmn"
                    and run[0][0] not in "rlmnsʃ")

    flags = [vowelish(u) for u in units]
    return epenthesize_runs(units, flags, final_cluster_ok=coda_ok)


_URDU_TABLE = {**_LETTERS, **_URDU_EXTRA}


def word_to_ipa(word: str) -> str:
    return _render(word, _LETTERS)


def word_to_ipa_ur(word: str) -> str:
    return _render(word, _URDU_TABLE)


_ONES = ["صفر", "یک", "دو", "سه", "چهار", "پنج", "شش", "هفت", "هشت",
         "نه", "ده", "یازده", "دوازده", "سیزده", "چهارده", "پانزده",
         "شانزده", "هفده", "هجده", "نوزده"]
_TENS = ["", "", "بیست", "سی", "چهل", "پنجاه", "شصت", "هفتاد",
         "هشتاد", "نود"]
_HUNDREDS = ["", "صد", "دویست", "سیصد", "چهارصد", "پانصد", "ششصد",
             "هفتصد", "هشتصد", "نهصد"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "منفی " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" و " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        return _HUNDREDS[h] + (" و " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "هزار" if k == 1 else number_to_words(k) + " هزار"
        return head + (" و " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("یک میلیون" if m == 1
            else number_to_words(m) + " میلیون")
    return head + (" و " + number_to_words(r) if r else "")


_UR_ONES = ["صفر", "ایک", "دو", "تین", "چار", "پانچ", "چھ", "سات",
            "آٹھ", "نو", "دس", "گیارہ", "بارہ", "تیرہ", "چودہ",
            "پندرہ", "سولہ", "سترہ", "اٹھارہ", "انیس"]
_UR_TENS = ["", "", "بیس", "تیس", "چالیس", "پچاس", "ساٹھ", "ستر",
            "اسی", "نوے"]


def number_to_words_ur(num: int) -> str:
    """Urdu numerals, analytic rendering.  Real Urdu fuses 21-99 into
    irregular forms (تئیس = 23) that need a full table like eSpeak's
    dictionary carries; tens + ones stays intelligible and regular."""
    if num < 0:
        return "مائنس " + number_to_words_ur(-num)
    if num < 20:
        return _UR_ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _UR_TENS[t] + (" " + _UR_ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = "سو" if h == 1 else _UR_ONES[h] + " سو"
        return head + (" " + number_to_words_ur(r) if r else "")
    if num < 100_000:
        k, r = divmod(num, 1000)
        head = number_to_words_ur(k) + " ہزار"
        return head + (" " + number_to_words_ur(r) if r else "")
    lakh, r = divmod(num, 100_000)
    head = number_to_words_ur(lakh) + " لاکھ"
    return head + (" " + number_to_words_ur(r) if r else "")


def _ascii_digits(text: str) -> str:
    for d, a in zip("۰۱۲۳۴۵۶۷۸۹", "0123456789"):
        text = text.replace(d, a)
    for d, a in zip("٠١٢٣٤٥٦٧٨٩", "0123456789"):
        text = text.replace(d, a)
    return text


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(_ascii_digits(text), number_to_words).lower()


def normalize_text_ur(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(_ascii_digits(text),
                          number_to_words_ur).lower()
