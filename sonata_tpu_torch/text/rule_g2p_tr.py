"""Turkish letter-to-sound rules for the hermetic G2P backend.

Turkish's 1928 alphabet reform made the orthography almost perfectly
one-letter-one-sound, so a rule table reaches near-dictionary quality —
the reference gets Turkish from eSpeak-ng's compiled ``tr_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this module is the
hermetic stand-in producing broad IPA in eSpeak ``tr`` conventions.

Covered phenomena: the dotted/dotless i pair (i → i, ı → ɯ), the
rounded front vowels (ö → ø, ü → y), consonant letters c → dʒ, ç → tʃ,
ş → ʃ, j → ʒ, y → j, soft g (ğ) as length on the preceding vowel,
circumflex long vowels (â → aː), front/back allophony of l and k kept
broad, and default final-syllable stress with the place-name/-adverb
penult exceptions left to the (small) exception set.
"""

from __future__ import annotations

_VOWEL_MAP = {"a": "a", "e": "e", "i": "i", "ı": "ɯ", "o": "o",
              "u": "u", "ö": "ø", "ü": "y", "â": "aː", "î": "iː",
              "û": "uː"}
_CONS_MAP = {"b": "b", "c": "dʒ", "ç": "tʃ", "d": "d", "f": "f",
             "g": "ɡ", "h": "h", "j": "ʒ", "k": "k", "l": "l",
             "m": "m", "n": "n", "p": "p", "r": "ɾ", "s": "s",
             "ş": "ʃ", "t": "t", "v": "v", "y": "j", "z": "z"}

# words stressed off the final syllable (adverbs, question particles,
# common loans); value = nucleus index from the END (2 = penultimate)
_STRESS_EXCEPTIONS = {
    "merhaba": 3, "nasıl": 2, "evet": 2, "şimdi": 2, "sonra": 2,
    "yarın": 2, "belki": 2, "ancak": 2, "yalnız": 2, "lütfen": 2,
    "efendim": 2, "tabii": 2, "henüz": 2, "hemen": 2,
}


def _scan(word: str) -> tuple[list[str], list[bool]]:
    """Scan one lowercase word → (units, vowel_flags)."""
    out: list[str] = []
    flags: list[bool] = []
    i = 0
    n = len(word)
    while i < n:
        ch = word[i]
        if ch == "ğ":
            # soft g: lengthens the preceding vowel; word-initial ğ
            # cannot occur in native words — drop it defensively
            if out and flags[-1] and not out[-1].endswith("ː"):
                out[-1] = out[-1] + "ː"
            i += 1
            continue
        v = _VOWEL_MAP.get(ch)
        if v is not None:
            out.append(v)
            flags.append(True)
            i += 1
            continue
        c = _CONS_MAP.get(ch)
        if c is not None:
            out.append(c)
            flags.append(False)
        i += 1
    return out, flags


def word_to_ipa(word: str) -> str:
    units, flags = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    ipa = "".join(units)
    if len(nuclei) < 2:
        return ipa
    from_end = _STRESS_EXCEPTIONS.get(word, 1)
    if from_end > len(nuclei):
        from_end = len(nuclei)
    target = nuclei[-from_end]  # default: final syllable
    from .rule_g2p import place_stress

    # liquids=(): Turkish onsets are single consonants
    return place_stress(units, flags, target, liquids=())


_ONES = ["sıfır", "bir", "iki", "üç", "dört", "beş", "altı", "yedi",
         "sekiz", "dokuz"]
_TENS = ["", "on", "yirmi", "otuz", "kırk", "elli", "altmış", "yetmiş",
         "seksen", "doksan"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "eksi " + number_to_words(-num)
    if num < 10:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = "yüz" if h == 1 else _ONES[h] + " yüz"
        return head + (" " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "bin" if k == 1 else number_to_words(k) + " bin"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = number_to_words(m) + " milyon"
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    # Turkish lowercasing: İ → i, I → ı (str.lower gets this wrong for
    # the dotless pair)
    text = text.replace("İ", "i").replace("I", "ı")
    return expand_numbers(text, number_to_words).lower()
