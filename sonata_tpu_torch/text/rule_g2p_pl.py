"""Polish letter-to-sound rules for the hermetic G2P backend.

Polish orthography is almost perfectly regular and stress is fixed on
the penultimate syllable, making it the most rule-friendly major
language — the reference gets Polish from eSpeak-ng's compiled
``pl_dict`` (``/root/reference/deps/dev/espeak-ng-data``); this module
is the hermetic stand-in producing broad IPA in eSpeak ``pl`` voice
conventions (retroflex series rendered as ʃ/ʒ/tʃ/dʒ, alveolo-palatal
as ɕ/ʑ/tɕ/dʑ).

Covered phenomena: the digraph set (sz, cz, rz, dz, dż, dź, ch), the
soft series via kreska letters (ś ź ć ń) and the i-before-vowel
palatalization spelling (si/zi/ci/ni/dzi + vowel), nasal vowels ą/ę
with the word-final ę denasalisation, ł → w, w → v, y → ɨ, ó → u,
rz devoicing after voiceless obstruents (przy → pʃɨ), word-final
obstruent devoicing, and fixed penultimate stress.
"""

from __future__ import annotations

_VOWEL_LETTERS = "aeiouyóąę"

# word-final devoicing map over emitted IPA units
_DEVOICE = {"b": "p", "d": "t", "ɡ": "k", "v": "f", "z": "s",
            "ʒ": "ʃ", "ʑ": "ɕ", "dʒ": "tʃ", "dʑ": "tɕ", "dz": "ts"}


def _scan(word: str) -> tuple[list[str], list[bool]]:
    """Scan one lowercase word → (units, vowel_flags); unit-based so
    stress placement never splits a digraph phoneme."""
    out: list[str] = []
    flags: list[bool] = []
    i = 0
    n = len(word)

    def emit(s: str, vowel: bool = False) -> None:
        out.append(s)
        flags.append(vowel)

    def soft(base: str) -> str:
        return {"s": "ɕ", "z": "ʑ", "c": "tɕ", "n": "ɲ", "dz": "dʑ"}[base]

    while i < n:
        rest = word[i:]
        ch = word[i]
        nxt = word[i + 1] if i + 1 < n else ""

        # i-before-vowel palatalization spellings (si/zi/ci/ni/dzi+V):
        # the i is a softness mark, not a vowel
        if rest.startswith("dzi"):
            after = word[i + 3] if i + 3 < n else ""
            if after and after in _VOWEL_LETTERS:
                emit(soft("dz")); i += 3; continue
            emit(soft("dz")); emit("i", True); i += 3; continue
        if ch in "szcn" and nxt == "i":
            after = word[i + 2] if i + 2 < n else ""
            if after and after in _VOWEL_LETTERS:
                emit(soft(ch)); i += 2; continue
            emit(soft(ch)); emit("i", True); i += 2; continue

        # digraphs
        if rest.startswith("sz"):
            emit("ʃ"); i += 2; continue
        if rest.startswith("cz"):
            emit("tʃ"); i += 2; continue
        if rest.startswith("rz"):
            prev_unit = out[-1] if out else ""
            # rz devoices after a voiceless obstruent: przy → pʃɨ
            emit("ʃ" if prev_unit in ("p", "t", "k", "x", "f", "s")
                 else "ʒ")
            i += 2
            continue
        if rest.startswith("dż"):
            emit("dʒ"); i += 2; continue
        if rest.startswith("dź"):
            emit("dʑ"); i += 2; continue
        if rest.startswith("dz"):
            emit("dz"); i += 2; continue
        if rest.startswith("ch"):
            emit("x"); i += 2; continue

        # kreska softs and special letters
        if ch == "ś":
            emit("ɕ"); i += 1; continue
        if ch == "ź":
            emit("ʑ"); i += 1; continue
        if ch == "ć":
            emit("tɕ"); i += 1; continue
        if ch == "ń":
            emit("ɲ"); i += 1; continue
        if ch == "ż":
            emit("ʒ"); i += 1; continue
        if ch == "ł":
            emit("w"); i += 1; continue
        if ch == "w":
            emit("v"); i += 1; continue
        if ch == "c":
            emit("ts"); i += 1; continue
        if ch == "h":
            emit("x"); i += 1; continue
        if ch == "j":
            emit("j"); i += 1; continue
        if ch == "y":
            emit("ɨ", True); i += 1; continue
        if ch == "ó":
            emit("u", True); i += 1; continue
        if ch == "ą":
            # word-final or before fricative: nasal ɔ̃; before a stop it
            # surfaces as om/on — broad IPA keeps ɔ̃ everywhere
            emit("ɔ̃", True); i += 1; continue
        if ch == "ę":
            if i + 1 == n:
                emit("ɛ", True)  # final ę denasalises in speech
            else:
                emit("ɛ̃", True)
            i += 1
            continue
        if ch == "e":
            emit("ɛ", True); i += 1; continue
        if ch == "o":
            emit("ɔ", True); i += 1; continue
        if ch == "i":
            if nxt and nxt in _VOWEL_LETTERS:
                emit("j")  # i before vowel is the palatal glide: miasto
            else:
                emit("i", True)
            i += 1
            continue
        if ch in "au":
            emit(ch, True); i += 1; continue
        simple = {"b": "b", "d": "d", "f": "f", "g": "ɡ", "k": "k",
                  "l": "l", "m": "m", "n": "n", "p": "p", "r": "r",
                  "s": "s", "t": "t", "z": "z"}
        if ch in simple:
            emit(simple[ch])
        i += 1

    # word-final obstruent devoicing (chleb → xlɛp)
    if out and out[-1] in _DEVOICE:
        out[-1] = _DEVOICE[out[-1]]
    return out, flags


def word_to_ipa(word: str) -> str:
    units, flags = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    ipa = "".join(units)
    if len(nuclei) < 2:
        return ipa
    target = nuclei[-2]  # fixed penultimate stress
    from .rule_g2p import place_stress

    return place_stress(units, flags, target,
                        liquids=("r", "l", "w", "j"))


_ONES = ["zero", "jeden", "dwa", "trzy", "cztery", "pięć", "sześć",
         "siedem", "osiem", "dziewięć", "dziesięć", "jedenaście",
         "dwanaście", "trzynaście", "czternaście", "piętnaście",
         "szesnaście", "siedemnaście", "osiemnaście", "dziewiętnaście"]
_TENS = ["", "", "dwadzieścia", "trzydzieści", "czterdzieści",
         "pięćdziesiąt", "sześćdziesiąt", "siedemdziesiąt",
         "osiemdziesiąt", "dziewięćdziesiąt"]
_HUNDREDS = ["", "sto", "dwieście", "trzysta", "czterysta", "pięćset",
             "sześćset", "siedemset", "osiemset", "dziewięćset"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "minus " + number_to_words(-num)
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
            head = "tysiąc"
        elif k % 10 in (2, 3, 4) and k % 100 not in (12, 13, 14):
            head = number_to_words(k) + " tysiące"
        else:
            head = number_to_words(k) + " tysięcy"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    if m == 1:
        head = "milion"
    elif m % 10 in (2, 3, 4) and m % 100 not in (12, 13, 14):
        head = number_to_words(m) + " miliony"  # paucal, like tysiące
    else:
        head = number_to_words(m) + " milionów"
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
