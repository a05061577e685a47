"""German letter-to-sound rules for the hermetic G2P backend.

German orthography is regular enough that an ordered rule table plus a
small exception lexicon produces usable broad IPA — the reference gets
German from eSpeak-ng's compiled ``de_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this module is the hermetic
stand-in with the same output conventions (eSpeak-style broad IPA with
``ˈ`` stress marks, one space-separated IPA run per word).

Covered phenomena: digraphs/trigraphs (sch, tsch, ch with ich/ach-Laut
context, ck, chs, qu, pf, tz), diphthongs (ei/ai/ey/ay, au, eu/äu),
vowel length (double vowels, vowel+h, ie), word-initial sp-/st- → ʃp/ʃt,
s-voicing before vowels, final devoicing of b/d/g/s, final -er → ɐ and
-e → ə reduction, final -ig → ɪç, umlauts, ß, and default initial stress
skipping the unstressed verbal prefixes (be-, ge-, er-, ver-, zer-,
ent-, emp-, miss-).
"""

from __future__ import annotations

import re

# Small exception lexicon: function words and common irregulars whose
# rule rendering would be wrong.  Stress marks included where polysyllabic.
_LEXICON: dict[str, str] = {
    "der": "dɛɐ", "die": "diː", "das": "das", "und": "ʊnt", "ist": "ɪst",
    "ich": "ɪç", "du": "duː", "er": "eːɐ", "sie": "ziː", "es": "ɛs",
    "wir": "viːɐ", "ihr": "iːɐ", "ein": "aɪn", "eine": "ˈaɪnə",
    "nicht": "nɪçt", "mit": "mɪt", "auf": "aʊf", "für": "fyːɐ",
    "von": "fɔn", "zu": "tsuː", "im": "ɪm", "in": "ɪn", "an": "an",
    "den": "deːn", "dem": "deːm", "des": "dɛs", "was": "vas",
    "wie": "viː", "wo": "voː", "wer": "veːɐ", "hat": "hat",
    "sind": "zɪnt", "war": "vaːɐ", "sein": "zaɪn", "auch": "aʊx",
    "aber": "ˈaːbɐ", "oder": "ˈoːdɐ", "wenn": "vɛn", "nur": "nuːɐ",
    "noch": "nɔx", "nach": "naːx", "bei": "baɪ", "aus": "aʊs",
    "um": "ʊm", "am": "am", "als": "als", "so": "zoː", "man": "man",
    "über": "ˈyːbɐ", "vor": "foːɐ", "durch": "dʊʁç", "kann": "kan",
    "haben": "ˈhaːbən", "werden": "ˈveːɐdən", "wird": "vɪʁt",
    "nein": "naɪn", "ja": "jaː", "gut": "ɡuːt", "tag": "taːk",
    "hallo": "haˈloː", "welt": "vɛlt", "heute": "ˈhɔʏtə",
    "morgen": "ˈmɔʁɡən", "sprache": "ˈʃpʁaːxə", "deutsch": "dɔʏtʃ",
    "jahr": "jaːɐ", "zeit": "tsaɪt", "mensch": "mɛnʃ",
    "wasser": "ˈvasɐ", "himmel": "ˈhɪməl",
}

_VOWEL_LETTERS = "aeiouäöüy"
_IPA_VOWELS = "aeiouɛɪɔʊœʏəɐyø"

# Unstressed prefixes: default stress lands on the syllable after them.
_UNSTRESSED_PREFIXES = ("be", "ge", "er", "ver", "zer", "ent", "emp", "miss")


def _is_back_context(prev_ipa: str) -> bool:
    """ach-Laut after back vowels a/o/u/au, ich-Laut elsewhere."""
    for back in ("aʊ", "aː", "oː", "uː", "a", "ɔ", "ʊ"):
        if prev_ipa.endswith(back):
            # aʊ ends in ʊ but ɔʏ must stay front: checked first, so fine
            return True
    return False


def _scan(word: str) -> str:
    # doubled consonant letters read as one sound (they mark the preceding
    # vowel short, which is already the default here); real digraphs with
    # doubled letters (ck, tz) are handled explicitly before this matters
    word = re.sub(r"([bdfghj-np-tvwxz])\1", r"\1", word)
    out: list[str] = []
    i = 0
    n = len(word)
    while i < n:
        rest = word[i:]
        prev = out[-1] if out else ""
        at_start = i == 0
        nxt = word[i + 1] if i + 1 < n else ""

        # trigraphs / clusters, longest first
        if rest.startswith("tsch"):
            out.append("tʃ"); i += 4; continue
        if rest.startswith("sch"):
            out.append("ʃ"); i += 3; continue
        if rest.startswith("chs"):
            out.append("ks"); i += 3; continue
        if rest.startswith("ch"):
            out.append("x" if _is_back_context(prev) else "ç"); i += 2; continue
        if rest.startswith("ck"):
            out.append("k"); i += 2; continue
        if rest.startswith("qu"):
            out.append("kv"); i += 2; continue
        if rest.startswith("pf"):
            out.append("pf"); i += 2; continue
        if rest.startswith("tz"):
            out.append("ts"); i += 2; continue
        if rest.startswith("ph"):
            out.append("f"); i += 2; continue
        if rest.startswith("th"):
            out.append("t"); i += 2; continue
        if rest == "dt":  # final -dt reads /t/ ("Stadt")
            out.append("t"); i += 2; continue
        if rest.startswith("ng"):
            out.append("ŋ"); i += 2; continue
        if at_start and rest.startswith("sp"):
            out.append("ʃp"); i += 2; continue
        if at_start and rest.startswith("st"):
            out.append("ʃt"); i += 2; continue

        # diphthongs
        if rest.startswith(("ei", "ai", "ey", "ay")):
            out.append("aɪ"); i += 2; continue
        if rest.startswith(("eu", "äu")):
            out.append("ɔʏ"); i += 2; continue
        if rest.startswith("au"):
            out.append("aʊ"); i += 2; continue
        if rest.startswith("ie"):
            out.append("iː"); i += 2; continue

        # long vowels: doubled or vowel+h (the h is silent)
        for dv, ipa in (("aa", "aː"), ("ee", "eː"), ("oo", "oː")):
            if rest.startswith(dv):
                out.append(ipa); i += 2; break
        else:
            if word[i] in _VOWEL_LETTERS and nxt == "h":
                long_map = {"a": "aː", "e": "eː", "i": "iː", "o": "oː",
                            "u": "uː", "ä": "ɛː", "ö": "øː", "ü": "yː"}
                out.append(long_map.get(word[i], word[i])); i += 2; continue

            ch = word[i]
            # word-final reductions
            if ch == "e" and i == n - 1:
                out.append("ə"); i += 1; continue
            if rest == "er":
                out.append("ɐ"); i += 2; continue
            if rest == "ig":
                out.append("ɪç"); i += 2; continue
            # unstressed final syllables -en/-el/-em/-es reduce to schwa
            if i > 0 and rest in ("en", "el", "em", "es"):
                out.append("ə" + {"n": "n", "l": "l", "m": "m",
                                  "s": "s"}[rest[1]])
                i += 2
                continue

            # final devoicing
            if i == n - 1 and ch in "bdgs":
                out.append({"b": "p", "d": "t", "g": "k", "s": "s"}[ch])
                i += 1
                continue

            simple = {
                "a": "a", "e": "ɛ", "i": "ɪ", "o": "ɔ", "u": "ʊ",
                "ä": "ɛ", "ö": "œ", "ü": "ʏ", "y": "ʏ",
                "b": "b", "d": "d", "f": "f", "g": "ɡ", "h": "h",
                "j": "j", "k": "k", "l": "l", "m": "m", "n": "n",
                "p": "p", "r": "ʁ", "t": "t",
                "v": "f", "w": "v", "x": "ks", "z": "ts", "ß": "s",
                "c": "k", "q": "k",
            }
            if ch == "s":
                # voiced before a vowel, voiceless otherwise
                out.append("z" if nxt in _VOWEL_LETTERS else "s")
                i += 1
                continue
            out.append(simple.get(ch, ""))
            i += 1
    return "".join(out)


def _nuclei(ipa: str) -> list[int]:
    return [i for i, ch in enumerate(ipa) if ch in _IPA_VOWELS
            and (i == 0 or ipa[i - 1] not in _IPA_VOWELS)]


def _stress(word: str, ipa: str) -> str:
    """Default German stress: first syllable, unless the word starts with
    an unstressed prefix — then the first syllable after it."""
    if "ˈ" in ipa:
        return ipa
    nuclei = _nuclei(ipa)
    if len(nuclei) < 2:
        return ipa
    target = 0
    # stress-attracting Latinate/French suffixes override the initial
    # default: Universität, Nation, studieren, Bäckerei
    if word.endswith(("tion", "sion", "tät")):
        target = len(nuclei) - 1
    elif word.endswith("ieren") and len(nuclei) >= 2:
        target = len(nuclei) - 2
    elif word.endswith("ei") and len(word) > 4:
        target = len(nuclei) - 1
    else:
        for pref in _UNSTRESSED_PREFIXES:
            if word.startswith(pref) and len(word) > len(pref) + 2:
                if pref in ("be", "ge") and word[2] in "iuy":
                    continue  # bei-/beu- are diphthongs, not prefixes
                target = 1
                break
    if target >= len(nuclei):
        target = 0
    if target == 0:
        # first syllable: everything before the first nucleus IS the
        # onset (ˈtsvɪʃən, ˈʃpʁaːxə)
        return "ˈ" + ipa
    pos = nuclei[target]
    # take back a LEGAL onset only: one consonant, extended while the
    # pair is a German onset cluster (ʃC, obstruent+liquid, st, pf, ts)
    # — an unbounded walk dragged codas across the boundary
    # (verstehen → fɛˈʁst…)
    if pos > 0 and ipa[pos - 1] not in _IPA_VOWELS + "ː":
        pos -= 1
        while pos > 0 and ipa[pos - 1] not in _IPA_VOWELS + "ː":
            pair = ipa[pos - 1] + ipa[pos]
            if pair in ("ʃp", "ʃt", "ʃm", "ʃn", "ʃv", "ʃl", "ʃʁ",
                        "tʃ", "ts", "pf", "st", "sp") or \
                    (pair[0] in "pbtdkɡf" and pair[1] in "ʁl"):
                pos -= 1
            else:
                break
    return ipa[:pos] + "ˈ" + ipa[pos:]


def word_to_ipa(word: str) -> str:
    hit = _LEXICON.get(word)
    if hit is not None:
        return hit
    return _stress(word, _scan(word))


_ONES = ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben",
         "acht", "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn",
         "fünfzehn", "sechzehn", "siebzehn", "achtzehn", "neunzehn"]
_TENS = ["", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig",
         "siebzig", "achtzig", "neunzig"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "minus " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        if o == 0:
            return _TENS[t]
        unit = "ein" if o == 1 else _ONES[o]
        return unit + "und" + _TENS[t]
    if num < 1000:
        h, r = divmod(num, 100)
        head = ("ein" if h == 1 else _ONES[h]) + "hundert"
        return head + (number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = ("ein" if k == 1 else number_to_words(k)) + "tausend"
        return head + (number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("eine million" if m == 1
            else number_to_words(m) + " millionen")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .numerics import de_grammar, expand_numerics
    from .rule_g2p import expand_numbers

    text = expand_numerics(text, de_grammar())
    return expand_numbers(text, number_to_words).lower()
