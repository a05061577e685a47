"""Korean letter-to-sound rules for the hermetic G2P backend.

Hangul is fully algorithmic: each precomposed syllable block decomposes
arithmetically into (initial, vowel, final) jamo, so G2P needs no
dictionary at all — only the jamo tables plus the regular liaison and
assimilation sandhi at syllable boundaries.  The reference reaches
Korean through eSpeak's ``ko_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``ko`` conventions.

Covered phenomena: the 19/21/28 jamo tables (tense consonants as
C͈ kept broad as doubled-free single symbols, aspirates as Cʰ),
liaison (final consonant resyllabifies before a vowel-initial
syllable), nasal assimilation (ㄱ/ㄷ/ㅂ before ㄴ/ㅁ → ŋ/n/m), and the
final-position neutralization of obstruents.
"""

from __future__ import annotations

_S_BASE = 0xAC00
_L_TABLE = ["k", "k͈", "n", "t", "t͈", "r", "m", "p", "p͈", "s", "s͈",
            "", "tɕ", "tɕ͈", "tɕʰ", "kʰ", "tʰ", "pʰ", "h"]
_V_TABLE = ["a", "ɛ", "ja", "jɛ", "ʌ", "e", "jʌ", "je", "o", "wa",
            "wɛ", "ø", "jo", "u", "wʌ", "we", "wi", "ju", "ɯ", "ɰi",
            "i"]
# final (batchim) jamo → neutralized coda sound ("" = none)
_T_TABLE = ["", "k", "k", "k", "n", "n", "n", "t", "l", "k", "m",
            "l", "l", "l", "p", "l", "m", "p", "p", "t", "t", "ŋ",
            "t", "t", "k", "t", "p", "t"]
# coda that resyllabifies (liaison) keeps its full onset value
_T_ONSET = ["", "k", "k͈", "ks", "n", "ntɕ", "nh", "t", "r", "lk",
            "lm", "lp", "ls", "ltʰ", "lpʰ", "lh", "m", "p", "ps",
            "s", "s͈", "ŋ", "tɕ", "tɕʰ", "kʰ", "tʰ", "pʰ", "h"]

_NASALS = {"n", "m"}
_NASALIZE = {"k": "ŋ", "t": "n", "p": "m"}


def _decompose(ch: str):
    code = ord(ch) - _S_BASE
    if 0 <= code < 11172:
        l, rem = divmod(code, 588)
        v, t = divmod(rem, 28)
        return l, v, t
    return None


def word_to_ipa(word: str) -> str:
    syls = [_decompose(ch) for ch in word]
    out: list[str] = []
    for k, s in enumerate(syls):
        if s is None:
            continue
        l, v, t = s
        nxt = syls[k + 1] if k + 1 < len(syls) else None
        # onset; between vowels the lax stops voice (broad: leave as-is)
        onset = _L_TABLE[l]
        out.append(onset)
        out.append(_V_TABLE[v])
        if t == 0:
            continue
        if nxt is not None and nxt[0] == 11:  # next onset is ㅇ (null)
            out.append(_T_ONSET[t])  # liaison: full value carries over
            continue
        coda = _T_TABLE[t]
        if nxt is not None and _L_TABLE[nxt[0]] and \
                _L_TABLE[nxt[0]][0] in _NASALS and coda in _NASALIZE:
            coda = _NASALIZE[coda]  # 합니다 → hamnida
        out.append(coda)
    return "".join(out)


_ONES = ["영", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]


def number_to_words(num: int) -> str:
    """Sino-Korean numerals (the system used for reading digits)."""
    if num < 0:
        return "마이너스 " + number_to_words(-num)
    if num < 10:
        return _ONES[num]
    parts = []
    units = [(100_000_000, "억"), (10_000, "만"), (1000, "천"),
             (100, "백"), (10, "십")]
    for base, name in units:
        d, num = divmod(num, base)
        if d == 0:
            continue
        if d == 1 and base < 10_000:
            parts.append(name)  # 일 drops before 십/백/천 only
        elif d == 1:
            parts.append("일" + name)  # 일만, 일억
        else:
            parts.append(number_to_words(d) + name)
    if num:
        parts.append(_ONES[num])
    return "".join(parts) if parts else _ONES[0]


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
