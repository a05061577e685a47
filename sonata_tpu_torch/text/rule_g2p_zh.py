"""Mandarin (pinyin input) letter-to-sound rules for the hermetic G2P.

Hanzi→pronunciation genuinely requires a dictionary (eSpeak vendors a
large ``zh_dict``; no rule system substitutes), so this pack covers the
romanized half of the problem: pinyin — with tone diacritics (nǐ hǎo),
tone digits (ni3 hao3), or toneless — parses into
initial + final + tone and renders broad Mandarin IPA with Chao
tone letters (˥ ˧˥ ˨˩˦ ˥˩).  Hanzi input raises
:class:`~sonata_tpu_torch.core.PhonemizationError` with a message saying so,
rather than silently emitting garbage.

Reference: ``/root/reference/deps/dev/espeak-ng-data`` (zh voice).
"""

from __future__ import annotations

import re
import unicodedata

_TONE_DIACRITICS = {"̄": "1", "́": "2", "̌": "3", "̀": "4"}
_TONES = {"1": "˥", "2": "˧˥", "3": "˨˩˦", "4": "˥˩", "5": "", "0": ""}

_INITIALS = [
    ("zh", "ʈʂ"), ("ch", "ʈʂʰ"), ("sh", "ʂ"),
    ("b", "p"), ("p", "pʰ"), ("m", "m"), ("f", "f"),
    ("d", "t"), ("t", "tʰ"), ("n", "n"), ("l", "l"),
    ("g", "k"), ("k", "kʰ"), ("h", "x"),
    ("j", "tɕ"), ("q", "tɕʰ"), ("x", "ɕ"),
    ("r", "ʐ"), ("z", "ts"), ("c", "tsʰ"), ("s", "s"),
]

# finals, longest first; ü is written v in ASCII pinyin
_FINALS = [
    ("iang", "jaŋ"), ("iong", "jʊŋ"), ("uang", "waŋ"), ("ueng", "wəŋ"),
    ("ang", "aŋ"), ("eng", "əŋ"), ("ong", "ʊŋ"),
    ("iao", "jau"), ("ian", "jɛn"), ("uai", "wai"), ("uan", "wan"),
    ("üan", "ɥɛn"), ("van", "ɥɛn"),
    ("ai", "ai"), ("ei", "ei"), ("ao", "au"), ("ou", "ou"),
    ("an", "an"), ("en", "ən"), ("er", "ɚ"),
    ("ia", "ja"), ("ie", "jɛ"), ("iu", "jou"), ("iou", "jou"),
    ("in", "in"), ("ing", "iŋ"),
    ("ua", "wa"), ("uo", "wo"), ("ui", "wei"), ("uei", "wei"),
    ("un", "wən"), ("uen", "wən"),
    ("üe", "ɥɛ"), ("ve", "ɥɛ"), ("ün", "yn"), ("vn", "yn"),
    ("a", "a"), ("o", "o"), ("e", "ɤ"), ("i", "i"), ("u", "u"),
    ("ü", "y"), ("v", "y"),
]
# after the sibilant series, "i" is the apical vowel ɨ
_APICAL_AFTER = {"ʈʂ", "ʈʂʰ", "ʂ", "ʐ", "ts", "tsʰ", "s"}
# after the palatal series (and y-), written u is actually ü
_PALATALS = {"tɕ", "tɕʰ", "ɕ"}


def _tone_split(syl: str) -> tuple[str, str]:
    """Strip a tone digit or diacritic; returns (toneless, chao)."""
    if syl and syl[-1] in "012345":
        return syl[:-1], _TONES.get(syl[-1], "")
    tone = ""
    out = []
    for ch in unicodedata.normalize("NFD", syl):
        d = _TONE_DIACRITICS.get(ch)
        if d is not None:
            tone = _TONES[d]
            continue
        out.append(ch)
    return unicodedata.normalize("NFC", "".join(out)), tone


def _syllable_to_ipa(syl: str) -> str:
    syl, tone = _tone_split(syl)
    if not syl:
        return ""
    out = []
    # y-/w- spellings rewrite to their bare-final forms and parse
    # through the same table (yue → üe, ying → ing, wang → uang)
    if syl.startswith("yu"):
        syl = "ü" + syl[2:]
    elif syl.startswith("yi"):
        syl = "i" + syl[2:]
    elif syl.startswith("y"):
        syl = "i" + syl[1:]
    elif syl.startswith("wu"):
        syl = "u" + syl[2:]
    elif syl.startswith("w"):
        syl = "u" + syl[1:]
    else:
        for spelling, ipa in _INITIALS:
            if syl.startswith(spelling):
                out.append(ipa)
                syl = syl[len(spelling):]
                break
        if out and out[-1] in _PALATALS and syl.startswith("u"):
            syl = "ü" + syl[1:]  # ju/qu/xu spell ü
    # "ia"-initial bare finals ride the i→j rows already; "ua" the u→w
    final_matched = False
    for spelling, ipa in _FINALS:
        if syl == spelling:
            if ipa == "i" and out and out[-1] in _APICAL_AFTER:
                ipa = "ɨ"
            out.append(ipa)
            final_matched = True
            break
    if not final_matched:
        return ""  # a bare initial or stray letters is not a syllable
    return "".join(out) + tone


_HAN_RE = re.compile(r"[一-鿿㐀-䶿]")


def word_to_ipa(word: str) -> str:
    """One token: either a single pinyin syllable or a run of syllables
    (greedy split on tone digits/diacritics; hyphens and apostrophes
    arrive pre-split by the tokenizer)."""
    word = unicodedata.normalize("NFC", word)
    if _HAN_RE.search(word):
        from ..core import PhonemizationError

        raise PhonemizationError(
            "hanzi input needs a pronunciation dictionary the hermetic "
            "backend cannot carry — supply pinyin (tone digits or "
            "diacritics), or install eSpeak-ng with zh data")
    # split a multi-syllable run at tone digits first (ni3hao3)
    parts = re.split(r"(?<=[0-5])", word)
    out = []
    for part in parts:
        if not part:
            continue
        ipa = _syllable_to_ipa(part)
        if ipa:
            out.append(ipa)
            continue
        # greedy left-to-right syllable scan for unsegmented runs
        rest = part
        while rest:
            for ln in range(min(6, len(rest)), 0, -1):
                ipa = _syllable_to_ipa(rest[:ln])
                if ipa:
                    out.append(ipa)
                    rest = rest[ln:]
                    break
            else:
                rest = rest[1:]  # skip one char, keep trying
    return "".join(out)


_DIGITS = ["líng", "yī", "èr", "sān", "sì", "wǔ", "liù", "qī", "bā",
           "jiǔ", "shí"]


def _tail(r: int) -> str:
    """Mid-number remainder: teens read yī shí X, not the word-initial
    bare shí X (111 → yī bǎi yī shí yī)."""
    if 10 <= r < 20:
        return "yī " + number_to_words(r)
    return number_to_words(r)


def number_to_words(num: int) -> str:
    if num < 0:
        return "fù " + number_to_words(-num)
    if num <= 10:
        return _DIGITS[num]
    if num < 20:
        return "shí" + (" " + _DIGITS[num - 10] if num > 10 else "")
    if num < 100:
        t, o = divmod(num, 10)
        return _DIGITS[t] + " shí" + (" " + _DIGITS[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = _DIGITS[h] + " bǎi"
        if r == 0:
            return head
        if r < 10:
            return head + " líng " + _DIGITS[r]
        return head + " " + _tail(r)
    if num < 10_000:
        k, r = divmod(num, 1000)
        head = _DIGITS[k] + " qiān"
        if r == 0:
            return head
        if r < 100:
            return head + " líng " + _tail(r)
        return head + " " + _tail(r)
    wan, r = divmod(num, 10_000)
    head = number_to_words(wan) + " wàn"  # myriad grouping
    if r == 0:
        return head
    if r < 1000:
        return head + " líng " + _tail(r)
    return head + " " + _tail(r)


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
