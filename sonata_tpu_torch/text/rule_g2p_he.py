"""Hebrew letter-to-sound rules for the hermetic G2P backend.

Modern Hebrew is an abjad: everyday text is unvocalized, so — like the
Persian pack (:mod:`.rule_g2p_fa`) — this renders the consonant
skeleton with matres lectionis (י between consonants → i, ו → o) and
an epenthetic e over illegal clusters; niqqud marks are honored when
present.  The reference reaches Hebrew through eSpeak's ``he_dict``
(``/root/reference/deps/dev/espeak-ng-data``); broad Israeli values
(ר → ʁ, no pharyngeals: ח → x, ע → ʔ).

Covered phenomena: the final letter forms (ך ם ן ף ץ), begadkefat
spirantization kept broad (ב → v / b word-initially, כ → x / k
word-initially, פ → f / p word-initially), שׁ/שׂ defaulting to ʃ,
niqqud vowels incl. shva as e, and the ה → a reading word-finally.
"""

from __future__ import annotations

_LETTERS = {
    "א": "ʔ", "ב": "v", "ג": "ɡ", "ד": "d", "ה": "h", "ו": "v",
    "ז": "z", "ח": "x", "ט": "t", "י": "j", "כ": "x", "ך": "x",
    "ל": "l", "מ": "m", "ם": "m", "נ": "n", "ן": "n", "ס": "s",
    "ע": "ʔ", "פ": "f", "ף": "f", "צ": "ts", "ץ": "ts", "ק": "k",
    "ר": "ʁ", "ש": "ʃ", "ת": "t",
}
# word-initial (no preceding vowel letter) begadkefat read as stops
_INITIAL_STOPS = {"ב": "b", "כ": "k", "פ": "p"}

# niqqud combining marks → vowels ("" = silent shva treated as e-ish)
_NIQQUD = {"ַ": "a", "ָ": "a", "ֶ": "e", "ֵ": "e", "ִ": "i",
           "ֹ": "o", "ֻ": "u", "ְ": "e", "ֲ": "a", "ֱ": "e",
           "ֳ": "o", "ּ": "", "ׁ": "", "ׂ": ""}

_VOWELS = ("a", "e", "i", "o", "u")


def word_to_ipa(word: str) -> str:
    units: list[str] = []
    flags: list[bool] = []
    raw: list[str] = []
    has_niqqud = any(_NIQQUD.get(ch) for ch in word)
    chars = list(word)
    for k, ch in enumerate(chars):
        nq = _NIQQUD.get(ch)
        if nq is not None:
            if nq:
                units.append(nq)
                flags.append(True)
                raw.append(ch)
            continue
        ipa = _LETTERS.get(ch)
        if ipa is None:
            continue
        nxt = chars[k + 1] if k + 1 < len(chars) else ""
        if ch == "ו" and nxt == "ֹ":
            continue  # holam male: the mark alone reads o
        if ch == "ו" and nxt == "ּ":
            units.append("u")  # shuruk: vav + dagesh is the vowel u
            flags.append(True)
            raw.append(ch)
            continue
        if ch in _INITIAL_STOPS and not units:
            ipa = _INITIAL_STOPS[ch]
        units.append(ipa)
        flags.append(False)
        raw.append(ch)
    # final ה: silent after an explicit vowel (qamats-he), read as the
    # vowel a after a consonant (שרה → saʁa)
    if raw and raw[-1] == "ה" and len(units) >= 2 and units[-1] == "h":
        if flags[-2]:
            units.pop(); flags.pop(); raw.pop()
        else:
            units[-1] = "a"
            flags[-1] = True
    if not has_niqqud:
        # matres lectionis: י between consonants → i, ו → o
        for k, (u, ch) in enumerate(zip(units, raw)):
            prev_v = k > 0 and flags[k - 1]
            next_v = k + 1 < len(units) and flags[k + 1]
            if ch == "י" and not prev_v and not next_v and k > 0:
                units[k] = "i"  # word-initial yod stays the glide j
                flags[k] = True
            elif ch == "ו" and not prev_v and not next_v and k > 0:
                units[k] = "o"
                flags[k] = True
        # epenthesis via the shared helper; Hebrew words essentially
        # never end in clusters (עולם → ʔolem, ספר → sefeʁ)
        from .rule_g2p import epenthesize_runs

        return epenthesize_runs(units, flags,
                                final_cluster_ok=lambda run: False)
    return "".join(units)


_ONES = ["אפס", "אחת", "שתיים", "שלוש", "ארבע", "חמש", "שש", "שבע",
         "שמונה", "תשע", "עשר"]
_TEENS = ["", "אחת עשרה", "שתים עשרה", "שלוש עשרה", "ארבע עשרה",
          "חמש עשרה", "שש עשרה", "שבע עשרה", "שמונה עשרה",
          "תשע עשרה"]
_TENS = ["", "עשר", "עשרים", "שלושים", "ארבעים", "חמישים", "שישים",
         "שבעים", "שמונים", "תשעים"]
# masculine forms: thousands take the construct (שלושת אלפים),
# millions the absolute (שלושה מיליון)
_MASC = {2: "שני", 3: "שלושה", 4: "ארבעה", 5: "חמישה", 6: "שישה",
         7: "שבעה", 8: "שמונה", 9: "תשעה", 10: "עשרה"}
_MASC_CONSTRUCT = {3: "שלושת", 4: "ארבעת", 5: "חמשת", 6: "ששת",
                   7: "שבעת", 8: "שמונת", 9: "תשעת", 10: "עשרת"}


def number_to_words(num: int) -> str:
    """Feminine counting forms (the default for bare numbers)."""
    if num < 0:
        return "מינוס " + number_to_words(-num)
    if num <= 10:
        return _ONES[num]
    if num < 20:
        return _TEENS[num - 10]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" ו" + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = ("מאה" if h == 1 else
                "מאתיים" if h == 2 else _ONES[h] + " מאות")
        return head + (" ו" + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        if k == 1:
            head = "אלף"
        elif k == 2:
            head = "אלפיים"
        elif k <= 10:
            head = _MASC_CONSTRUCT[k] + " אלפים"  # שלושת אלפים
        else:
            head = number_to_words(k) + " אלף"
        return head + (" ו" + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    if m == 1:
        head = "מיליון"
    elif m <= 10:
        head = _MASC[m] + " מיליון"  # masculine: שני מיליון
    else:
        head = number_to_words(m) + " מיליון"
    return head + (" ו" + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
