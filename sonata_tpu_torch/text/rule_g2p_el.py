"""Modern Greek letter-to-sound rules for the hermetic G2P backend.

Modern Greek orthography is phonemically regular (the many historical
vowel spellings all merged into five vowel phonemes), and stress is
written on every polysyllabic word — the reference gets Greek from
eSpeak-ng's compiled ``el_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``el`` conventions.

Covered phenomena: the vowel digraphs (αι → e, ει/οι/υι → i, ου → u),
the αυ/ευ pairs voicing to av/ev before voiced sounds and af/ef before
voiceless, the voiced stop digraphs (μπ → b, ντ → d, γκ/γγ → ɡ), the
fricative system (θ/δ/χ/γ), palatal allophones before front vowels
kept broad, σ-voicing before voiced consonants, and written-accent
stress.
"""

from __future__ import annotations

_VOICELESS_AFTER = set("πτκφθσχξψ")

_ACCENT = {"ά": "α", "έ": "ε", "ή": "η", "ί": "ι", "ό": "ο",
           "ύ": "υ", "ώ": "ω", "ΐ": "ι", "ΰ": "υ"}

_MONO = {"α": "a", "ε": "e", "η": "i", "ι": "i", "ο": "o", "υ": "i",
         "ω": "o"}

_CONS = {"β": "v", "γ": "ɣ", "δ": "ð", "ζ": "z", "θ": "θ", "κ": "k",
         "λ": "l", "μ": "m", "ν": "n", "ξ": "ks", "π": "p", "ρ": "r",
         "σ": "s", "ς": "s", "τ": "t", "φ": "f", "χ": "x", "ψ": "ps"}


def _scan(word: str) -> tuple[list[str], list[bool], int]:
    """Scan one lowercase word → (units, vowel_flags, accent_unit).
    Written accents mark the stressed nucleus directly."""
    out: list[str] = []
    flags: list[bool] = []
    accent_unit = -1
    i = 0
    n = len(word)

    def emit(s: str, vowel: bool = False, accented: bool = False) -> None:
        nonlocal accent_unit
        if vowel and accented:
            accent_unit = len(out)
        out.append(s)
        flags.append(vowel)

    while i < n:
        ch = word[i]
        accented = ch in _ACCENT
        base = _ACCENT.get(ch, ch)
        nxt_raw = word[i + 1] if i + 1 < n else ""
        nxt = _ACCENT.get(nxt_raw, nxt_raw)

        # bare dialytika vowels: always hiatus /i/ (λαϊκός → laikos)
        if ch in "ϊϋ":
            emit("i", True)
            i += 1
            continue
        # vowel digraphs (an accent on the second letter stresses the
        # digraph: αί → accented e; an accent on the FIRST letter marks
        # hiatus — ρολόι — so the pair must NOT merge)
        if base == "α" and nxt == "ι" and not accented:
            emit("e", True, nxt_raw in _ACCENT)
            i += 2
            continue
        if base in "εου" and nxt == "ι" and not accented:
            # ει/οι/υι all merged to /i/
            emit("i", True, nxt_raw in _ACCENT)
            i += 2
            continue
        if base == "ο" and nxt == "υ" and not accented:
            emit("u", True, nxt_raw in _ACCENT)
            i += 2
            continue
        if base in "αε" and nxt == "υ" and not accented:
            after = word[i + 2] if i + 2 < n else ""
            after = _ACCENT.get(after, after)
            v = "a" if base == "α" else "e"
            if after and after in _VOICELESS_AFTER:
                emit(v + "f", True, accented or nxt_raw in _ACCENT)
            else:
                emit(v + "v", True, accented or nxt_raw in _ACCENT)
            i += 2
            continue
        # voiced stop digraphs
        if base == "μ" and nxt == "π":
            emit("b"); i += 2; continue
        if base == "ν" and nxt == "τ":
            emit("d"); i += 2; continue
        if base == "γ" and nxt in "κγ":
            emit("ɡ"); i += 2; continue
        if base == "τ" and nxt == "ζ":
            emit("dz"); i += 2; continue
        if base == "τ" and nxt == "σ":
            emit("ts"); i += 2; continue

        if base in _MONO:
            emit(_MONO[base], True, accented)
            i += 1
            continue
        if base == "σ" and nxt and nxt in "βγδζμνρλ":
            emit("z"); i += 1; continue  # σ voices before voiced
        c = _CONS.get(base)
        if c is not None:
            emit(c)
            if nxt == base:  # doubled consonants are single (λλ, σσ)
                i += 1
        i += 1
    return out, flags, accent_unit


def word_to_ipa(word: str) -> str:
    units, flags, accent = _scan(word)
    nuclei = [k for k, f in enumerate(flags) if f]
    ipa = "".join(units)
    if len(nuclei) < 2:
        return ipa
    if accent >= 0 and accent in nuclei:
        target = accent
    else:
        target = nuclei[-2]  # unaccented polysyllables: penult default
    from .rule_g2p import place_stress

    return place_stress(units, flags, target)


_ONES = ["μηδέν", "ένα", "δύο", "τρία", "τέσσερα", "πέντε", "έξι",
         "επτά", "οκτώ", "εννέα", "δέκα", "έντεκα", "δώδεκα",
         "δεκατρία", "δεκατέσσερα", "δεκαπέντε", "δεκαέξι",
         "δεκαεπτά", "δεκαοκτώ", "δεκαεννέα"]
_TENS = ["", "", "είκοσι", "τριάντα", "σαράντα", "πενήντα", "εξήντα",
         "εβδομήντα", "ογδόντα", "ενενήντα"]
_HUNDREDS = ["", "εκατό", "διακόσια", "τριακόσια", "τετρακόσια",
             "πεντακόσια", "εξακόσια", "επτακόσια", "οκτακόσια",
             "εννιακόσια"]


def number_to_words(num: int) -> str:
    if num < 0:
        return "μείον " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        t, o = divmod(num, 10)
        return _TENS[t] + (" " + _ONES[o] if o else "")
    if num < 1000:
        h, r = divmod(num, 100)
        head = _HUNDREDS[h]
        if h == 1 and r:
            head = "εκατόν"
        return head + (" " + number_to_words(r) if r else "")
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "χίλια" if k == 1 else number_to_words(k) + " χιλιάδες"
        return head + (" " + number_to_words(r) if r else "")
    m, r = divmod(num, 1_000_000)
    head = ("ένα εκατομμύριο" if m == 1
            else number_to_words(m) + " εκατομμύρια")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    # final sigma normalizes via lower(); strip the dialytika forms
    return expand_numbers(text, number_to_words).lower()
