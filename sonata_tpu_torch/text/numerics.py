"""Numeric text normalization beyond bare integers.

The reference inherits eSpeak-ng's ``TranslateNumber``, which reads
decimals, ordinals, years, and currency amounts in every language it
ships dictionaries for.  A normalizer that only expands ``\\d+``
reads "3.14" as "three . fourteen".  This module is the shared machinery: a per-language
:class:`NumberGrammar` describes how a language reads each numeric
shape, and :func:`expand_numerics` rewrites a text through one grammar
in a fixed pass order (thousands groups first — tagging their digits so
the year pass won't misread them — then currency → ordinal → year →
decimal, leaving bare integers for the caller) so the more specific
shapes win.

The PyTorch port keeps its own copy with the English grammar alone (the
JAX package also carries de, es and fr).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class NumberGrammar:
    """How one language reads numeric shapes aloud.

    ``cardinal`` is the pack's existing integer renderer.  ``ordinal``
    maps an integer to its ordinal word(s).  ``year`` may override how
    standalone 4-digit years read (English pairs them: "nineteen
    eighty-four"); None ⇒ cardinal.  ``decimal_comma`` selects the
    written decimal separator (3,14 vs 3.14); the OTHER separator is
    then the thousands-group separator (1.000.000 vs 1,000,000).
    ``currency`` maps a symbol to (major-unit word for 1, major for
    many, minor for 1, minor for many).
    """

    cardinal: Callable[[int], str]
    point_word: str
    ordinal: Callable[[int], str]
    ordinal_pattern: "re.Pattern[str]"
    year: Optional[Callable[[int], str]] = None
    decimal_comma: bool = False
    currency: dict = field(default_factory=dict)
    #: feminine ordinal renderer, used when ``ordinal_pattern`` matched
    #: a feminine marker (named group ``fem``): 3ª → tercera, 1re →
    #: première.  None ⇒ no gender distinction.
    ordinal_fem: Optional[Callable[[int], str]] = None
    #: extra per-match veto for ambiguous ordinal orthography (German
    #: "3." vs a sentence-final cardinal).  Returns False ⇒ leave the
    #: match unexpanded.  None ⇒ every pattern match is an ordinal.
    ordinal_guard: Optional[Callable[["re.Match[str]"], bool]] = None
    #: number-scaling words ("$3.5 billion"): a currency amount followed
    #: by one of these is a scaled quantity, not dollars-and-cents — the
    #: currency pass reads number, magnitude, then the major unit
    #: ("three point five billion dollars").  Lowercased.
    magnitudes: tuple = ()
    #: spoken minus sign: "-12.5 C" reads "minus twelve point five C";
    #: without it the expansion leaves a bare hyphen the G2P drops.
    minus_word: str = "minus"

    def read_digits(self, digits: str) -> str:
        """Fractional digits read one by one ("14" → "one four")."""
        return " ".join(self.cardinal(int(d)) for d in digits)


def _sub_currency(text: str, g: NumberGrammar) -> str:
    if not g.currency:
        return text
    syms = "".join(re.escape(s) for s in g.currency)
    dec = "," if g.decimal_comma else r"\."
    # $12.50 / $12.5 / 12,50 € / €5 / 5€ — symbol before or after, with
    # an optional 1-2 digit fractional part in the language's decimal
    # separator (a lone tenths digit reads as tens of cents).  The gap
    # between symbol and amount explicitly admits the \x1f degrouping
    # sentinel: the group-separator pass runs first and rewrites
    # "$1,000" to "$\x1f1000", so the tag sits exactly here — spelling
    # it out beats relying on Python's \s happening to treat U+001F as
    # whitespace.  3+ fractional digits fall through to the decimal
    # pass ("$1.999" is not an amount in cents).  The optional trailing
    # word is captured so a magnitude ("billion") can reorder the
    # reading; any other word is put back verbatim.
    pat = re.compile(
        rf"(?:(?P<pre>[{syms}])[\s\x1f]?(?P<a>\d+)"
        rf"(?:{dec}(?P<af>\d{{1,2}})(?!\d))?(?!{dec}\d)"
        rf"|(?P<b>\d+)(?:{dec}(?P<bf>\d{{1,2}})(?!\d))?(?!{dec}\d)"
        rf"[\s\x1f]?(?P<post>[{syms}]))"
        rf"(?:\s+(?P<nxt>[^\W\d_]+))?")

    def _one(m: re.Match) -> str:
        sym = m.group("pre") or m.group("post")
        whole = int(m.group("a") or m.group("b"))
        frac = m.group("af") or m.group("bf")
        nxt = m.group("nxt")
        if nxt is not None and g.magnitudes and nxt.lower() in g.magnitudes:
            # "$3.5 billion" / "$3 billion" are scaled amounts, not
            # dollars-and-cents followed by a stray word: read the
            # figure, the magnitude, then the major unit — "three point
            # five billion dollars" (an integer-only guard here used to
            # leave the bare symbol behind: "$ three point five billion")
            num = g.cardinal(whole)
            if frac:
                num += " " + g.point_word + " " + g.read_digits(frac)
            many_major = g.currency[sym][1]
            return " " + num + " " + nxt + " " + many_major + " "
        one_major, many_major, one_minor, many_minor = g.currency[sym]
        out = g.cardinal(whole) + " " + (
            one_major if whole == 1 else many_major)
        if frac and int(frac) != 0:
            # "12.5" means fifty cents, not five: a single fractional
            # digit counts tenths of the major unit
            cents = int(frac) * (10 if len(frac) == 1 else 1)
            out += " " + g.cardinal(cents) + " " + (
                one_minor if cents == 1 else many_minor)
        if nxt is not None:  # non-magnitude word: back into the text
            out += " " + nxt
        return " " + out + " "

    return pat.sub(_one, text)


def _sub_ordinals(text: str, g: NumberGrammar) -> str:
    def _one(m: re.Match) -> str:
        if g.ordinal_guard is not None and not g.ordinal_guard(m):
            return m.group(0)
        gd = m.groupdict()
        if "n" in gd and gd["n"] is not None:
            n = int(gd["n"])
            # context the pattern consumed before the number (e.g. the
            # German ``prev`` word) stays in the text verbatim
            prefix = m.group(0)[: m.start("n") - m.start(0)]
        else:
            n = int(m.group(1))
            prefix = m.group(0)[: m.start(1) - m.start(0)]
        fem = gd.get("fem")
        fn = g.ordinal_fem if (fem and g.ordinal_fem) else g.ordinal
        return prefix + " " + fn(n) + " "

    return g.ordinal_pattern.sub(_one, text)


def _sub_years(text: str, g: NumberGrammar) -> str:
    if g.year is None:
        return text
    # a standalone 4-digit 1100-2099 with no decimal/group neighbors
    # and no de-grouped tag (1,984 is a cardinal, not a year).  The
    # trailing guard blocks only digit-adjacent separators: "1984." at
    # sentence end is still a year, "1984.5" is a decimal.
    pat = re.compile(
        rf"(?<![\d.,{_DEGROUPED}])((?:1[1-9]|20)\d\d)(?![.,]?\d)")

    def _one(m: re.Match) -> str:
        return g.year(int(m.group(1)))

    return pat.sub(_one, text)


def _sub_decimals(text: str, g: NumberGrammar) -> str:
    dec = "," if g.decimal_comma else r"\."
    pat = re.compile(rf"(\d+){dec}(\d+)")

    def _one(m: re.Match) -> str:
        spoken = " ".join((g.cardinal(int(m.group(1))), g.point_word,
                           g.read_digits(m.group(2))))
        return " " + spoken + " "

    return pat.sub(_one, text)


#: marks a digit run produced by collapsing an explicitly-grouped
#: cardinal (1,984 → ␟1984): the year pass must not read it as a year.
#: Stripped before expand_numerics returns.
_DEGROUPED = "\x1f"


def _sub_negatives(text: str, g: NumberGrammar) -> str:
    """A sign directly before a number becomes the grammar's minus word
    ("-12.5 C" → "minus 12.5 C", read on by the decimal/integer passes).

    Only a *leading* sign counts: a digit or word character before the
    hyphen means a range ("3-5"), a date span ("2021-2022"), or a
    hyphenated token — those keep their hyphen.  U+2212 (real minus)
    gets the same treatment.  A currency symbol may sit between sign and
    digits ("-$5" → "minus $5", which the currency pass then reads).
    """
    syms = "".join(re.escape(s) for s in g.currency)
    ahead = rf"(?=[{syms}]?\d)" if syms else r"(?=\d)"
    return re.sub(rf"(?<![\w.,{_DEGROUPED}−-])[-−]{ahead}",
                  g.minus_word + " ", text)


def _sub_group_separators(text: str, g: NumberGrammar) -> str:
    """1,000,000 (en) / 1.000.000 (de/es/fr) → plain integer (tagged
    ``_DEGROUPED``), so the later passes read one number, not three —
    and the year pass knows 1,984 was a grouped cardinal, not a year."""
    sep = r"\." if g.decimal_comma else ","
    pat = re.compile(rf"\b(\d{{1,3}})((?:{sep}\d{{3}})+)\b")

    def _one(m: re.Match) -> str:
        return _DEGROUPED + m.group(1) + re.sub(r"\D", "", m.group(2))

    return pat.sub(_one, text)


def expand_numerics(text: str, g: NumberGrammar) -> str:
    """Rewrite every numeric shape in ``text`` through grammar ``g``;
    pass order: negative signs (so "-12.5" reaches the later passes as
    "minus 12.5") → thousands groups (tagging their digits) → currency →
    ordinal → year (tag-blind) → decimal.  Bare integers are left for
    the caller's existing ``expand_numbers`` pass (kept separate so
    packs without a grammar lose nothing)."""
    text = _sub_negatives(text, g)
    text = _sub_group_separators(text, g)
    text = _sub_currency(text, g)
    text = _sub_ordinals(text, g)
    text = _sub_years(text, g)
    text = _sub_decimals(text, g)
    return text.replace(_DEGROUPED, "")


# ---------------------------------------------------------------------------
# English
# ---------------------------------------------------------------------------

_EN_ORD_IRREGULAR = {
    1: "first", 2: "second", 3: "third", 5: "fifth", 8: "eighth",
    9: "ninth", 12: "twelfth",
}


def _en_ordinal(n: int) -> str:
    from .rule_g2p import number_to_words

    if n in _EN_ORD_IRREGULAR:
        return _EN_ORD_IRREGULAR[n]
    if n <= 0:
        return number_to_words(n) + "th"
    tens, ones = divmod(n, 10)
    # the decade split is wrong for teens (112 → hundred-twelfth, not
    # hundred-ten-second): those fall through to the word-final path
    if (ones and n > 20 and n % 100 not in range(11, 20)
            and ones in _EN_ORD_IRREGULAR):
        return number_to_words(tens * 10) + " " + _EN_ORD_IRREGULAR[ones]
    words = number_to_words(n)
    if words.endswith("y"):
        return words[:-1] + "ieth"  # twenty → twentieth
    if ones and n > 20:
        head, _, last = words.rpartition(" ")
        return (head + " " if head else "") + _en_ordinal_simple(last)
    return words + "th"


def _en_ordinal_simple(word_cardinal: str) -> str:
    inv = {"one": "first", "two": "second", "three": "third",
           "five": "fifth", "eight": "eighth", "nine": "ninth",
           "twelve": "twelfth"}
    return inv.get(word_cardinal, word_cardinal + "th")


def _en_year(n: int) -> str:
    from .rule_g2p import number_to_words

    if n % 1000 == 0 or 2000 <= n <= 2009:
        return number_to_words(n)  # two thousand (seven)
    hi, lo = divmod(n, 100)
    if lo == 0:
        return number_to_words(hi) + " hundred"  # nineteen hundred
    if lo < 10:
        return number_to_words(hi) + " oh " + number_to_words(lo)
    return number_to_words(hi) + " " + number_to_words(lo)


def en_grammar() -> NumberGrammar:
    from .rule_g2p import number_to_words

    return NumberGrammar(
        cardinal=number_to_words,
        point_word="point",
        ordinal=_en_ordinal,
        ordinal_pattern=re.compile(r"\b(\d+)(?:st|nd|rd|th)\b",
                                   re.IGNORECASE),
        year=_en_year,
        currency={"$": ("dollar", "dollars", "cent", "cents"),
                  "€": ("euro", "euros", "cent", "cents"),
                  "£": ("pound", "pounds", "penny", "pence")},
        magnitudes=("hundred", "thousand", "million", "billion",
                    "trillion"),
        minus_word="minus",
    )
