"""Georgian letter-to-sound rules for the hermetic G2P backend.

Mkhedruli is a perfectly phonemic alphabet — every letter is exactly
one phoneme, there are no digraphs, no casing, and stress is weak
(non-phonemic, left unmarked like eSpeak does) — the reference gets
Georgian from eSpeak-ng's compiled ``ka_dict``
(``/root/reference/deps/dev/espeak-ng-data``); this is the hermetic
stand-in producing broad IPA in eSpeak ``ka`` conventions (ejectives
rendered with the ʼ modifier).
"""

from __future__ import annotations

_LETTERS = {
    "ა": ("a", True), "ბ": ("b", False), "გ": ("ɡ", False),
    "დ": ("d", False), "ე": ("ɛ", True), "ვ": ("v", False),
    "ზ": ("z", False), "თ": ("tʰ", False), "ი": ("i", True),
    "კ": ("kʼ", False), "ლ": ("l", False), "მ": ("m", False),
    "ნ": ("n", False), "ო": ("ɔ", True), "პ": ("pʼ", False),
    "ჟ": ("ʒ", False), "რ": ("r", False), "ს": ("s", False),
    "ტ": ("tʼ", False), "უ": ("u", True), "ფ": ("pʰ", False),
    "ქ": ("kʰ", False), "ღ": ("ɣ", False), "ყ": ("qʼ", False),
    "შ": ("ʃ", False), "ჩ": ("tʃʰ", False), "ც": ("tsʰ", False),
    "ძ": ("dz", False), "წ": ("tsʼ", False), "ჭ": ("tʃʼ", False),
    "ხ": ("x", False), "ჯ": ("dʒ", False), "ჰ": ("h", False),
}


def word_to_ipa(word: str) -> str:
    # stress is non-phonemic in Georgian; eSpeak leaves it unmarked
    return "".join(_LETTERS.get(ch, ("", False))[0] for ch in word)


_ONES = ["ნული", "ერთი", "ორი", "სამი", "ოთხი", "ხუთი", "ექვსი",
         "შვიდი", "რვა", "ცხრა", "ათი", "თერთმეტი", "თორმეტი",
         "ცამეტი", "თოთხმეტი", "თხუთმეტი", "თექვსმეტი", "ჩვიდმეტი",
         "თვრამეტი", "ცხრამეტი"]
# vigesimal: 20 ოცი, 40 ორმოცი, 60 სამოცი, 80 ოთხმოცი
_SCORES = {1: "ოცი", 2: "ორმოცი", 3: "სამოცი", 4: "ოთხმოცი"}
_SCORE_STEMS = {1: "ოც", 2: "ორმოც", 3: "სამოც", 4: "ოთხმოც"}


def number_to_words(num: int) -> str:
    if num < 0:
        return "მინუს " + number_to_words(-num)
    if num < 20:
        return _ONES[num]
    if num < 100:
        s, r = divmod(num, 20)
        if r == 0:
            return _SCORES[s]
        return _SCORE_STEMS[s] + "და" + _ONES[r]  # ოცდაერთი = 21
    if num < 1000:
        h, r = divmod(num, 100)
        # ასი drops its final ი before a remainder: ას ერთი = 101.
        # Only a trailing ი truncates (რვა/ცხრა end in ა and keep it)
        if h == 1:
            stem = "ას"
        else:
            w = _ONES[h]
            stem = (w[:-1] if w.endswith("ი") else w) + "ას"
        if r == 0:
            return stem + "ი"
        return stem + " " + number_to_words(r)
    if num < 1_000_000:
        k, r = divmod(num, 1000)
        head = "ათასი" if k == 1 else number_to_words(k) + " ათასი"
        if r == 0:
            return head
        return head[:-1] + " " + number_to_words(r)
    m, r = divmod(num, 1_000_000)
    head = ("მილიონი" if m == 1
            else number_to_words(m) + " მილიონი")
    return head + (" " + number_to_words(r) if r else "")


def normalize_text(text: str) -> str:
    from .rule_g2p import expand_numbers

    return expand_numbers(text, number_to_words).lower()
