"""Hermetic English pronunciation lexicon (General American IPA).

The reference gets production G2P from ~100 compiled eSpeak dictionaries
vendored in-tree (``deps/dev/espeak-ng-data``, built statically by
``crates/text/espeak-phonemizer/build.rs:5-17``).  Those binary artifacts
cannot ship here, so this module carries a first-party lexicon: ~1.2k
hand-written base words with stress marks, multiplied several-fold by the
morphological derivations in :func:`derive` (regular plurals, past tense,
progressive, agentive, adverbial, and common prefixes, each applying the
standard phonological alternations — /s z ɪz/, /t d ɪd/, consonant-e
dropping).

Symbol conventions match eSpeak's en-us IPA output as Piper voices expect
it (``phoneme_id_map``): ɹ for r, ɚ for unstressed r-colored schwa, ɜː for
stressed NURSE, ː length marks, ˈ/ˌ stress before the syllable.

Unknown words fall through to the letter-to-sound rules in
:mod:`.rule_g2p`, which also assigns default stress.
"""

from __future__ import annotations

from typing import Optional

# fmt: off
# Function words (deliberately unstressed — they cliticize in speech).
FUNCTION_WORDS = {
    "a": "ə", "an": "æn", "the": "ðə", "of": "ʌv", "to": "tuː",
    "and": "ænd", "in": "ɪn", "is": "ɪz", "it": "ɪt", "you": "juː",
    "that": "ðæt", "he": "hiː", "she": "ʃiː", "was": "wʌz", "for": "fɔːɹ",
    "on": "ɑːn", "are": "ɑːɹ", "as": "æz", "with": "wɪð", "his": "hɪz",
    "her": "hɜːɹ", "they": "ðeɪ", "i": "aɪ", "at": "æt", "be": "biː",
    "this": "ðɪs", "have": "hæv", "from": "fɹʌm", "or": "ɔːɹ",
    "had": "hæd", "by": "baɪ", "but": "bʌt", "not": "nɑːt", "what": "wʌt",
    "all": "ɔːl", "were": "wɜːɹ", "we": "wiː", "when": "wɛn",
    "your": "jʊɹ", "can": "kæn", "there": "ðɛɹ", "do": "duː", "if": "ɪf",
    "will": "wɪl", "so": "soʊ", "no": "noʊ", "my": "maɪ", "than": "ðæn",
    "been": "bɪn", "who": "huː", "its": "ɪts", "did": "dɪd", "me": "miː",
    "them": "ðɛm", "then": "ðɛn", "these": "ðiːz", "some": "sʌm",
    "would": "wʊd", "could": "kʊd", "should": "ʃʊd", "shall": "ʃæl",
    "may": "meɪ", "might": "maɪt", "must": "mʌst", "has": "hæz",
    "him": "hɪm", "us": "ʌs", "our": "aʊɚ", "out": "aʊt", "up": "ʌp",
    "down": "daʊn", "off": "ɔːf", "into": "ˈɪntuː", "onto": "ˈɑːntuː",
    "upon": "əpˈɑːn", "while": "waɪl", "because": "bɪkˈʌz",
    "through": "θɹuː", "during": "dˈʊɹɪŋ", "before": "bɪfˈɔːɹ",
    "after": "ˈæftɚ", "above": "əbˈʌv", "below": "bɪlˈoʊ",
    "between": "bɪtwˈiːn", "both": "boʊθ", "each": "iːtʃ", "few": "fjuː",
    "how": "haʊ", "too": "tuː", "very": "vˈɛɹi", "just": "dʒʌst",
    "where": "wɛɹ", "why": "waɪ", "again": "əɡˈɛn", "once": "wʌns",
    "here": "hɪɹ", "also": "ˈɔːlsoʊ", "only": "ˈoʊnli", 
    "same": "seɪm", "such": "sʌtʃ", "any": "ˈɛni", "about": "əbˈaʊt",
    "against": "əɡˈɛnst", "yes": "jɛs", "nor": "nɔːɹ", "wasn't": "wˈʌzənt",
    "which": "wɪtʃ", "their": "ðɛɹ", "said": "sɛd", "says": "sɛz",
    "does": "dʌz", "done": "dʌn", "gone": "ɡɔːn", "am": "æm",
    "per": "pɜː", "via": "vˈaɪə", "else": "ɛls", "ever": "ˈɛvɚ",
    "never": "nˈɛvɚ", "always": "ˈɔːlweɪz", "often": "ˈɔːfən",
    "quite": "kwaɪt", "rather": "ɹˈæðɚ", "really": "ɹˈiːli",
    "maybe": "mˈeɪbi", "perhaps": "pɚhˈæps", "though": "ðoʊ",
    "although": "ɔːlðˈoʊ", "however": "haʊˈɛvɚ", "until": "ʌntˈɪl",
    "since": "sɪns", "toward": "təwˈɔːɹd", "towards": "təwˈɔːɹdz",
    "without": "wɪðˈaʊt", "within": "wɪðˈɪn", "around": "ɚɹˈaʊnd",
    "across": "əkɹˈɔːs", "along": "əlˈɔːŋ", "among": "əmˈʌŋ",
    "behind": "bɪhˈaɪnd", "beside": "bɪsˈaɪd", "beyond": "bɪjˈɑːnd",
    "except": "ɛksˈɛpt", "instead": "ɪnstˈɛd", "despite": "dɪspˈaɪt",
    "unless": "ʌnlˈɛs", "whether": "wˈɛðɚ", "whose": "huːz",
    "whom": "huːm", "shan't": "ʃænt", "let's": "lɛts", "oh": "oʊ",
    "over": "ˈoʊvɚ", "under": "ˈʌndɚ", "every": "ˈɛvɹi",
    "everything": "ˈɛvɹiθɪŋ", "everyone": "ˈɛvɹiwʌn",
    "something": "sˈʌmθɪŋ", "someone": "sˈʌmwʌn", "nothing": "nˈʌθɪŋ",
    "anything": "ˈɛniθɪŋ", "anyone": "ˈɛniwʌn", "nobody": "nˈoʊbɑːdi",
    "somebody": "sˈʌmbɑːdi", "everybody": "ˈɛvɹibɑːdi",
    "okay": "oʊkˈeɪ", "ok": "oʊkˈeɪ", "etc": "ɛtsˈɛtɚɹə",
}

# Content words: pronouns/numbers/time first, then general vocabulary.
BASE_WORDS = {
    # numbers
    "zero": "zˈɪɹoʊ", "one": "wʌn", "two": "tuː", "three": "θɹiː",
    "four": "fɔːɹ", "five": "faɪv", "six": "sɪks", "seven": "sˈɛvən",
    "eight": "eɪt", "nine": "naɪn", "ten": "tɛn", "eleven": "ɪlˈɛvən",
    "twelve": "twɛlv", "thirteen": "θɜːtˈiːn", "fourteen": "fɔːɹtˈiːn",
    "fifteen": "fɪftˈiːn", "sixteen": "sɪkstˈiːn",
    "seventeen": "sɛvəntˈiːn", "eighteen": "eɪtˈiːn",
    "nineteen": "naɪntˈiːn", "twenty": "twˈɛnti", "thirty": "θˈɜːɾi",
    "forty": "fˈɔːɹɾi", "fifty": "fˈɪfti", "sixty": "sˈɪksti",
    "seventy": "sˈɛvənɾi", "eighty": "ˈeɪɾi", "ninety": "nˈaɪnɾi",
    "hundred": "hˈʌndɹəd", "thousand": "θˈaʊzənd",
    "million": "mˈɪljən", "billion": "bˈɪljən", "trillion": "tɹˈɪljən",
    "first": "fɜːst", "second": "sˈɛkənd", "third": "θɜːd",
    "fourth": "fɔːɹθ", "fifth": "fɪfθ", "sixth": "sɪksθ",
    "seventh": "sˈɛvənθ", "eighth": "eɪtθ", "ninth": "naɪnθ",
    "tenth": "tɛnθ", "half": "hæf", "quarter": "kwˈɔːɹɾɚ",
    "double": "dˈʌbəl", "triple": "tɹˈɪpəl", "dozen": "dˈʌzən",
    # time
    "time": "taɪm", "year": "jɪɹ", "month": "mʌnθ", "week": "wiːk",
    "day": "deɪ", "hour": "aʊɚ", "minute": "mˈɪnɪt", "moment": "mˈoʊmənt",
    "today": "tədˈeɪ", "tomorrow": "təmˈɑːɹoʊ", "yesterday": "jˈɛstɚdeɪ",
    "morning": "mˈɔːɹnɪŋ", "evening": "ˈiːvnɪŋ", "night": "naɪt",
    "noon": "nuːn", "midnight": "mˈɪdnaɪt", "season": "sˈiːzən",
    "spring": "spɹɪŋ", "summer": "sˈʌmɚ", "autumn": "ˈɔːɾəm",
    "winter": "wˈɪntɚ", "monday": "mˈʌndeɪ", "tuesday": "tˈuːzdeɪ",
    "wednesday": "wˈɛnzdeɪ", "thursday": "θˈɜːzdeɪ",
    "friday": "fɹˈaɪdeɪ", "saturday": "sˈæɾɚdeɪ", "sunday": "sˈʌndeɪ",
    "january": "dʒˈænjuɛɹi", "february": "fˈɛbɹuɛɹi", "march": "mɑːɹtʃ",
    "april": "ˈeɪpɹəl", "june": "dʒuːn", "july": "dʒulˈaɪ",
    "august": "ˈɔːɡəst", "september": "sɛptˈɛmbɚ",
    "october": "ɑːktˈoʊbɚ", "november": "noʊvˈɛmbɚ",
    "december": "dɪsˈɛmbɚ", "date": "deɪt", "century": "sˈɛntʃɚɹi",
    "decade": "dˈɛkeɪd", "past": "pæst", "future": "fjˈuːtʃɚ",
    "present": "pɹˈɛzənt", "early": "ˈɜːli", "late": "leɪt",
    "soon": "suːn", "later": "lˈeɪɾɚ", "ago": "əɡˈoʊ", "now": "naʊ",
    # people & family
    "people": "pˈiːpəl", "person": "pˈɜːsən", "man": "mæn",
    "woman": "wˈʊmən", "men": "mɛn", "women": "wˈɪmɪn",
    "child": "tʃaɪld", "children": "tʃˈɪldɹən", "baby": "bˈeɪbi",
    "boy": "bɔɪ", "girl": "ɡɜːl", "family": "fˈæmɪli",
    "mother": "mˈʌðɚ", "father": "fˈɑːðɚ", "parent": "pˈɛɹənt",
    "brother": "bɹˈʌðɚ", "sister": "sˈɪstɚ", "son": "sʌn",
    "daughter": "dˈɔːɾɚ", "uncle": "ˈʌŋkəl", "aunt": "ænt",
    "cousin": "kˈʌzən", "grandmother": "ɡɹˈænmʌðɚ",
    "grandfather": "ɡɹˈænfɑːðɚ", "husband": "hˈʌzbənd",
    "wife": "waɪf", "friend": "fɹɛnd", "neighbor": "nˈeɪbɚ",
    "guest": "ɡɛst", "stranger": "stɹˈeɪndʒɚ", "name": "neɪm",
    "doctor": "dˈɑːktɚ", "nurse": "nɜːs", "teacher": "tˈiːtʃɚ",
    "student": "stˈuːdənt", "lawyer": "lˈɔɪɚ", "police": "pəlˈiːs",
    "soldier": "sˈoʊldʒɚ", "king": "kɪŋ", "queen": "kwiːn",
    "president": "pɹˈɛzɪdənt", "leader": "lˈiːdɚ", "member": "mˈɛmbɚ",
    "artist": "ˈɑːɹɾɪst", "author": "ˈɔːθɚ", "writer": "ɹˈaɪɾɚ",
    "singer": "sˈɪŋɚ", "actor": "ˈæktɚ", "driver": "dɹˈaɪvɚ",
    "farmer": "fˈɑːɹmɚ", "worker": "wˈɜːkɚ", "engineer": "ɛndʒɪnˈɪɹ",
    "scientist": "sˈaɪəntɪst", "professor": "pɹəfˈɛsɚ",
    "manager": "mˈænɪdʒɚ", "captain": "kˈæptɪn", "chief": "tʃiːf",
    "guard": "ɡɑːɹd", "judge": "dʒʌdʒ", "pilot": "pˈaɪlət",
    "sailor": "sˈeɪlɚ", "chef": "ʃɛf", "clerk": "klɜːk",
    # body
    "body": "bˈɑːdi", "head": "hɛd", "face": "feɪs", "eye": "aɪ",
    "ear": "ɪɹ", "nose": "noʊz", "mouth": "maʊθ", "tooth": "tuːθ",
    "teeth": "tiːθ", "tongue": "tʌŋ", "lip": "lɪp", "hair": "hɛɹ",
    "neck": "nɛk", "shoulder": "ʃˈoʊldɚ", "arm": "ɑːɹm",
    "hand": "hænd", "finger": "fˈɪŋɡɚ", "thumb": "θʌm", "leg": "lɛɡ",
    "foot": "fʊt", "feet": "fiːt", "knee": "niː", "toe": "toʊ",
    "skin": "skɪn", "bone": "boʊn", "blood": "blʌd", "heart": "hɑːɹt",
    "brain": "bɹeɪn", "lung": "lʌŋ", "stomach": "stˈʌmək",
    "back": "bæk", "chest": "tʃɛst", "muscle": "mˈʌsəl",
    "voice": "vɔɪs", "breath": "bɹɛθ", "sleep": "sliːp",
    "dream": "dɹiːm", "health": "hɛlθ", "pain": "peɪn",
    "disease": "dɪzˈiːz", "medicine": "mˈɛdɪsən", "wound": "wuːnd",
    # nature
    "world": "wɜːld", "earth": "ɜːθ", "land": "lænd", "sea": "siː",
    "ocean": "ˈoʊʃən", "river": "ɹˈɪvɚ", "lake": "leɪk",
    "mountain": "mˈaʊntən", "hill": "hɪl", "valley": "vˈæli",
    "forest": "fˈɔːɹɪst", "tree": "tɹiː", "leaf": "liːf",
    "leaves": "liːvz", "root": "ɹuːt", "branch": "bɹæntʃ",
    "flower": "flˈaʊɚ", "grass": "ɡɹæs", "seed": "siːd",
    "plant": "plænt", "fruit": "fɹuːt", "stone": "stoʊn",
    "rock": "ɹɑːk", "sand": "sænd", "soil": "sɔɪl", "mud": "mʌd",
    "dust": "dʌst", "gold": "ɡoʊld", "silver": "sˈɪlvɚ",
    "iron": "ˈaɪɚn", "metal": "mˈɛɾəl", "salt": "sɔːlt",
    "water": "wˈɔːɾɚ", "fire": "faɪɚ", "air": "ɛɹ", "wind": "wɪnd",
    "storm": "stɔːɹm", "rain": "ɹeɪn", "snow": "snoʊ", "ice": "aɪs",
    "cloud": "klaʊd", "sky": "skaɪ", "sun": "sʌn", "moon": "muːn",
    "star": "stɑːɹ", "shadow": "ʃˈædoʊ",
    "darkness": "dˈɑːɹknəs", "heat": "hiːt", "cold": "koʊld",
    "weather": "wˈɛðɚ", "island": "ˈaɪlənd", "desert": "dˈɛzɚt",
    "beach": "biːtʃ", "coast": "koʊst", "wave": "weɪv",
    "pond": "pɑːnd", "cave": "keɪv",
    "field": "fiːld", "garden": "ɡˈɑːɹdən", "farm": "fɑːɹm",
    # animals
    "animal": "ˈænɪməl", "dog": "dɔːɡ", "cat": "kæt", "horse": "hɔːɹs",
    "cow": "kaʊ", "pig": "pɪɡ", "sheep": "ʃiːp", "goat": "ɡoʊt",
    "chicken": "tʃˈɪkɪn", "duck": "dʌk", "bird": "bɜːd",
    "eagle": "ˈiːɡəl", "owl": "aʊl", "fish": "fɪʃ", "shark": "ʃɑːɹk",
    "whale": "weɪl", "snake": "sneɪk", "frog": "fɹɔːɡ",
    "mouse": "maʊs", "mice": "maɪs", "rat": "ɹæt", "rabbit": "ɹˈæbɪt",
    "fox": "fɑːks", "wolf": "wʊlf", "bear": "bɛɹ", "lion": "lˈaɪən",
    "tiger": "tˈaɪɡɚ", "elephant": "ˈɛlɪfənt", "monkey": "mˈʌŋki",
    "deer": "dɪɹ", "insect": "ˈɪnsɛkt", "bee": "biː", "ant": "ænt",
    "spider": "spˈaɪdɚ", "fly": "flaɪ", "worm": "wɜːm",
    "butterfly": "bˈʌɾɚflaɪ", "turtle": "tˈɜːɾəl", "crab": "kɹæb",
    # food
    "food": "fuːd", "bread": "bɹɛd", "meat": "miːt", "milk": "mɪlk",
    "cheese": "tʃiːz", "butter": "bˈʌɾɚ", "egg": "ɛɡ", "rice": "ɹaɪs",
    "soup": "suːp", "sugar": "ʃˈʊɡɚ", "honey": "hˈʌni", "tea": "tiː",
    "coffee": "kˈɔːfi", "juice": "dʒuːs", "wine": "waɪn",
    "beer": "bɪɹ", "apple": "ˈæpəl", "orange": "ˈɔːɹɪndʒ",
    "banana": "bənˈænə", "grape": "ɡɹeɪp", "lemon": "lˈɛmən",
    "cherry": "tʃˈɛɹi", "berry": "bˈɛɹi", "peach": "piːtʃ",
    "pear": "pɛɹ", "potato": "pətˈeɪɾoʊ", "tomato": "təmˈeɪɾoʊ",
    "onion": "ˈʌnjən", "carrot": "kˈæɹət", "bean": "biːn",
    "corn": "kɔːɹn", "nut": "nʌt", "cake": "keɪk", "pie": "paɪ",
    "candy": "kˈændi", "chocolate": "tʃˈɔːklət", "meal": "miːl",
    "breakfast": "bɹˈɛkfəst", "lunch": "lʌntʃ", "dinner": "dˈɪnɚ",
    "supper": "sˈʌpɚ", "dish": "dɪʃ", "taste": "teɪst",
    "flavor": "flˈeɪvɚ", "kitchen": "kˈɪtʃɪn", "oven": "ˈʌvən",
    "knife": "naɪf", "fork": "fɔːɹk", "spoon": "spuːn",
    "plate": "pleɪt", "bowl": "boʊl", "cup": "kʌp", "glass": "ɡlæs",
    "bottle": "bˈɑːɾəl",
    # objects & home
    "house": "haʊs", "home": "hoʊm", "room": "ɹuːm", "door": "dɔːɹ",
    "window": "wˈɪndoʊ", "wall": "wɔːl", "floor": "flɔːɹ",
    "ceiling": "sˈiːlɪŋ", "roof": "ɹuːf", "stairs": "stɛɹz",
    "table": "tˈeɪbəl", "chair": "tʃɛɹ", "bed": "bɛd", "desk": "dɛsk",
    "couch": "kaʊtʃ", "lamp": "læmp", "clock": "klɑːk",
    "mirror": "mˈɪɹɚ", "picture": "pˈɪktʃɚ", "carpet": "kˈɑːɹpɪt",
    "curtain": "kˈɜːʔən", "shelf": "ʃɛlf", "drawer": "dɹɔːɹ",
    "box": "bɑːks", "bag": "bæɡ", "basket": "bˈæskɪt", "key": "kiː",
    "lock": "lɑːk", "tool": "tuːl", "hammer": "hˈæmɚ", "nail": "neɪl",
    "rope": "ɹoʊp", "chain": "tʃeɪn", "wire": "waɪɚ", "pipe": "paɪp",
    "board": "bɔːɹd", "brick": "bɹɪk", "glue": "ɡluː",
    "paper": "pˈeɪpɚ", "pen": "pɛn", "pencil": "pˈɛnsəl",
    "book": "bʊk", "page": "peɪdʒ", "letter": "lˈɛɾɚ",
    "card": "kɑːɹd", "envelope": "ˈɛnvəloʊp", "stamp": "stæmp",
    "scissors": "sˈɪzɚz", "needle": "nˈiːdəl", "thread": "θɹɛd",
    "cloth": "klɔːθ", "clothes": "kloʊðz", "shirt": "ʃɜːt",
    "pants": "pænts", "dress": "dɹɛs", "coat": "koʊt", "hat": "hæt",
    "shoe": "ʃuː", "sock": "sɑːk", "glove": "ɡlʌv", "belt": "bɛlt",
    "pocket": "pˈɑːkɪt", "ring": "ɹɪŋ",
    "jewel": "dʒˈuːəl", "soap": "soʊp",
    "towel": "tˈaʊəl", "brush": "bɹʌʃ", "comb": "koʊm",
    "blanket": "blˈæŋkɪt", "pillow": "pˈɪloʊ", "candle": "kˈændəl",
    "umbrella": "ʌmbɹˈɛlə", "toy": "tɔɪ", "doll": "dɑːl",
    "ball": "bɔːl", "gift": "ɡɪft", "prize": "pɹaɪz",
    # places & travel
    "city": "sˈɪɾi", "town": "taʊn", "village": "vˈɪlɪdʒ",
    "street": "stɹiːt", "road": "ɹoʊd", "path": "pæθ",
    "bridge": "bɹɪdʒ", "corner": "kˈɔːɹnɚ", "square": "skwɛɹ",
    "park": "pɑːɹk", "market": "mˈɑːɹkɪt", 
    "shop": "ʃɑːp", "school": "skuːl", "college": "kˈɑːlɪdʒ",
    "university": "juːnɪvˈɜːsɪɾi", "library": "lˈaɪbɹɛɹi",
    "church": "tʃɜːtʃ", "temple": "tˈɛmpəl", "hospital": "hˈɑːspɪɾəl",
    "office": "ˈɔːfɪs", "factory": "fˈæktɚɹi", "station": "stˈeɪʃən",
    "airport": "ˈɛɹpɔːɹt", "hotel": "hoʊtˈɛl",
    "restaurant": "ɹˈɛstɚɹɑːnt", "bank": "bæŋk", "court": "kɔːɹt",
    "prison": "pɹˈɪzən", "museum": "mjuːzˈiːəm",
    "theater": "θˈiːəɾɚ", "cinema": "sˈɪnəmə", "country": "kˈʌntɹi",
    "nation": "nˈeɪʃən", "border": "bˈɔːɹdɚ",
    "map": "mæp", 
    "trip": "tɹɪp", "tour": "tʊɹ", "ticket": "tˈɪkɪt",
    "passport": "pˈæspɔːɹt", "luggage": "lˈʌɡɪdʒ", "camp": "kæmp",
    "tent": "tɛnt", "car": "kɑːɹ", "bus": "bʌs", 
    "plane": "pleɪn", "boat": "boʊt", "ship": "ʃɪp",
    "bicycle": "bˈaɪsɪkəl", "truck": "tɹʌk", "wheel": "wiːl",
    "engine": "ˈɛndʒɪn", "fuel": "fjˈuːəl", "gas": "ɡæs",
    "oil": "ɔɪl", "speed": "spiːd", "traffic": "tɹˈæfɪk",
    "signal": "sˈɪɡnəl", "sign": "saɪn", "direction": "dɚɹˈɛkʃən",
    "north": "nɔːɹθ", "south": "saʊθ", "east": "iːst",
    "west": "wɛst", "left": "lɛft", 
    "middle": "mˈɪdəl", "center": "sˈɛntɚ", "side": "saɪd",
    "top": "tɑːp", "bottom": "bˈɑːɾəm", "edge": "ɛdʒ", "end": "ɛnd",
    "front": "fɹʌnt", "inside": "ɪnsˈaɪd", "outside": "aʊtsˈaɪd",
    "place": "pleɪs", "position": "pəzˈɪʃən", "distance": "dˈɪstəns",
    "area": "ˈɛɹiə", "space": "speɪs", "ground": "ɡɹaʊnd",
    # abstract & common nouns
    "thing": "θɪŋ", "way": "weɪ", "word": "wɜːd", "work": "wɜːk",
    "life": "laɪf", "lives": "laɪvz", "death": "dɛθ", "love": "lʌv",
    "hate": "heɪt", "fear": "fɪɹ", "hope": "hoʊp", "joy": "dʒɔɪ",
    "anger": "ˈæŋɡɚ", "peace": "piːs", "war": "wɔːɹ",
    "battle": "bˈæɾəl", "enemy": "ˈɛnəmi", "weapon": "wˈɛpən",
    "gun": "ɡʌn", "sword": "sɔːɹd", "army": "ˈɑːɹmi",
    "power": "pˈaʊɚ", "energy": "ˈɛnɚdʒi",
    "strength": "stɹɛŋθ", "money": "mˈʌni", "price": "pɹaɪs",
    "cost": "kɔːst", "value": "vˈæljuː", "wealth": "wɛlθ",
    "business": "bˈɪznəs", "company": "kˈʌmpəni", "trade": "tɹeɪd",
    "job": "dʒɑːb", "career": "kɚɹˈɪɹ", "task": "tæsk",
    "duty": "dˈuːɾi", "service": "sˈɜːvɪs", 
    "problem": "pɹˈɑːbləm", "question": "kwˈɛstʃən",
    "answer": "ˈænsɚ", "reason": "ɹˈiːzən", "result": "ɹɪzˈʌlt",
    "effect": "ɪfˈɛkt", "purpose": "pˈɜːpəs",
    "idea": "aɪdˈiːə", "thought": "θɔːt",
    "mind": "maɪnd", "knowledge": "nˈɑːlɪdʒ",
    "wisdom": "wˈɪzdəm", "truth": "tɹuːθ", "lie": "laɪ",
    "fact": "fækt", "story": "stˈɔːɹi", "news": "nuːz",
    "message": "mˈɛsɪdʒ", "speech": "spiːtʃ",
    "language": "lˈæŋɡwɪdʒ", "sentence": "sˈɛntəns",
    "phrase": "fɹeɪz", "sound": "saʊnd", "noise": "nɔɪz",
    "music": "mjˈuːzɪk", "song": "sɔːŋ", "dance": "dæns",
    # s-final non-plurals the strip-s retry must not misanalyze
    # (round-4 advisor finding), plus their scan-resistant stems
    "physics": "fˈɪzɪks", "chaos": "kˈeɪɑːs", "series": "sˈɪɹiz",
    "menu": "mˈɛnjuː", "lens": "lɛnz", "basis": "bˈeɪsɪs",
    "analysis": "ənˈæləsɪs", "emphasis": "ˈɛmfəsɪs",
    "art": "ɑːɹt", "color": "kˈʌlɚ", "shape": "ʃeɪp",
    "form": "fɔːɹm", "line": "laɪn", "circle": "sˈɜːkəl",
    "size": "saɪz", "weight": "weɪt",
    "number": "nˈʌmbɚ", "amount": "əmˈaʊnt",
    "part": "pɑːɹt", "piece": "piːs", 
    "group": "ɡɹuːp", "pair": "pɛɹ", "list": "lɪst", "row": "ɹoʊ",
    "order": "ˈɔːɹdɚ", "kind": "kaɪnd", 
    "sort": "sɔːɹt", "class": "klæs", "level": "lˈɛvəl",
    "degree": "dɪɡɹˈiː", "rate": "ɹeɪt", "chance": "tʃæns",
    "luck": "lʌk", "risk": "ɹɪsk", "danger": "dˈeɪndʒɚ",
    "safety": "sˈeɪfti", "law": "lɔː", "rule": "ɹuːl",
    "right": "ɹaɪt", "freedom": "fɹˈiːdəm", "justice": "dʒˈʌstɪs",
    "crime": "kɹaɪm", "system": "sˈɪstəm", "government": "ɡˈʌvɚnmənt",
    "history": "hˈɪstɚɹi", "science": "sˈaɪəns", "nature": "nˈeɪtʃɚ",
    "machine": "məʃˈiːn", "computer": "kəmpjˈuːɾɚ",
    "phone": "foʊn", "telephone": "tˈɛlɪfoʊn", "radio": "ɹˈeɪdioʊ",
    "television": "tˈɛlɪvɪʒən", "camera": "kˈæmɚɹə",
    "screen": "skɹiːn", "button": "bˈʌʔən", "network": "nˈɛtwɜːk",
    "internet": "ˈɪntɚnɛt", "software": "sˈɔːftwɛɹ",
    "program": "pɹˈoʊɡɹæm", "data": "dˈeɪɾə", "model": "mˈɑːdəl",
    "test": "tɛst", "example": "ɪɡzˈæmpəl", "game": "ɡeɪm",
    "sport": "spɔːɹt", "team": "tiːm", "player": "plˈeɪɚ",
    "score": "skɔːɹ", "race": "ɹeɪs", "winner": "wˈɪnɚ",
    "loser": "lˈuːzɚ", "goal": "ɡoʊl", "match": "mætʃ",
    "exercise": "ˈɛksɚsaɪz",
    "lesson": "lˈɛsən", "subject": "sˈʌbdʒɪkt", "course": "kɔːɹs",
    "grade": "ɡɹeɪd", "exam": "ɪɡzˈæm", "study": "stˈʌdi",
    "education": "ɛdʒʊkˈeɪʃən", "experience": "ɛkspˈɪɹiəns",
    "skill": "skɪl", "habit": "hˈæbɪt", "custom": "kˈʌstəm",
    "culture": "kˈʌltʃɚ", "religion": "ɹɪlˈɪdʒən", "god": "ɡɑːd",
    "soul": "soʊl", "spirit": "spˈɪɹɪt", "heaven": "hˈɛvən",
    "hell": "hɛl", "magic": "mˈædʒɪk", "secret": "sˈiːkɹət",
    "mystery": "mˈɪstɚɹi", "adventure": "ædvˈɛntʃɚ",
    "event": "ɪvˈɛnt", "party": "pˈɑːɹɾi", "wedding": "wˈɛdɪŋ",
    "holiday": "hˈɑːlɪdeɪ", "vacation": "veɪkˈeɪʃən",
    "birthday": "bˈɜːθdeɪ", "festival": "fˈɛstɪvəl",
    "ceremony": "sˈɛɹəmoʊni", "meeting": "mˈiːɾɪŋ",
    "conversation": "kɑːnvɚsˈeɪʃən", "discussion": "dɪskˈʌʃən",
    "argument": "ˈɑːɹɡjʊmənt", "agreement": "əɡɹˈiːmənt",
    "decision": "dɪsˈɪʒən", "choice": "tʃɔɪs", "action": "ˈækʃən",
    "behavior": "bɪhˈeɪvjɚ", "attention": "ətˈɛnʃən",
    "interest": "ˈɪntɹəst", "surprise": "sɚpɹˈaɪz",
    "trouble": "tɹˈʌbəl", "mistake": "mɪstˈeɪk", "error": "ˈɛɹɚ",
    "accident": "ˈæksɪdənt",
    "emergency": "ɪmˈɜːdʒənsi", "situation": "sɪtʃuːˈeɪʃən",
    "condition": "kəndˈɪʃən", "state": "steɪt", "change": "tʃeɪndʒ",
    "difference": "dˈɪfɹəns", "progress": "pɹˈɑːɡɹɛs",
    "success": "səksˈɛs", "failure": "fˈeɪljɚ", "victory": "vˈɪktɚɹi",
    "defeat": "dɪfˈiːt", "beginning": "bɪɡˈɪnɪŋ", "start": "stɑːɹt",
    "finish": "fˈɪnɪʃ", "stop": "stɑːp", "rest": "ɹɛst",
    "break": "bɹeɪk", "turn": "tɜːn", "step": "stɛp", "move": "muːv",
    "walk": "wɔːk", "run": "ɹʌn", "jump": "dʒʌmp", "climb": "klaɪm",
    "swim": "swɪm", "flight": "flaɪt", "fall": "fɔːl",
    "journey": "dʒˈɜːni",
    # verbs (base forms)
    "go": "ɡoʊ", "come": "kʌm", "get": "ɡɛt", "make": "meɪk",
    "take": "teɪk", "give": "ɡɪv", "know": "noʊ", "think": "θɪŋk",
    "see": "siː", "look": "lʊk", "want": "wɑːnt", "find": "faɪnd",
    "tell": "tɛl", "ask": "æsk", "seem": "siːm", "feel": "fiːl",
    "try": "tɹaɪ", "leave": "liːv", "call": "kɔːl", "keep": "kiːp",
    "let": "lɛt", "begin": "bɪɡˈɪn", "show": "ʃoʊ", "hear": "hɪɹ",
    "play": "pleɪ", "live": "lɪv", "believe": "bɪlˈiːv",
    "hold": "hoʊld", "bring": "bɹɪŋ", "happen": "hˈæpən",
    "write": "ɹaɪt", "read": "ɹiːd", "sit": "sɪt", "stand": "stænd",
    "lose": "luːz", "pay": "peɪ", "meet": "miːt", "include": "ɪnklˈuːd",
    "continue": "kəntˈɪnjuː", "set": "sɛt", "learn": "lɜːn",
    "understand": "ʌndɚstˈænd", "follow": "fˈɑːloʊ",
    "create": "kɹiːˈeɪt", "speak": "spiːk", 
    "grow": "ɡɹoʊ", "close": "kloʊz",
    "win": "wɪn", "offer": "ˈɔːfɚ", "remember": "ɹɪmˈɛmbɚ",
    "forget": "fɚɡˈɛt", "consider": "kənsˈɪdɚ", "appear": "əpˈɪɹ",
    "buy": "baɪ", "sell": "sɛl", "wait": "weɪt", "serve": "sɜːv",
    "die": "daɪ", "send": "sɛnd", "expect": "ɛkspˈɛkt",
    "build": "bɪld", "stay": "steɪ", "reach": "ɹiːtʃ",
    "kill": "kɪl", "remain": "ɹɪmˈeɪn", "suggest": "sədʒˈɛst",
    "raise": "ɹeɪz", "pass": "pæs", "require": "ɹɪkwˈaɪɚ",
    "report": "ɹɪpˈɔːɹt", "decide": "dɪsˈaɪd", "pull": "pʊl",
    "push": "pʊʃ", "carry": "kˈæɹi", "drive": "dɹaɪv",
    "ride": "ɹaɪd", "throw": "θɹoʊ", "catch": "kætʃ",
    "drop": "dɹɑːp", "pick": "pɪk", "cut": "kʌt", "hit": "hɪt",
    "beat": "biːt", "shoot": "ʃuːt", "burn": "bɜːn", "blow": "bloʊ",
    "draw": "dɹɔː", "paint": "peɪnt", "sing": "sɪŋ",
    "laugh": "læf", "cry": "kɹaɪ", "smile": "smaɪl", "shout": "ʃaʊt",
    "whisper": "wˈɪspɚ", "talk": "tɔːk", "say": "seɪ", "eat": "iːt",
    "drink": "dɹɪŋk", "cook": "kʊk", "bake": "beɪk", "wash": "wɑːʃ",
    "wear": "wɛɹ", "fit": "fɪt", "touch": "tʌtʃ",
    "hurt": "hɜːt", "heal": "hiːl", "save": "seɪv", "protect": "pɹətˈɛkt",
    "attack": "ətˈæk", "defend": "dɪfˈɛnd", "fight": "faɪt",
    "argue": "ˈɑːɹɡjuː", "agree": "əɡɹˈiː", "accept": "æksˈɛpt",
    "refuse": "ɹɪfjˈuːz", "deny": "dɪnˈaɪ", "admit": "ædmˈɪt",
    "promise": "pɹˈɑːmɪs", "explain": "ɛksplˈeɪn",
    "describe": "dɪskɹˈaɪb", "discuss": "dɪskˈʌs", "teach": "tiːtʃ",
    "train": "tɹeɪn", "practice": "pɹˈæktɪs", "prepare": "pɹɪpˈɛɹ",
    "plan": "plæn", "design": "dɪzˈaɪn", "invent": "ɪnvˈɛnt",
    "discover": "dɪskˈʌvɚ", "explore": "ɛksplˈɔːɹ",
    "search": "sɜːtʃ", "seek": "siːk", "hide": "haɪd",
    "cover": "kˈʌvɚ", "fill": "fɪl", 
    "pour": "pɔːɹ", "mix": "mɪks", "join": "dʒɔɪn",
    "connect": "kənˈɛkt", "separate": "sˈɛpɚɹeɪt", "divide": "dɪvˈaɪd",
    "share": "ʃɛɹ", "add": "æd", "count": "kaʊnt",
    "compare": "kəmpˈɛɹ", "choose": "tʃuːz", "prefer": "pɹɪfˈɜː",
    "enjoy": "ɛndʒˈɔɪ", "like": "laɪk", "wish": "wɪʃ",
    "need": "niːd", "use": "juːz", "help": "hɛlp", "thank": "θæŋk",
    "welcome": "wˈɛlkəm", "visit": "vˈɪzɪt", "invite": "ɪnvˈaɪt",
    "arrive": "ɚɹˈaɪv", "enter": "ˈɛntɚ", "exit": "ˈɛɡzɪt",
    "return": "ɹɪtˈɜːn", "escape": "ɛskˈeɪp", "travel": "tɹˈævəl",
    "cross": "kɹɔːs", "lead": "liːd", "guide": "ɡaɪd", "flow": "floʊ",
    "note": "noʊt", "site": "saɪt", "vote": "voʊt", "care": "kɛɹ",
    "point": "pɔɪnt", "watch": "wɑːtʃ", "notice": "nˈoʊɾɪs",
    "observe": "əbzˈɜːv", "listen": "lˈɪsən", "smell": "smɛl",
    "belong": "bɪlˈɔːŋ", "own": "oʊn", "borrow": "bˈɑːɹoʊ",
    "lend": "lɛnd", "owe": "oʊ", "earn": "ɜːn", "waste": "weɪst",
    "spend": "spɛnd", "measure": "mˈɛʒɚ", "weigh": "weɪ",
    "contain": "kəntˈeɪn", "exist": "ɪɡzˈɪst", "become": "bɪkˈʌm",
    "remind": "ɹɪmˈaɪnd", "imagine": "ɪmˈædʒɪn", "guess": "ɡɛs",
    "doubt": "daʊt", "trust": "tɹʌst", "depend": "dɪpˈɛnd",
    "suppose": "səpˈoʊz", "realize": "ɹˈiːəlaɪz", "recognize": "ɹˈɛkəɡnaɪz",
    "improve": "ɪmpɹˈuːv", "increase": "ɪnkɹˈiːs", "reduce": "ɹɪdˈuːs",
    "develop": "dɪvˈɛləp", "produce": "pɹədˈuːs", "provide": "pɹəvˈaɪd",
    "support": "səpˈɔːɹt", "control": "kəntɹˈoʊl", "manage": "mˈænɪdʒ",
    "allow": "əlˈaʊ", "prevent": "pɹɪvˈɛnt", "avoid": "əvˈɔɪd",
    "cause": "kɔːz", "force": "fɔːɹs", "press": "pɹɛs",
    "release": "ɹɪlˈiːs", "receive": "ɹɪsˈiːv", "deliver": "dɪlˈɪvɚ",
    "collect": "kəlˈɛkt", "gather": "ɡˈæðɚ", "select": "sɪlˈɛkt",
    "remove": "ɹɪmˈuːv", "replace": "ɹɪplˈeɪs", "repair": "ɹɪpˈɛɹ",
    "destroy": "dɪstɹˈɔɪ", "damage": "dˈæmɪdʒ", "breaks": "bɹeɪks",
    "happens": "hˈæpənz", "complete": "kəmplˈiːt", "achieve": "ətʃˈiːv",
    "succeed": "səksˈiːd", "fail": "feɪl", "solve": "sɑːlv",
    "check": "tʃɛk", "confirm": "kənfˈɜːm", "prove": "pɹuːv",
    "record": "ɹɪkˈɔːɹd", "store": "stɔːɹ", "print": "pɹɪnt",
    "copy": "kˈɑːpi", "delete": "dɪlˈiːt", "insert": "ɪnsˈɜːt",
    "type": "taɪp", "click": "klɪk", "load": "loʊd",
    "download": "dˈaʊnloʊd", "upload": "ˈʌploʊd", "update": "ʌpdˈeɪt",
    "install": "ɪnstˈɔːl", "compute": "kəmpjˈuːt",
    "process": "pɹˈɑːsɛs", "convert": "kənvˈɜːt",
    "translate": "tɹænzlˈeɪt", "generate": "dʒˈɛnɚɹeɪt",
    "synthesize": "sˈɪnθəsaɪz",
    # adjectives
    "good": "ɡʊd", "bad": "bæd", "big": "bɪɡ", "small": "smɔːl",
    "large": "lɑːɹdʒ", "little": "lˈɪɾəl", "long": "lɔːŋ",
    "short": "ʃɔːɹt", "tall": "tɔːl", "high": "haɪ", "low": "loʊ",
    "wide": "waɪd", "narrow": "nˈæɹoʊ", "deep": "diːp",
    "shallow": "ʃˈæloʊ", "thick": "θɪk", "thin": "θɪn",
    "heavy": "hˈɛvi", "light": "laɪt", "fast": "fæst",
    "quick": "kwɪk", "slow": "sloʊ", "hot": "hɑːt", "warm": "wɔːɹm",
    "cool": "kuːl", "new": "nuː", "old": "oʊld", "young": "jʌŋ",
    "fresh": "fɹɛʃ", "clean": "kliːn", "dirty": "dˈɜːɾi",
    "wet": "wɛt", "dry": "dɹaɪ", "hard": "hɑːɹd", "soft": "sɔːft",
    "smooth": "smuːð", "rough": "ɹʌf", "sharp": "ʃɑːɹp",
    "flat": "flæt", "round": "ɹaʊnd", "straight": "stɹeɪt",
    "strong": "stɹɔːŋ", "weak": "wiːk", "sick": "sɪk",
    "healthy": "hˈɛlθi", "alive": "əlˈaɪv", "dead": "dɛd",
    "happy": "hˈæpi", "sad": "sæd", "angry": "ˈæŋɡɹi",
    "afraid": "əfɹˈeɪd", "proud": "pɹaʊd", "calm": "kɑːm",
    "quiet": "kwˈaɪət", "loud": "laʊd", "busy": "bˈɪzi",
    "free": "fɹiː", "rich": "ɹɪtʃ", "poor": "pʊɹ", "full": "fʊl",
    "hungry": "hˈʌŋɡɹi", "thirsty": "θˈɜːsti", "tired": "taɪɚd",
    "ready": "ɹˈɛdi", "easy": "ˈiːzi", "difficult": "dˈɪfɪkəlt",
    "simple": "sˈɪmpəl", "complex": "kˈɑːmplɛks", "clear": "klɪɹ",
    "dark": "dɑːɹk", "bright": "bɹaɪt", "beautiful": "bjˈuːɾɪfəl",
    "pretty": "pɹˈɪɾi", "ugly": "ˈʌɡli", "nice": "naɪs",
    "fine": "faɪn", "great": "ɡɹeɪt", "wonderful": "wˈʌndɚfəl",
    "terrible": "tˈɛɹɪbəl", "horrible": "hˈɔːɹɪbəl",
    "strange": "stɹeɪndʒ", "normal": "nˈɔːɹməl", "common": "kˈɑːmən",
    "rare": "ɹɛɹ", "special": "spˈɛʃəl", "important": "ɪmpˈɔːɹtənt",
    "serious": "sˈɪɹiəs", "funny": "fˈʌni", "interesting": "ˈɪntɹəstɪŋ",
    "boring": "bˈɔːɹɪŋ", "true": "tɹuː", "false": "fɔːls",
    "real": "ɹiːl", "sure": "ʃʊɹ", "certain": "sˈɜːʔən",
    "possible": "pˈɑːsɪbəl", "impossible": "ɪmpˈɑːsɪbəl",
    "necessary": "nˈɛsəsɛɹi", "useful": "jˈuːsfəl",
    "dangerous": "dˈeɪndʒɚɹəs", "safe": "seɪf", "open": "ˈoʊpən",
    "closed": "kloʊzd", "empty": "ˈɛmpti", "whole": "hoʊl",
    "broken": "bɹˈoʊkən", "perfect": "pˈɜːfɪkt", "wrong": "ɹɔːŋ",
    "correct": "kɚɹˈɛkt", "different": "dˈɪfɹənt",
    "similar": "sˈɪmɪlɚ", "equal": "ˈiːkwəl", "main": "meɪn",
    "single": "sˈɪŋɡəl", "several": "sˈɛvɹəl", "many": "mˈɛni",
    "much": "mʌtʃ", "more": "mɔːɹ", "most": "moʊst", "less": "lɛs",
    "least": "liːst", "enough": "ɪnˈʌf", "extra": "ˈɛkstɹə",
    "another": "ənˈʌðɚ", "other": "ˈʌðɚ", "next": "nɛkst",
    "last": "læst", "final": "fˈaɪnəl", "able": "ˈeɪbəl",
    "available": "əvˈeɪləbəl", "popular": "pˈɑːpjʊlɚ",
    "famous": "fˈeɪməs", "public": "pˈʌblɪk", "private": "pɹˈaɪvət",
    "national": "nˈæʃənəl", "local": "lˈoʊkəl", "foreign": "fˈɔːɹɪn",
    "modern": "mˈɑːdɚn", "ancient": "ˈeɪnʃənt", "recent": "ɹˈiːsənt",
    "current": "kˈɜːɹənt", "general": "dʒˈɛnɚɹəl",
    "particular": "pɚtˈɪkjʊlɚ", "professional": "pɹəfˈɛʃənəl",
    "personal": "pˈɜːsənəl", "social": "sˈoʊʃəl",
    "political": "pəlˈɪɾɪkəl", "economic": "ɛkənˈɑːmɪk",
    "legal": "lˈiːɡəl", "medical": "mˈɛdɪkəl",
    "physical": "fˈɪzɪkəl", "mental": "mˈɛntəl",
    "natural": "nˈætʃɚɹəl", "chemical": "kˈɛmɪkəl",
    "electric": "ɪlˈɛktɹɪk", "digital": "dˈɪdʒɪɾəl",
    "automatic": "ɔːɾəmˈæɾɪk", "sweet": "swiːt", "sour": "saʊɚ",
    "bitter": "bˈɪɾɚ", "salty": "sˈɔːlti", "red": "ɹɛd",
    "blue": "bluː", "green": "ɡɹiːn", "yellow": "jˈɛloʊ",
    "black": "blæk", "white": "waɪt", "brown": "bɹaʊn",
    "gray": "ɡɹeɪ", "pink": "pɪŋk", "purple": "pˈɜːpəl",
    # tech / TTS-domain words (this framework's own domain)
    "audio": "ˈɔːdioʊ", "batch": "bætʃ", "buffer": "bˈʌfɚ",
    "channel": "tʃˈænəl", "chip": "tʃɪp", "client": "klˈaɪənt",
    "code": "koʊd", "decoder": "diːkˈoʊdɚ", "device": "dɪvˈaɪs",
    "encoder": "ɛnkˈoʊdɚ", "file": "faɪl", "format": "fˈɔːɹmæt",
    "frame": "fɹeɪm", "graph": "ɡɹæf", "index": "ˈɪndɛks",
    "input": "ˈɪnpʊt", "kernel": "kˈɜːnəl", "latency": "lˈeɪʔənsi",
    "layer": "lˈeɪɚ", "memory": "mˈɛmɚɹi", "mesh": "mɛʃ",
    "output": "ˈaʊtpʊt", "packet": "pˈækɪt", "pipeline": "pˈaɪplaɪn",
    "pixel": "pˈɪksəl", "quality": "kwˈɑːlɪɾi", "queue": "kjuː",
    "sample": "sˈæmpəl", "server": "sˈɜːvɚ", "stream": "stɹiːm",
    "tensor": "tˈɛnsɚ", "text": "tɛkst", "token": "tˈoʊkən",
    "vector": "vˈɛktɚ", "version": "vˈɜːʒən", "video": "vˈɪdioʊ",
    "hello": "həlˈoʊ", "goodbye": "ɡʊdbˈaɪ", "please": "pliːz",
    "sorry": "sˈɑːɹi", "alice": "ˈælɪs", "robot": "ɹˈoʊbɑːt",
    "synthesis": "sˈɪnθəsɪs", "phoneme": "fˈoʊniːm",
    "sonata": "sənˈɑːɾə",
    "base": "beɪs", "target": "tˈɑːɹɡɪt", "neural": "nˈʊɹəl",
    "chunk": "tʃʌŋk", "matrix": "mˈeɪtɹɪks", "cache": "kæʃ",
    "storage": "stˈɔːɹɪdʒ", "filter": "fˈɪltɚ", "compile": "kəmpˈaɪl",
    "runtime": "ɹˈʌntaɪm", "standard": "stˈændɚd",
    "quantum": "kwˈɑːntəm", "virtual": "vˈɜːtʃuəl",
    "random": "ɹˈændəm", "static": "stˈæɾɪk", "dynamic": "daɪnˈæmɪk",
    "parallel": "pˈɛɹəlɛl", "serial": "sˈɪɹiəl", "remote": "ɹɪmˈoʊt",
    "global": "ɡlˈoʊbəl", "keyboard": "kˈiːbɔːɹd",
    "schedule": "skˈɛdʒuːl", "monitor": "mˈɑːnɪɾɚ",
    "module": "mˈɑːdʒuːl", "protocol": "pɹˈoʊɾəkɔːl",
    "socket": "sˈɑːkɪt", "cluster": "klˈʌstɚ", "shard": "ʃɑːɹd",
    "gradient": "ɡɹˈeɪdiənt", "inference": "ˈɪnfɚɹəns",
    "transformer": "tɹænsfˈɔːɹmɚ", "attention": "ətˈɛnʃən",
    "embedding": "ɛmbˈɛdɪŋ", "softmax": "sˈɔːftmæks",
    # everyday-core gaps surfaced by a 900-word frequency sweep (round 4)
    "act": "ækt", "actually": "ˈæktʃuəli", "age": "eɪdʒ",
    "almost": "ˈɔːlmoʊst", "alone": "əlˈoʊn", "already": "ɔːlɹˈɛdi",
    "annoy": "ənˈɔɪ", "apart": "əpˈɑːɹt", "asleep": "əslˈiːp",
    "awake": "əwˈeɪk", "away": "əwˈeɪ", "bath": "bæθ",
    "beauty": "bjˈuːɾi", "bench": "bɛntʃ", "bite": "baɪt",
    "born": "bɔːɹn", "brave": "bɹeɪv", "cap": "kæp",
    "castle": "kˈæsəl", "character": "kˈɛɹəktɚ", "clever": "klˈɛvɚ",
    "cotton": "kˈɑːtən", "crack": "kɹæk", "cream": "kɹiːm",
    "crown": "kɹaʊn", "dear": "dɪɹ", "direct": "dɚɹˈɛkt",
    "dollar": "dˈɑːlɚ", "eager": "ˈiːɡɚ", "either": "ˈiːðɚ",
    "even": "ˈiːvən", "excite": "ɪksˈaɪt", "express": "ɪkspɹˈɛs",
    "fair": "fɛɹ", "fancy": "fˈænsi", "far": "fɑːɹ", "fat": "fæt",
    "feed": "fiːd", "fence": "fɛns", "fix": "fɪks", "flag": "flæɡ",
    "forward": "fˈɔːɹwɚd", "fun": "fʌn", "gate": "ɡeɪt",
    "gentle": "dʒˈɛntəl", "glad": "ɡlæd", "goes": "ɡoʊz",
    "hall": "hɔːl", "hang": "hæŋ", "hole": "hoʊl", "huge": "hjuːdʒ",
    "human": "hjˈuːmən", "hunt": "hʌnt", "hurry": "hˈɜːɹi",
    "inch": "ɪntʃ", "indeed": "ɪndˈiːd", "kick": "kɪk", "kiss": "kɪs",
    "knock": "nɑːk", "lack": "læk", "lady": "lˈeɪdi", "lay": "leɪ",
    "lift": "lɪft", "lot": "lɑːt", "mad": "mæd", "mail": "meɪl",
    "mark": "mɑːɹk", "marry": "mˈɛɹi", "matter": "mˈæɾɚ",
    "mean": "miːn", "mile": "maɪl", "mine": "maɪn", "miss": "mɪs",
    "mount": "maʊnt", "near": "nɪɹ", "nest": "nɛst", "none": "nʌn",
    "object": "ˈɑːbdʒɛkt", "ought": "ɔːt", "plain": "pleɪn",
    "pool": "puːl", "pride": "pɹaɪd", "probable": "pɹˈɑːbəbəl",
    "proper": "pɹˈɑːpɚ", "put": "pʊt", "ran": "ɹæn", "rise": "ɹaɪz",
    "roll": "ɹoʊl", "rub": "ɹʌb", "rush": "ɹʌʃ", "sail": "seɪl",
    "seat": "siːt", "sense": "sɛns", "shade": "ʃeɪd",
    "shake": "ʃeɪk", "shine": "ʃaɪn", "shore": "ʃɔːɹ",
    "sight": "saɪt", "slip": "slɪp", "smoke": "smoʊk",
    "spell": "spɛl", "spot": "spɑːt", "spread": "spɹɛd",
    "steel": "stiːl", "stick": "stɪk", "still": "stɪl",
    "stretch": "stɹɛtʃ", "sudden": "sˈʌdən", "tail": "teɪl",
    "tear": "tɪɹ", "those": "ðoʊz", "thus": "ðʌs", "tie": "taɪ",
    "till": "tɪl", "tiny": "tˈaɪni", "together": "təɡˈɛðɚ",
    "tonight": "tənˈaɪt", "usual": "jˈuːʒuəl", "view": "vjuː",
    "well": "wɛl", "wild": "waɪld", "wise": "waɪz",
    "wonder": "wˈʌndɚ", "wood": "wʊd", "worry": "wˈɜːɹi",
    "worth": "wɜːθ", "yard": "jɑːɹd", "yet": "jɛt",
}
# fmt: on

from .lexicon_extra import EXTRA_WORDS

LEXICON: dict = {}
LEXICON.update(EXTRA_WORDS)
LEXICON.update(BASE_WORDS)      # first bank wins on collisions
LEXICON.update(FUNCTION_WORDS)  # function words win (unstressed forms)

_VOICED_END = set("bdɡvðzʒlmnŋɹwj")  # note IPA ɡ (U+0261), not ASCII g
# IPA vowel symbols shared by stress placement (rule_g2p) and tests
IPA_VOWELS = "aeiouæɑɒɔəɚɛɜɪʊʌ"
_VOWELS = IPA_VOWELS + "ː"
_SIBILANT_END = ("s", "z", "ʃ", "ʒ", "tʃ", "dʒ")


def _ends_voiced(ipa: str) -> bool:
    return ipa[-1] in _VOICED_END or ipa[-1] in _VOWELS or ipa.endswith("ː")


def _plural(ipa: str) -> str:
    if ipa.endswith(_SIBILANT_END):
        return ipa + "ɪz"
    return ipa + ("z" if _ends_voiced(ipa) else "s")


def _past(ipa: str) -> str:
    if ipa.endswith(("t", "d")):
        return ipa + "ɪd"
    return ipa + ("d" if _ends_voiced(ipa) else "t")


def derive(word: str) -> Optional[str]:
    """Morphological lookup: derive the pronunciation of an inflected or
    affixed form from a base-word lexicon entry, applying the regular
    English phonological alternations.  Returns None when no base is
    found."""
    hit = LEXICON.get(word)
    if hit is not None:
        return hit

    def base(w: str, vowel_suffix: bool) -> Optional[str]:
        # Vowel-initial suffixes (-es/-ed/-er/-ing/…) drop a base-final
        # e, so the e-restored stem must win over a colliding bare stem:
        # "uses" → "use"+s not "us", "rates" → "rate" not "rat",
        # "noted" → "note" not "not".  Consonant-initial suffixes
        # (-ly/-ness/…) keep the e in the surface form, so the bare stem
        # is the only candidate ("cars" must never resolve via "care").
        b = (LEXICON.get(w + "e")
             if vowel_suffix and not w.endswith("e") else None)
        if b is None:
            b = LEXICON.get(w)
        return b

    # suffixes, longest first
    if len(word) > 4 and word.endswith("ies"):
        b = LEXICON.get(word[:-3] + "y")
        if b is not None:
            return b[:-1] + "iz" if b.endswith("i") else _plural(b)
    if len(word) > 4 and word.endswith("ied"):
        b = LEXICON.get(word[:-3] + "y")
        if b is not None:
            return b + "d" if b.endswith("i") else _past(b)
    if len(word) > 4 and word.endswith("ily"):  # "happily" → "happy" + ly
        b = LEXICON.get(word[:-3] + "y")
        if b is not None:
            return (b[:-1] if b.endswith("i") else b) + "ɪli"
    for suf, render in (
        ("ingly", lambda b: b + "ɪŋli"),
        ("ings", lambda b: b + "ɪŋz"),
        ("ing", lambda b: b + "ɪŋ"),
        ("edly", lambda b: _past(b) + "li"),
        ("ed", _past),
        ("es", _plural),
        ("s", _plural),
        ("ers", lambda b: b + "ɚz"),
        ("er", lambda b: b + "ɚ"),
        ("est", lambda b: b + "ɪst"),
        ("ly", lambda b: (b[:-1] if b.endswith("l") else b) + "li"),
        ("ness", lambda b: b + "nəs"),
        ("ment", lambda b: b + "mənt"),
        ("ful", lambda b: b + "fəl"),
        ("less", lambda b: b + "ləs"),
        ("able", lambda b: b + "əbəl"),
    ):
        if len(word) > len(suf) + 1 and word.endswith(suf):
            stem = word[: -len(suf)]
            # a 1-2 letter base is almost always a false split ("united"
            # must not parse as un+it+ed, "asses" not as as+es); real
            # inflected bases are 3+ letters
            if len(stem) < 3 and LEXICON.get(stem + "e") is None:
                continue
            b = base(stem, vowel_suffix=suf[0] in "aei")
            if b is None and len(stem) > 3 and stem[-1] == stem[-2]:
                b = LEXICON.get(stem[:-1])  # "stopped" → "stop"
            if b is not None:
                return render(b)
    # prefixes: the remainder must be a whole lexicon word — recursive
    # derivation here produced non-compositional garbage ("united" →
    # un+ited)
    for pre, ipa in (("un", "ʌn"), ("re", "ɹiː"), ("dis", "dɪs"),
                     ("non", "nɑːn"), ("pre", "pɹiː"), ("over", "ˌoʊvɚ"),
                     ("under", "ˌʌndɚ"), ("mis", "mɪs"), ("out", "ˌaʊt")):
        if word.startswith(pre) and len(word) > len(pre) + 2:
            b = LEXICON.get(word[len(pre):])
            if b is not None:
                return ipa + b
    # closed compounds ("framework", "database", "bookshelf"): two whole
    # lexicon words, longest first part wins.  Both parts must be ≥4
    # letters — at 3 the false-split rate explodes ("season" → sea+son,
    # "carpet" → car+pet).  English compounds stress the first element:
    # the second element's primary mark demotes to secondary.
    if len(word) >= 8:
        for cut in range(len(word) - 4, 3, -1):
            second = word[cut:]
            if second == "ally":
                # "-ically" adverbs are suffixation, not compounding:
                # automatic+ally must not render as the noun "ally"
                continue
            a = LEXICON.get(word[:cut])
            b = LEXICON.get(second)
            if a is not None and b is not None:
                return a + b.replace("ˈ", "ˌ")
    return None
