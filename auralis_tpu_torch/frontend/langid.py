"""First-party language identification for the 17 supported languages.

Replaces the reference's `langid` dependency (reference:
common/definitions/requests.py:96-113) with a three-stage scorer:

1. Script detection — CJK / kana / hangul / cyrillic / arabic / devanagari
   uniquely identify zh-cn, ja, ko, ru, ar, hi.
2. Latin-script languages are scored by combining three evidence streams:
   - function words (highest-signal discriminator when present),
   - character trigrams (carry the signal on short or stopword-free text,
     the langid.py insight scaled down to a hand-curated profile),
   - word suffixes + diacritics, with language-exclusive marks (ñ ß ő ř ğ ą ã)
     weighted as near-decisive.
3. Weighted sum, length-normalized so no profile's size biases the result.

Returns ISO codes used by the model config ("zh-cn" for Chinese).
"""
from __future__ import annotations

import re
from functools import lru_cache

# High-frequency function words / markers per Latin-script language.
_STOPWORDS: dict[str, set[str]] = {
    "en": {"the", "and", "of", "to", "in", "is", "it", "you", "that", "was", "for",
           "are", "with", "his", "they", "this", "have", "from", "not", "she", "he",
           "will", "would", "there", "their", "what", "about", "which", "when",
           "were", "been", "has", "had", "its", "who", "did", "does", "because",
           "could", "them", "then", "than", "only", "into", "some", "these", "my"},
    "es": {"el", "la", "de", "que", "y", "en", "un", "una", "es", "se", "no", "por",
           "con", "para", "los", "las", "del", "su", "al", "lo", "como", "más",
           "pero", "sus", "le", "ya", "o", "este", "sí", "porque", "esta", "entre",
           "cuando", "muy", "sin", "sobre", "también", "me", "hasta", "hay",
           "donde", "quien", "desde", "todo", "nos", "durante", "todos", "uno",
           "les", "ni", "contra", "otros", "ese", "eso", "ante", "ellos", "e",
           "a", "te", "tu", "mi", "qué", "cómo", "dónde"},
    "fr": {"le", "la", "de", "et", "les", "des", "est", "un", "une", "du", "que",
           "qui", "dans", "pour", "pas", "sur", "vous", "avec", "son", "ne", "se",
           "ce", "il", "elle", "au", "plus", "par", "mais", "nous", "je", "tout",
           "ont", "été", "sont", "aux", "cette", "ses", "comme", "ou", "si",
           "leur", "y", "dont", "aussi", "fait", "peut", "deux", "même", "où",
           "après", "sans", "être", "très", "bien", "autre", "entre"},
    "de": {"der", "die", "und", "das", "ist", "in", "den", "von", "zu", "mit",
           "sich", "des", "auf", "für", "nicht", "ein", "eine", "als", "auch", "es",
           "an", "werden", "aus", "er", "hat", "dass", "sie", "nach", "wird", "bei",
           "einer", "um", "am", "sind", "noch", "wie", "einem", "über", "einen",
           "so", "zum", "war", "haben", "nur", "oder", "aber", "vor", "zur", "bis",
           "mehr", "durch", "man", "sein", "wurde", "sei", "beim", "im"},
    "it": {"il", "di", "che", "la", "è", "e", "un", "una", "per", "in", "non",
           "sono", "con", "si", "del", "le", "gli", "della", "ma", "come", "più",
           "anche", "lo", "questo", "ha", "hanno", "nel", "alla", "essere",
           "questa", "da", "su", "dei", "nella", "era", "delle", "suo", "sua",
           "dalla", "sono", "tra", "stato", "quando", "cui", "dal", "ai", "loro",
           "a", "al", "uno", "tutti", "tutto", "dove", "dopo", "durante",
           "senza", "molto", "ogni", "così", "già", "ci", "ne", "se", "chi"},
    "pt": {"o", "a", "de", "que", "e", "do", "da", "em", "um", "para", "é", "com",
           "não", "uma", "os", "no", "se", "na", "por", "mais", "as", "dos",
           "como", "mas", "foi", "ao", "ele", "das", "tem", "à", "seu", "sua",
           "ou", "são", "quando", "muito", "há", "nos", "já", "está", "eu",
           "também", "só", "pelo", "pela", "até", "isso", "ela", "entre", "era",
           "depois", "sem", "mesmo", "aos", "ter", "seus", "quem", "nas",
           "você", "vocês", "pode", "esse", "essa", "meu", "minha", "onde",
           "bom", "dia", "todos", "obrigado", "obrigada"},
    "pl": {"w", "i", "na", "z", "do", "to", "że", "się", "nie", "jest", "jak",
           "po", "co", "tak", "za", "od", "ale", "czy", "był", "ma", "przez",
           "być", "dla", "go", "tego", "tym", "już", "tylko", "może", "bardzo",
           "kiedy", "oraz", "który", "która", "które", "ich", "było", "są",
           "będzie", "pod", "przy", "bez", "nad", "jego", "jej", "tej", "ten"},
    "nl": {"de", "het", "een", "van", "en", "in", "is", "dat", "op", "te",
           "zijn", "met", "voor", "niet", "aan", "er", "ook", "als", "maar",
           "om", "dan", "zou", "wat", "bij", "nog", "naar", "heeft", "hij",
           "worden", "deze", "uit", "of", "over", "hebben", "tot", "u", "ze",
           "werd", "wordt", "door", "kan", "hun", "meer", "geen", "al", "je"},
    "tr": {"bir", "ve", "bu", "da", "de", "için", "ile", "mi", "ne", "o", "çok",
           "daha", "gibi", "ama", "ben", "var", "kadar", "sonra", "her",
           "olarak", "en", "diye", "değil", "olan", "iki", "yok", "bana",
           "beni", "sen", "ki", "ya", "şey", "bunu", "göre", "kendi", "biz",
           "onun", "ona", "şu", "nasıl", "neden", "zaman", "artık", "bile"},
    "cs": {"a", "se", "na", "je", "v", "že", "s", "do", "to", "si", "k", "ale",
           "jako", "za", "po", "jsem", "by", "co", "nebo", "tak", "už", "při",
           "před", "být", "jeho", "své", "který", "která", "jsou", "byl",
           "bylo", "byla", "od", "pro", "i", "o", "však", "také", "když",
           "mezi", "než", "ze", "aby", "tím", "této", "ještě", "pak"},
    "hu": {"a", "az", "és", "hogy", "nem", "is", "egy", "volt", "meg", "csak",
           "de", "ha", "már", "mint", "el", "még", "van", "aki", "ki", "te",
           "azt", "ezt", "vagy", "amely", "lesz", "nagy", "ő", "mert",
           "minden", "olyan", "ez", "így", "majd", "két", "őket", "neki",
           "vele", "ami", "után", "most", "itt", "akkor", "nincs", "pedig",
           "hol", "mit", "hogyan", "miért", "kell"},
}

# Characters that (among the 11 Latin-script languages here) occur in exactly
# one orthography — near-decisive evidence even in a single word.
_EXCLUSIVE_CHARS: dict[str, str] = {
    "es": "ñ¿¡",
    "de": "ß",
    "pt": "ãõ",
    "pl": "ąęłńśźż",
    # č/š/ž/ý are Czech-only among these 11 (Polish writes cz/sz/ż; Turkish
    # writes ç/ş): near-decisive on short Czech text
    "cs": "ěřůťďčšžý",
    "hu": "őű",
    "tr": "ğış",
}

# Shared but suggestive diacritics (small boosts).
_DIACRITIC_HINTS: dict[str, str] = {
    "fr": "àâçèêëîïôùûœ",
    "de": "äöü",
    "pt": "çáâê",
    "it": "àèìòù",
    "es": "áéíóú",
    "pl": "óć",
    "cs": "áíé",
    "hu": "öüóéáí",
    "tr": "çöü",
}

# Hand-curated high-frequency character trigrams (space = word boundary).
# These carry the decision on short inputs with no stopwords and separate
# close pairs (es/pt, cs/pl): suffix morphology lives here too.
_TRIGRAMS: dict[str, tuple[str, ...]] = {
    "en": (" th", "the", "he ", "ing", "ng ", "and", "nd ", "ion", " of",
           "of ", "ed ", "er ", " to", "to ", "ent", "ith", " wh", "ou ",
           "ati", "for", "ly ", "ver", " re", "are", " be"),
    "es": (" de", "de ", " la", "la ", "os ", " qu", "que", "ue ", "el ",
           " el", "ión", "ció", "aci", "ar ", " es", "as ", "era", "ado",
           " co", "nte", "sta", "ien", "cia", "ment", "los"),
    "fr": (" de", "de ", " le", "le ", "es ", "ent", "nt ", "que", " qu",
           " la", "la ", "ion", "tio", "ait", "les", " et", "et ", "re ",
           "eur", "ais", "our", " pa", "ur ", "eme", "é "),
    "de": ("en ", "er ", " de", "der", "ie ", "die", "ch ", "sch", "ein",
           " ei", "ich", "nde", "und", " un", "ung", "cht", "ver", "gen",
           "ten", "ben", " ge", "ung", "ite", "eit", "den"),
    "it": (" di", "di ", "re ", " la", "to ", " co", "no ", "che", " ch",
           "he ", "zio", "one", "ell", "lla", "are", "del", " de", "nte",
           "ato", "ita", "gli", " gl", "ono", "ant", "ale", "tti", "tta",
           "zza", "nza", " l'", "ggi", "egg", "cio", "chi", "ità", "uon"),
    "pt": (" de", "de ", "os ", "ão ", "ção", " co", "ar ", " es", "ra ",
           "da ", " da", "do ", " do", "ent", "nte", " pa", "ada", "que",
           " qu", "ara", "ida", "dos", "ais", "õe", "em ", "lh", "nh",
           "eir", "ório", "ções"),
    "pl": ("ie ", "nie", " ni", "że ", " że", "ch ", "ych", "go ", "ego",
           " po", "owa", "em ", "prz", "rze", "się", " si", "ię ", "ać ",
           "ani", "ość", "ow", "dzi", "cz", "sz", " wy"),
    "nl": ("en ", "de ", " de", "et ", "het", " he", "van", " va", "an ",
           "een", " ee", "aar", "ijk", "ij ", "ver", "oor", " ge", "ing",
           "cht", " ve", "den", "der", "sch", "elijk", "aat", "oed", "aal"),
    "tr": ("lar", "ler", "ir ", "bir", " bi", "ın ", "da ", "mak", "mek",
           "yor", "iyo", "dır", "ığı", "ünü", "ara", "an ", "ını", "nda",
           "ndan", "inde", "sın", "şı", "ğı", "ün", "ük"),
    "cs": (" je", "je ", "ní ", " ne", "se ", " se", "ou ", " na", "pro",
           " pr", "ho ", "ých", "ení", " po", "at ", "kte", "sta", "ost",
           "ter", "ně ", "ck", "ře", "ěl", "ův", " vy"),
    "hu": (" az", "az ", "egy", " eg", "ek ", "nek", "tt ", "ett", "hog",
           "ogy", "gy ", "nak", "ban", "ben", "ele", "sze", " sz", "meg",
           " me", "ség", "ás ", "és ", "ett", "len", "tet", "gy", "kat ",
           "ket ", "ól ", "kor "),
}

_word_re = re.compile(r"[^\W\d_]+", re.UNICODE)


def _script_counts(text: str) -> dict[str, int]:
    counts = {"han": 0, "kana": 0, "hangul": 0, "cyrillic": 0, "arabic": 0,
              "devanagari": 0, "latin": 0}
    for ch in text:
        o = ord(ch)
        if 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF:
            counts["han"] += 1
        elif 0x3040 <= o <= 0x30FF or 0x31F0 <= o <= 0x31FF:
            counts["kana"] += 1
        elif 0xAC00 <= o <= 0xD7AF or 0x1100 <= o <= 0x11FF:
            counts["hangul"] += 1
        elif 0x0400 <= o <= 0x04FF:
            counts["cyrillic"] += 1
        elif 0x0600 <= o <= 0x06FF or 0x0750 <= o <= 0x077F:
            counts["arabic"] += 1
        elif 0x0900 <= o <= 0x097F:
            counts["devanagari"] += 1
        elif (0x41 <= o <= 0x7A) or (0xC0 <= o <= 0x24F):
            counts["latin"] += 1
    return counts


def _latin_score(lang: str, sample: str, words: list[str]) -> float:
    """Length-normalized weighted evidence for one Latin-script language."""
    n_words = max(len(words), 1)
    stop = _STOPWORDS[lang]
    score = 2.0 * sum(1 for w in words if w in stop) / n_words

    trigrams = _TRIGRAMS[lang]
    n_chars = max(len(sample), 1)
    tri_hits = sum(sample.count(t) for t in trigrams)
    score += 1.0 * min(tri_hits / (n_chars / 4.0), 1.5)

    for ch in _EXCLUSIVE_CHARS.get(lang, ""):
        if ch in sample:
            score += 0.6
    for ch in _DIACRITIC_HINTS.get(lang, ""):
        if ch in sample:
            score += 0.04
    if lang == "es" and "?" in sample and "¿" not in sample:
        # Spanish orthography opens questions with ¿ — its absence in a
        # question is mild negative evidence (separates es from pt/it)
        score -= 0.15
    return score


@lru_cache(maxsize=1024)
def detect_language(text: str) -> str:
    """Best-effort language code for `text`; defaults to 'en'."""
    sample = text[:2000]
    sc = _script_counts(sample)
    non_latin = {k: v for k, v in sc.items() if k != "latin" and v > 0}
    if non_latin:
        top = max(non_latin, key=non_latin.get)
        # with zero Latin letters any script evidence decides ("你好");
        # mixed text needs enough non-Latin mass to outweigh embedded
        # Latin loanwords/numbers
        if sc["latin"] == 0 or non_latin[top] >= max(3, sc["latin"] // 4):
            if top == "kana":
                return "ja"
            if top == "han":
                # Han with any kana at all is Japanese
                return "ja" if sc["kana"] > 0 else "zh-cn"
            if top == "hangul":
                return "ko"
            if top == "cyrillic":
                return "ru"
            if top == "arabic":
                return "ar"
            if top == "devanagari":
                return "hi"

    lowered = " " + sample.lower() + " "
    words = [w.lower() for w in _word_re.findall(sample)]
    if not words:
        return "en"
    scores = {lang: _latin_score(lang, lowered, words) for lang in _STOPWORDS}
    best = max(scores, key=scores.get)
    return best if scores[best] > 0 else "en"


# Reference-compatible helper name (requests.py:96 `get_language`)
def get_language(text: str) -> str:
    return detect_language(text)
