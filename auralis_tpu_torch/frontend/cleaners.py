"""Multilingual text normalization for TTS.

Capability parity with the reference cleaner stack (reference:
models/xttsv2/config/tokenizer.py:238-738): lowercase, expand abbreviations /
symbols / ordinals / currency / plain numbers per language, collapse
whitespace, and per-script transliteration (zh pinyin when available, ja
romaji, ko romanization). Tables are first-party; number verbalization comes
from `auralis_tpu.frontend.numwords`.
"""
from __future__ import annotations

import re
from functools import lru_cache

from . import numwords as nw
from .transliterate import (
    chinese_to_pinyin,
    hangul_to_latin,
    ja_kanji_to_kana,
    ja_number_to_romaji,
    kana_to_romaji,
)
from .zh_numwords import TextNorm as ZhTextNorm

_WHITESPACE_RE = re.compile(r"\s+")

# language -> list of (abbreviation-without-dot, expansion)
_ABBREV: dict[str, list[tuple[str, str]]] = {
    "en": [("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
           ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
           ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
           ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
           ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort")],
    "es": [("sra", "señora"), ("sr", "señor"), ("dr", "doctor"), ("dra", "doctora"),
           ("st", "santo"), ("co", "compañía"), ("jr", "junior"), ("ltd", "limitada")],
    "fr": [("mme", "madame"), ("mr", "monsieur"), ("dr", "docteur"), ("st", "saint"),
           ("co", "compagnie"), ("jr", "junior"), ("ltd", "limitée")],
    "de": [("fr", "frau"), ("dr", "doktor"), ("st", "sankt"), ("co", "firma"),
           ("jr", "junior")],
    "pt": [("sra", "senhora"), ("sr", "senhor"), ("dr", "doutor"), ("dra", "doutora"),
           ("st", "santo"), ("co", "companhia"), ("jr", "júnior"), ("ltd", "limitada")],
    "it": [("sig", "signore"), ("dr", "dottore"), ("st", "santo"), ("co", "compagnia"),
           ("jr", "junior"), ("ltd", "limitata")],
    "pl": [("p", "pani"), ("m", "pan"), ("dr", "doktor"), ("sw", "święty"),
           ("jr", "junior")],
    "cs": [("dr", "doktor"), ("ing", "inženýr"), ("p", "pan")],
    "nl": [("dhr", "de heer"), ("mevr", "mevrouw"), ("dr", "dokter"),
           ("jhr", "jonkheer")],
    "tr": [("b", "bay"), ("byk", "büyük"), ("dr", "doktor")],
    "hu": [("dr", "doktor"), ("b", "bácsi"), ("nőv", "nővér")],
}
# Russian abbreviations end without a dot in running text
_ABBREV_NO_DOT = {
    "ru": [("г-жа", "госпожа"), ("г-н", "господин"), ("д-р", "доктор")],
}

_SYMBOLS: dict[str, list[tuple[str, str]]] = {
    "en": [("&", " and "), ("@", " at "), ("%", " percent "), ("#", " hash "),
           ("$", " dollar "), ("£", " pound "), ("°", " degree ")],
    "es": [("&", " y "), ("@", " arroba "), ("%", " por ciento "), ("#", " numeral "),
           ("$", " dolar "), ("£", " libra "), ("°", " grados ")],
    "fr": [("&", " et "), ("@", " arobase "), ("%", " pour cent "), ("#", " dièse "),
           ("$", " dollar "), ("£", " livre "), ("°", " degrés ")],
    "de": [("&", " und "), ("@", " at "), ("%", " prozent "), ("#", " raute "),
           ("$", " dollar "), ("£", " pfund "), ("°", " grad ")],
    "pt": [("&", " e "), ("@", " arroba "), ("%", " por cento "), ("#", " cardinal "),
           ("$", " dólar "), ("£", " libra "), ("°", " graus ")],
    "it": [("&", " e "), ("@", " chiocciola "), ("%", " per cento "),
           ("#", " cancelletto "), ("$", " dollaro "), ("£", " sterlina "),
           ("°", " gradi ")],
    "pl": [("&", " i "), ("@", " małpa "), ("%", " procent "), ("#", " krzyżyk "),
           ("$", " dolar "), ("£", " funt "), ("°", " stopnie ")],
    "ar": [("&", " و "), ("@", " على "), ("%", " في المئة "), ("#", " رقم "),
           ("$", " دولار "), ("£", " جنيه "), ("°", " درجة ")],
    "zh": [("&", " 和 "), ("@", " 在 "), ("%", " 百分之 "), ("#", " 号 "),
           ("$", " 美元 "), ("£", " 英镑 "), ("°", " 度 ")],
    "cs": [("&", " a "), ("@", " na "), ("%", " procento "), ("#", " křížek "),
           ("$", " dolar "), ("£", " libra "), ("°", " stupně ")],
    "ru": [("&", " и "), ("@", " собака "), ("%", " процентов "), ("#", " номер "),
           ("$", " доллар "), ("£", " фунт "), ("°", " градус ")],
    "nl": [("&", " en "), ("@", " bij "), ("%", " procent "), ("#", " hekje "),
           ("$", " dollar "), ("£", " pond "), ("°", " graden ")],
    "tr": [("&", " ve "), ("@", " at "), ("%", " yüzde "), ("#", " diyez "),
           ("$", " dolar "), ("£", " sterlin "), ("°", " derece ")],
    "hu": [("&", " és "), ("@", " kukac "), ("%", " százalék "),
           ("#", " kettőskereszt "), ("$", " dollár "), ("£", " font "),
           ("°", " fok ")],
    "ko": [("&", " 그리고 "), ("@", " 에 "), ("%", " 퍼센트 "), ("#", " 번호 "),
           ("$", " 달러 "), ("£", " 파운드 "), ("°", " 도 ")],
    "hi": [("&", " और "), ("@", " ऐट "), ("%", " प्रतिशत "), ("#", " नंबर "),
           ("$", " डॉलर "), ("£", " पाउंड "), ("°", " डिग्री ")],
}

# ordinal suffix patterns per language
_ORDINAL_RE: dict[str, re.Pattern] = {
    "en": re.compile(r"([0-9]+)(st|nd|rd|th)"),
    "es": re.compile(r"([0-9]+)(º|ª|er|o|a|os|as)"),
    "fr": re.compile(r"([0-9]+)(º|ª|er|re|e|ème)"),
    "de": re.compile(r"([0-9]+)(st|nd|rd|th|º|ª|\.(?=\s|$))"),
    "pt": re.compile(r"([0-9]+)(º|ª|o|a|os|as)"),
    "it": re.compile(r"([0-9]+)(º|°|ª|o|a|i|e)"),
    "pl": re.compile(r"([0-9]+)(º|ª|st|nd|rd|th)"),
    "ar": re.compile(r"([0-9]+)(ون|ين|ث|ر|ى)"),
    "cs": re.compile(r"([0-9]+)\.(?=\s|$)"),
    "ru": re.compile(r"([0-9]+)(-й|-я|-е|-ое|-ье|-го)"),
    "nl": re.compile(r"([0-9]+)(de|ste|e)"),
    "tr": re.compile(r"([0-9]+)(\.|inci|nci|uncu|üncü)"),
    "hu": re.compile(r"([0-9]+)(\.|adik|edik|odik|ödik|ik)"),
    "ko": re.compile(r"([0-9]+)(번째|번|차|째)"),
    "hi": re.compile(r"([0-9]+)(ला|रा|था|ठा|वाँ|वां|वें|वीं)"),
}

_PLAIN_NUMBER_RE = re.compile(r"[0-9]+")
_DECIMAL_RE = re.compile(r"([0-9]+[.,][0-9]+)")
_COMMA_GROUPED_RE = re.compile(r"\b\d{1,3}(,\d{3})*(\.\d+)?\b")
_DOT_GROUPED_RE = re.compile(r"\b\d{1,3}(\.\d{3})*(\,\d+)?\b")
# Indian-system comma grouping (2,2,3 from the right: 1,00,000 = one lakh);
# Hindi also uses Western 3-grouping, so hi strips this THEN the Western form.
# At least one 2-digit group is required so Western-grouped numbers
# ('1,234,567') never partially match ('1,234' -> a bogus decimal).
_INDIAN_GROUPED_RE = re.compile(r"\b\d{1,2}(,\d{2})+(,\d{3})(\.\d+)?\b")
_CURRENCY_RES = {
    "USD": re.compile(r"((\$[0-9\.\,]*[0-9]+)|([0-9\.\,]*[0-9]+\$))"),
    "GBP": re.compile(r"((£[0-9\.\,]*[0-9]+)|([0-9\.\,]*[0-9]+£))"),
    "EUR": re.compile(r"(([0-9\.\,]*[0-9]+€)|((€[0-9\.\,]*[0-9]+)))"),
}


@lru_cache(maxsize=64)
def _abbrev_patterns(lang: str) -> list[tuple[re.Pattern, str]]:
    pats = [
        (re.compile(rf"\b{abbr}\.", re.IGNORECASE), expansion)
        for abbr, expansion in _ABBREV.get(lang, [])
    ]
    pats += [
        (re.compile(rf"\b{re.escape(abbr)}\b", re.IGNORECASE), expansion)
        for abbr, expansion in _ABBREV_NO_DOT.get(lang, [])
    ]
    return pats


def expand_abbreviations(text: str, lang: str = "en") -> str:
    for pat, repl in _abbrev_patterns(lang):
        text = pat.sub(repl, text)
    return text


def expand_symbols(text: str, lang: str = "en") -> str:
    for sym, words in _SYMBOLS.get(lang, []):
        text = re.sub(re.escape(sym), words, text, flags=re.IGNORECASE)
        text = text.replace("  ", " ")
    return text.strip()


def expand_numbers(text: str, lang: str = "en") -> str:
    """Digit strings -> words: grouping separators, currency, decimals,
    ordinals, then plain cardinals (order matters)."""
    lang = lang.split("-")[0]  # "zh-cn" -> "zh": never fall into the en branch
    if lang == "zh":
        return ZhTextNorm()(text)
    if lang in ("en", "ru", "hi"):
        # comma-grouping languages; Hindi additionally writes the Indian
        # system (1,00,000) and uses dot as the decimal mark, so it must NOT
        # fall into the dot-grouping branch (which mangles '3.14' -> '314'
        # style decimals and reads '1,000' as the decimal 'एक दशमलव शून्य')
        if lang == "hi":
            text = _INDIAN_GROUPED_RE.sub(lambda m: m.group(0).replace(",", ""), text)
        text = _COMMA_GROUPED_RE.sub(lambda m: m.group(0).replace(",", ""), text)
    else:
        text = _DOT_GROUPED_RE.sub(lambda m: m.group(0).replace(".", ""), text)

    def _currency(m: re.Match, curr: str) -> str:
        amount = float(re.sub(r"[^\d.]", "", m.group(0).replace(",", ".")))
        return nw.currency(amount, curr, lang)

    for curr in ("GBP", "USD", "EUR"):
        try:
            text = _CURRENCY_RES[curr].sub(lambda m, c=curr: _currency(m, c), text)
        except Exception:
            pass
    if lang != "tr":
        text = _DECIMAL_RE.sub(
            lambda m: nw.decimal(float(m.group(1).replace(",", ".")), lang), text
        )
    if lang in _ORDINAL_RE:
        def _ord(m: re.Match) -> str:
            word = nw.ordinal(int(m.group(1)), lang)
            if lang == "hi" and word.endswith("वाँ") and m.group(2) in ("वीं", "वें"):
                # regular ordinals keep the source suffix's gender/number
                # (21वीं सदी stays feminine); irregulars (पहला...) are fixed
                word = word[: -len("वाँ")] + m.group(2)
            return word
        text = _ORDINAL_RE[lang].sub(_ord, text)
    text = _PLAIN_NUMBER_RE.sub(lambda m: nw.cardinal(int(m.group(0)), lang), text)
    return text


def collapse_whitespace(text: str) -> str:
    return _WHITESPACE_RE.sub(" ", text)


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(text.lower())


_CLEANED_LANGS = {"ar", "cs", "de", "en", "es", "fr", "hu", "it", "nl", "pl",
                  "pt", "ru", "tr", "zh", "ko", "hi"}

# Devanagari digits normalize to ASCII before number expansion (Hindi text
# mixes both scripts for numerals)
_DEVANAGARI_DIGITS = str.maketrans("०१२३४५६७८९", "0123456789")


def multilingual_cleaners(text: str, lang: str) -> str:
    lang = lang.split("-")[0]  # accept "zh-cn" as well as the base code
    text = text.replace('"', "")
    if lang == "tr":
        text = text.replace("İ", "i").replace("Ö", "ö").replace("Ü", "ü")
    if lang == "hi":
        text = text.translate(_DEVANAGARI_DIGITS)
    text = text.lower()
    text = expand_numbers(text, lang)
    text = expand_abbreviations(text, lang)
    text = expand_symbols(text, lang)
    return collapse_whitespace(text)


def japanese_cleaners(text: str) -> str:
    """Kanji -> kana (embedded word/char reading tables) -> romaji; arabic
    numerals -> Sino-Japanese romaji; lowercase. (Reference runs cutlet/MeCab,
    tokenizer.py:732-735; the table-driven pipeline is the first-party
    equivalent for this image.)"""
    text = re.sub(r"[0-9]+", lambda m: f" {ja_number_to_romaji(int(m.group(0)))} ", text)
    text = ja_kanji_to_kana(text)
    text = kana_to_romaji(text)
    return collapse_whitespace(text.lower()).strip()


def preprocess_text(text: str, lang: str) -> str:
    """The per-language normalization entry point (reference:
    tokenizer.py:805-819 `preprocess_text`)."""
    base = lang.split("-")[0]
    if base in _CLEANED_LANGS:
        text = multilingual_cleaners(text, base)
        if base == "zh":
            text = chinese_to_pinyin(text)
        if base == "ko":
            text = hangul_to_latin(text)
        return text
    if base == "ja":
        return japanese_cleaners(text)
    return basic_cleaners(text)
