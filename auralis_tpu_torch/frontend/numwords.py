"""First-party number verbalization (cardinals, ordinals, decimals, currency).

Replaces the reference's `num2words` dependency (used throughout
models/xttsv2/config/tokenizer.py:643-699 for TTS text normalization).

Full cardinal grammars: en, es, fr, de, it, pt, nl, tr, hu, ru, pl, cs, ko
(Sino-Korean), plus digit-by-digit fallback for any other language. Ordinals
for the Romance/Germanic set; other languages fall back to cardinals (fine
for TTS intelligibility).
"""
from __future__ import annotations

_EN_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
            "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
            "sixteen", "seventeen", "eighteen", "nineteen"]
_EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
            "eighty", "ninety"]
_EN_SCALE = ["", "thousand", "million", "billion", "trillion", "quadrillion",
             "quintillion"]


def _en_under_1000(n: int) -> str:
    if n < 20:
        return _EN_ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _EN_TENS[t] + (f"-{_EN_ONES[o]}" if o else "")
    h, r = divmod(n, 100)
    s = f"{_EN_ONES[h]} hundred"
    return s + (f" and {_en_under_1000(r)}" if r else "")


def _en_cardinal(n: int) -> str:
    if n < 0:
        return "minus " + _en_cardinal(-n)
    if n == 0:
        return "zero"
    groups, i = [], 0
    while n > 0:
        n, g = divmod(n, 1000)
        if g:
            groups.append((g, i))
        i += 1
    parts = [
        _en_under_1000(g) + (f" {_EN_SCALE[i]}" if i else "") for g, i in reversed(groups)
    ]
    last_g, last_i = groups[0]
    # "and" before a trailing sub-hundred group: "one thousand and five"
    if len(parts) > 1 and last_i == 0 and last_g < 100:
        return ", ".join(parts[:-1]) + " and " + parts[-1]
    return ", ".join(parts)


_EN_ORD_IRREG = {"one": "first", "two": "second", "three": "third", "five": "fifth",
                 "eight": "eighth", "nine": "ninth", "twelve": "twelfth"}


def _en_ordinal(n: int) -> str:
    words = _en_cardinal(n)
    pieces = words.rsplit(" ", 1)
    last = pieces[-1]
    if "-" in last:
        head, tail = last.rsplit("-", 1)
        tail = _EN_ORD_IRREG.get(tail) or (tail[:-1] + "ieth" if tail.endswith("y") else tail + "th")
        last = f"{head}-{tail}"
    else:
        last = _EN_ORD_IRREG.get(last) or (last[:-1] + "ieth" if last.endswith("y") else last + "th")
    pieces[-1] = last
    return " ".join(pieces)


# ----------------------------------------------------------------- Spanish
_ES_ONES = ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete",
            "ocho", "nueve", "diez", "once", "doce", "trece", "catorce", "quince",
            "dieciséis", "diecisiete", "dieciocho", "diecinueve", "veinte",
            "veintiuno", "veintidós", "veintitrés", "veinticuatro", "veinticinco",
            "veintiséis", "veintisiete", "veintiocho", "veintinueve"]
_ES_TENS = ["", "", "veinte", "treinta", "cuarenta", "cincuenta", "sesenta",
            "setenta", "ochenta", "noventa"]
_ES_HUNDREDS = ["", "ciento", "doscientos", "trescientos", "cuatrocientos",
                "quinientos", "seiscientos", "setecientos", "ochocientos",
                "novecientos"]


def _es_under_1000(n: int) -> str:
    if n < 30:
        return _ES_ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _ES_TENS[t] + (f" y {_ES_ONES[o]}" if o else "")
    if n == 100:
        return "cien"
    h, r = divmod(n, 100)
    return _ES_HUNDREDS[h] + (f" {_es_under_1000(r)}" if r else "")


def _es_cardinal(n: int) -> str:
    if n < 0:
        return "menos " + _es_cardinal(-n)
    if n < 1000:
        return _es_under_1000(n)
    if n < 1_000_000:
        k, r = divmod(n, 1000)
        kw = "mil" if k == 1 else f"{_es_under_1000(k).replace('uno', 'un')} mil"
        return kw + (f" {_es_under_1000(r)}" if r else "")
    m, r = divmod(n, 1_000_000)
    mw = "un millón" if m == 1 else f"{_es_cardinal(m).replace('uno', 'un')} millones"
    return mw + (f" {_es_cardinal(r)}" if r else "")


_ES_ORD = {1: "primero", 2: "segundo", 3: "tercero", 4: "cuarto", 5: "quinto",
           6: "sexto", 7: "séptimo", 8: "octavo", 9: "noveno", 10: "décimo"}


def _es_ordinal(n: int) -> str:
    return _ES_ORD.get(n, _es_cardinal(n))


# ------------------------------------------------------------------ French
_FR_ONES = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept", "huit",
            "neuf", "dix", "onze", "douze", "treize", "quatorze", "quinze", "seize",
            "dix-sept", "dix-huit", "dix-neuf"]
_FR_TENS = ["", "", "vingt", "trente", "quarante", "cinquante", "soixante"]


def _fr_under_100(n: int) -> str:
    if n < 20:
        return _FR_ONES[n]
    if n < 70:
        t, o = divmod(n, 10)
        if o == 1:
            return f"{_FR_TENS[t]} et un"
        return _FR_TENS[t] + (f"-{_FR_ONES[o]}" if o else "")
    if n < 80:
        return "soixante et onze" if n == 71 else f"soixante-{_FR_ONES[n - 60]}"
    if n == 80:
        return "quatre-vingts"
    if n < 100:
        return f"quatre-vingt-{_FR_ONES[n - 80]}"
    raise ValueError(n)


def _fr_under_1000(n: int) -> str:
    if n < 100:
        return _fr_under_100(n)
    h, r = divmod(n, 100)
    if h == 1:
        s = "cent"
    else:
        s = f"{_FR_ONES[h]} cent" + ("s" if r == 0 else "")
    return s + (f" {_fr_under_100(r)}" if r else "")


def _fr_cardinal(n: int) -> str:
    if n < 0:
        return "moins " + _fr_cardinal(-n)
    if n < 1000:
        return _fr_under_1000(n)
    if n < 1_000_000:
        k, r = divmod(n, 1000)
        kw = "mille" if k == 1 else f"{_fr_under_1000(k)} mille"
        return kw + (f" {_fr_under_1000(r)}" if r else "")
    m, r = divmod(n, 1_000_000)
    mw = "un million" if m == 1 else f"{_fr_cardinal(m)} millions"
    return mw + (f" {_fr_cardinal(r)}" if r else "")


def _fr_ordinal(n: int) -> str:
    if n == 1:
        return "premier"
    w = _fr_cardinal(n)
    if w.endswith("e"):
        w = w[:-1]
    elif w.endswith("cinq"):
        w += "u"
    elif w.endswith("neuf"):
        w = w[:-1] + "v"
    elif w.endswith("s") and n % 20 == 0 and n % 100 == 80:
        w = w[:-1]
    return w + "ième"


# ------------------------------------------------------------------ German
_DE_ONES = ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben",
            "acht", "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn",
            "fünfzehn", "sechzehn", "siebzehn", "achtzehn", "neunzehn"]
_DE_TENS = ["", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig",
            "siebzig", "achtzig", "neunzig"]


def _de_under_100(n: int, final: bool = True) -> str:
    if n < 20:
        w = _DE_ONES[n]
        return w if final or n != 1 else "ein"
    t, o = divmod(n, 10)
    if o == 0:
        return _DE_TENS[t]
    one = "ein" if o == 1 else _DE_ONES[o]
    return f"{one}und{_DE_TENS[t]}"


def _de_under_1000(n: int, final: bool = True) -> str:
    if n < 100:
        return _de_under_100(n, final)
    h, r = divmod(n, 100)
    s = ("ein" if h == 1 else _DE_ONES[h]) + "hundert"
    return s + (_de_under_100(r, final) if r else "")


def _de_cardinal(n: int) -> str:
    if n < 0:
        return "minus " + _de_cardinal(-n)
    if n < 1000:
        return _de_under_1000(n)
    if n < 1_000_000:
        k, r = divmod(n, 1000)
        kw = ("ein" if k == 1 else _de_under_1000(k, final=False)) + "tausend"
        return kw + (_de_under_1000(r) if r else "")
    m, r = divmod(n, 1_000_000)
    mw = "eine Million" if m == 1 else f"{_de_cardinal(m)} Millionen"
    return mw + (f" {_de_cardinal(r)}" if r else "")


def _de_ordinal(n: int) -> str:
    irregular = {1: "erste", 3: "dritte", 7: "siebte", 8: "achte"}
    if n in irregular:
        return irregular[n]
    w = _de_cardinal(n)
    return w + ("ste" if n >= 20 else "te")


# ----------------------------------------------------------------- Italian
_IT_ONES = ["zero", "uno", "due", "tre", "quattro", "cinque", "sei", "sette",
            "otto", "nove", "dieci", "undici", "dodici", "tredici", "quattordici",
            "quindici", "sedici", "diciassette", "diciotto", "diciannove"]
_IT_TENS = ["", "", "venti", "trenta", "quaranta", "cinquanta", "sessanta",
            "settanta", "ottanta", "novanta"]


def _it_under_100(n: int) -> str:
    if n < 20:
        return _IT_ONES[n]
    t, o = divmod(n, 10)
    tens = _IT_TENS[t]
    if o == 0:
        return tens
    if o in (1, 8):  # elision before vowel
        tens = tens[:-1]
    w = tens + _IT_ONES[o]
    return w[:-1] + "é" if o == 3 else w  # ventitré


def _it_under_1000(n: int) -> str:
    if n < 100:
        return _it_under_100(n)
    h, r = divmod(n, 100)
    s = ("" if h == 1 else _IT_ONES[h]) + "cento"
    return s + (_it_under_100(r) if r else "")


def _it_cardinal(n: int) -> str:
    if n < 0:
        return "meno " + _it_cardinal(-n)
    if n < 1000:
        return _it_under_1000(n)
    if n < 1_000_000:
        k, r = divmod(n, 1000)
        kw = "mille" if k == 1 else f"{_it_under_1000(k)}mila"
        return kw + (_it_under_1000(r) if r else "")
    m, r = divmod(n, 1_000_000)
    mw = "un milione" if m == 1 else f"{_it_cardinal(m)} milioni"
    return mw + (f" {_it_cardinal(r)}" if r else "")


_IT_ORD = {1: "primo", 2: "secondo", 3: "terzo", 4: "quarto", 5: "quinto",
           6: "sesto", 7: "settimo", 8: "ottavo", 9: "nono", 10: "decimo"}


def _it_ordinal(n: int) -> str:
    if n in _IT_ORD:
        return _IT_ORD[n]
    w = _it_cardinal(n)
    if w.endswith("tré"):
        w = w[:-1] + "e"  # ventitré -> ventitreesimo
    elif w.endswith("sei"):
        pass  # ventisei -> ventiseiesimo keeps the vowel
    elif w[-1] in "aeiou":
        w = w[:-1]
    return w + "esimo"


# -------------------------------------------------------------- Portuguese
_PT_ONES = ["zero", "um", "dois", "três", "quatro", "cinco", "seis", "sete",
            "oito", "nove", "dez", "onze", "doze", "treze", "catorze", "quinze",
            "dezesseis", "dezessete", "dezoito", "dezenove"]
_PT_TENS = ["", "", "vinte", "trinta", "quarenta", "cinquenta", "sessenta",
            "setenta", "oitenta", "noventa"]
_PT_HUNDREDS = ["", "cento", "duzentos", "trezentos", "quatrocentos",
                "quinhentos", "seiscentos", "setecentos", "oitocentos",
                "novecentos"]


def _pt_under_1000(n: int) -> str:
    if n < 20:
        return _PT_ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _PT_TENS[t] + (f" e {_PT_ONES[o]}" if o else "")
    if n == 100:
        return "cem"
    h, r = divmod(n, 100)
    return _PT_HUNDREDS[h] + (f" e {_pt_under_1000(r)}" if r else "")


def _pt_cardinal(n: int) -> str:
    if n < 0:
        return "menos " + _pt_cardinal(-n)
    if n < 1000:
        return _pt_under_1000(n)
    if n < 1_000_000:
        k, r = divmod(n, 1000)
        kw = "mil" if k == 1 else f"{_pt_under_1000(k)} mil"
        if not r:
            return kw
        joiner = " e " if (r < 100 or r % 100 == 0) else " "
        return kw + joiner + _pt_under_1000(r)
    m, r = divmod(n, 1_000_000)
    mw = "um milhão" if m == 1 else f"{_pt_cardinal(m)} milhões"
    return mw + (f" e {_pt_cardinal(r)}" if r else "")


_PT_ORD = {1: "primeiro", 2: "segundo", 3: "terceiro", 4: "quarto", 5: "quinto",
           6: "sexto", 7: "sétimo", 8: "oitavo", 9: "nono", 10: "décimo"}


def _pt_ordinal(n: int) -> str:
    return _PT_ORD.get(n, _pt_cardinal(n))


# ------------------------------------------------------------------- Dutch
_NL_ONES = ["nul", "een", "twee", "drie", "vier", "vijf", "zes", "zeven", "acht",
            "negen", "tien", "elf", "twaalf", "dertien", "veertien", "vijftien",
            "zestien", "zeventien", "achttien", "negentien"]
_NL_TENS = ["", "", "twintig", "dertig", "veertig", "vijftig", "zestig",
            "zeventig", "tachtig", "negentig"]


def _nl_under_100(n: int) -> str:
    if n < 20:
        return _NL_ONES[n]
    t, o = divmod(n, 10)
    if o == 0:
        return _NL_TENS[t]
    sep = "ën" if _NL_ONES[o].endswith("e") else "en"
    return f"{_NL_ONES[o]}{sep}{_NL_TENS[t]}"


def _nl_under_1000(n: int) -> str:
    if n < 100:
        return _nl_under_100(n)
    h, r = divmod(n, 100)
    s = ("" if h == 1 else _NL_ONES[h]) + "honderd"
    return s + (_nl_under_100(r) if r else "")


def _nl_cardinal(n: int) -> str:
    if n < 0:
        return "min " + _nl_cardinal(-n)
    if n < 1000:
        return _nl_under_1000(n)
    if n < 1_000_000:
        k, r = divmod(n, 1000)
        kw = ("" if k == 1 else _nl_under_1000(k)) + "duizend"
        return kw + (f" {_nl_under_1000(r)}" if r else "")
    m, r = divmod(n, 1_000_000)
    mw = "een miljoen" if m == 1 else f"{_nl_cardinal(m)} miljoen"
    return mw + (f" {_nl_cardinal(r)}" if r else "")


# ----------------------------------------------------------------- Turkish
_TR_ONES = ["sıfır", "bir", "iki", "üç", "dört", "beş", "altı", "yedi", "sekiz",
            "dokuz"]
_TR_TENS = ["", "on", "yirmi", "otuz", "kırk", "elli", "altmış", "yetmiş",
            "seksen", "doksan"]


def _tr_cardinal(n: int) -> str:
    if n < 0:
        return "eksi " + _tr_cardinal(-n)
    if n == 0:
        return "sıfır"
    parts = []
    for scale, word in ((1_000_000_000, "milyar"), (1_000_000, "milyon"), (1000, "bin")):
        if n >= scale:
            q, n = divmod(n, scale)
            if scale == 1000 and q == 1:
                parts.append(word)
            else:
                parts.append(f"{_tr_cardinal(q)} {word}")
    if n >= 100:
        h, n = divmod(n, 100)
        parts.append(("" if h == 1 else _TR_ONES[h] + " ") + "yüz")
    if n >= 10:
        t, n = divmod(n, 10)
        parts.append(_TR_TENS[t])
    if n > 0:
        parts.append(_TR_ONES[n])
    return " ".join(parts)


# --------------------------------------------------------------- Hungarian
_HU_ONES = ["nulla", "egy", "kettő", "három", "négy", "öt", "hat", "hét",
            "nyolc", "kilenc"]
_HU_TEENS = ["tíz", "tizenegy", "tizenkettő", "tizenhárom", "tizennégy",
             "tizenöt", "tizenhat", "tizenhét", "tizennyolc", "tizenkilenc"]
_HU_TENS = ["", "tíz", "húsz", "harminc", "negyven", "ötven", "hatvan",
            "hetven", "nyolcvan", "kilencven"]
_HU_TENS_PREFIX = ["", "tizen", "huszon", "harminc", "negyven", "ötven",
                   "hatvan", "hetven", "nyolcvan", "kilencven"]


def _hu_under_100(n: int) -> str:
    if n < 10:
        return _HU_ONES[n]
    if n < 20:
        return _HU_TEENS[n - 10]
    t, o = divmod(n, 10)
    return _HU_TENS[t] if o == 0 else _HU_TENS_PREFIX[t] + _HU_ONES[o]


def _hu_under_1000(n: int) -> str:
    if n < 100:
        return _hu_under_100(n)
    h, r = divmod(n, 100)
    s = ("" if h == 1 else _HU_ONES[h]) + "száz"
    return s + (_hu_under_100(r) if r else "")


def _hu_cardinal(n: int) -> str:
    if n < 0:
        return "mínusz " + _hu_cardinal(-n)
    if n < 1000:
        return _hu_under_1000(n)
    if n < 1_000_000:
        k, r = divmod(n, 1000)
        kw = ("" if k == 1 else _hu_under_1000(k) + ("-" if n > 2000 else "")) + "ezer"
        return kw + (("-" if n > 2000 and r else "") + _hu_under_1000(r) if r else "")
    m, r = divmod(n, 1_000_000)
    return f"{_hu_cardinal(m)} millió" + (f" {_hu_cardinal(r)}" if r else "")


# ----------------------------------------------------------------- Russian
_RU_ONES = ["ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь",
            "восемь", "девять", "десять", "одиннадцать", "двенадцать",
            "тринадцать", "четырнадцать", "пятнадцать", "шестнадцать",
            "семнадцать", "восемнадцать", "девятнадцать"]
_RU_ONES_F = {1: "одна", 2: "две"}
_RU_TENS = ["", "", "двадцать", "тридцать", "сорок", "пятьдесят", "шестьдесят",
            "семьдесят", "восемьдесят", "девяносто"]
_RU_HUNDREDS = ["", "сто", "двести", "триста", "четыреста", "пятьсот",
                "шестьсот", "семьсот", "восемьсот", "девятьсот"]


def _slavic_plural(n: int, forms: tuple[str, str, str]) -> str:
    if n % 10 == 1 and n % 100 != 11:
        return forms[0]
    if 2 <= n % 10 <= 4 and not 12 <= n % 100 <= 14:
        return forms[1]
    return forms[2]


def _ru_under_1000(n: int, feminine: bool = False) -> str:
    parts = []
    h, r = divmod(n, 100)
    if h:
        parts.append(_RU_HUNDREDS[h])
    if r >= 20:
        t, o = divmod(r, 10)
        parts.append(_RU_TENS[t])
        if o:
            parts.append(_RU_ONES_F.get(o, _RU_ONES[o]) if feminine else _RU_ONES[o])
    elif r > 0 or n == 0:
        parts.append(_RU_ONES_F.get(r, _RU_ONES[r]) if feminine else _RU_ONES[r])
    return " ".join(p for p in parts if p)


def _ru_cardinal(n: int) -> str:
    if n < 0:
        return "минус " + _ru_cardinal(-n)
    if n < 1000:
        return _ru_under_1000(n)
    parts = []
    m, rest = divmod(n, 1_000_000)
    if m:
        parts.append(f"{_ru_under_1000(m)} {_slavic_plural(m, ('миллион', 'миллиона', 'миллионов'))}")
    k, r = divmod(rest, 1000)
    if k:
        parts.append(f"{_ru_under_1000(k, feminine=True)} {_slavic_plural(k, ('тысяча', 'тысячи', 'тысяч'))}")
    if r:
        parts.append(_ru_under_1000(r))
    return " ".join(parts)


# ------------------------------------------------------------------ Polish
_PL_ONES = ["zero", "jeden", "dwa", "trzy", "cztery", "pięć", "sześć", "siedem",
            "osiem", "dziewięć", "dziesięć", "jedenaście", "dwanaście",
            "trzynaście", "czternaście", "piętnaście", "szesnaście",
            "siedemnaście", "osiemnaście", "dziewiętnaście"]
_PL_TENS = ["", "", "dwadzieścia", "trzydzieści", "czterdzieści", "pięćdziesiąt",
            "sześćdziesiąt", "siedemdziesiąt", "osiemdziesiąt", "dziewięćdziesiąt"]
_PL_HUNDREDS = ["", "sto", "dwieście", "trzysta", "czterysta", "pięćset",
                "sześćset", "siedemset", "osiemset", "dziewięćset"]


def _pl_under_1000(n: int) -> str:
    parts = []
    h, r = divmod(n, 100)
    if h:
        parts.append(_PL_HUNDREDS[h])
    if r >= 20:
        t, o = divmod(r, 10)
        parts.append(_PL_TENS[t])
        if o:
            parts.append(_PL_ONES[o])
    elif r > 0 or n == 0:
        parts.append(_PL_ONES[r])
    return " ".join(p for p in parts if p)


def _pl_cardinal(n: int) -> str:
    if n < 0:
        return "minus " + _pl_cardinal(-n)
    if n < 1000:
        return _pl_under_1000(n)
    parts = []
    m, rest = divmod(n, 1_000_000)
    if m:
        parts.append(f"{_pl_under_1000(m)} {_slavic_plural(m, ('milion', 'miliony', 'milionów'))}")
    k, r = divmod(rest, 1000)
    if k:
        kw = _slavic_plural(k, ("tysiąc", "tysiące", "tysięcy"))
        parts.append(kw if k == 1 else f"{_pl_under_1000(k)} {kw}")
    if r:
        parts.append(_pl_under_1000(r))
    return " ".join(parts)


# ------------------------------------------------------------------- Czech
_CS_ONES = ["nula", "jedna", "dva", "tři", "čtyři", "pět", "šest", "sedm",
            "osm", "devět", "deset", "jedenáct", "dvanáct", "třináct",
            "čtrnáct", "patnáct", "šestnáct", "sedmnáct", "osmnáct",
            "devatenáct"]
_CS_TENS = ["", "", "dvacet", "třicet", "čtyřicet", "padesát", "šedesát",
            "sedmdesát", "osmdesát", "devadesát"]
_CS_HUNDREDS = ["", "sto", "dvě stě", "tři sta", "čtyři sta", "pět set",
                "šest set", "sedm set", "osm set", "devět set"]


def _cs_under_1000(n: int) -> str:
    parts = []
    h, r = divmod(n, 100)
    if h:
        parts.append(_CS_HUNDREDS[h])
    if r >= 20:
        t, o = divmod(r, 10)
        parts.append(_CS_TENS[t])
        if o:
            parts.append(_CS_ONES[o])
    elif r > 0 or n == 0:
        parts.append(_CS_ONES[r])
    return " ".join(p for p in parts if p)


def _cs_cardinal(n: int) -> str:
    if n < 0:
        return "mínus " + _cs_cardinal(-n)
    if n < 1000:
        return _cs_under_1000(n)
    parts = []
    m, rest = divmod(n, 1_000_000)
    if m:
        parts.append(f"{_cs_under_1000(m)} {_slavic_plural(m, ('milion', 'miliony', 'milionů'))}")
    k, r = divmod(rest, 1000)
    if k:
        kw = _slavic_plural(k, ("tisíc", "tisíce", "tisíc"))
        parts.append(kw if k == 1 else f"{_cs_under_1000(k)} {kw}")
    if r:
        parts.append(_cs_under_1000(r))
    return " ".join(parts)


# ------------------------------------------------------- Korean (Sino-Korean)
_KO_DIGITS = ["영", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]
_KO_SMALL = ["", "십", "백", "천"]
_KO_BIG = ["", "만", "억", "조"]


def _ko_under_10000(n: int) -> str:
    out = []
    for i in range(3, -1, -1):
        d = (n // 10**i) % 10
        if d:
            out.append(("" if d == 1 and i > 0 else _KO_DIGITS[d]) + _KO_SMALL[i])
    return "".join(out)


def _ko_cardinal(n: int) -> str:
    if n < 0:
        return "마이너스 " + _ko_cardinal(-n)
    if n == 0:
        return "영"
    groups, i, out = [], 0, []
    while n > 0:
        n, g = divmod(n, 10000)
        groups.append((g, i))
        i += 1
    for g, i in reversed(groups):
        if g:
            out.append(_ko_under_10000(g) + _KO_BIG[i])
    return "".join(out)


# -------------------------------------------------------------------- Hindi
# 0-99 are lexically irregular in Hindi; above that the Indian grouping system
# applies (सौ 100, हज़ार 1e3, लाख 1e5, करोड़ 1e7, अरब 1e9). The reference
# accepts "hi" but never normalizes it (tokenizer.py:784-789 routes hi to
# basic_cleaners); this is the first-party completion of that listed language.
_HI_UNDER_100 = (
    "शून्य एक दो तीन चार पाँच छह सात आठ नौ दस "
    "ग्यारह बारह तेरह चौदह पंद्रह सोलह सत्रह अठारह उन्नीस बीस "
    "इक्कीस बाईस तेईस चौबीस पच्चीस छब्बीस सत्ताईस अट्ठाईस उनतीस तीस "
    "इकतीस बत्तीस तैंतीस चौंतीस पैंतीस छत्तीस सैंतीस अड़तीस उनतालीस चालीस "
    "इकतालीस बयालीस तैंतालीस चौवालीस पैंतालीस छियालीस सैंतालीस अड़तालीस उनचास पचास "
    "इक्यावन बावन तिरपन चौवन पचपन छप्पन सत्तावन अट्ठावन उनसठ साठ "
    "इकसठ बासठ तिरसठ चौंसठ पैंसठ छियासठ सड़सठ अड़सठ उनहत्तर सत्तर "
    "इकहत्तर बहत्तर तिहत्तर चौहत्तर पचहत्तर छिहत्तर सतहत्तर अठहत्तर उनासी अस्सी "
    "इक्यासी बयासी तिरासी चौरासी पचासी छियासी सत्तासी अट्ठासी नवासी नब्बे "
    "इक्यानवे बानवे तिरानवे चौरानवे पचानवे छियानवे सत्तानवे अट्ठानवे निन्यानवे"
).split()
assert len(_HI_UNDER_100) == 100


def _hi_cardinal(n: int) -> str:
    if n < 0:
        return "माइनस " + _hi_cardinal(-n)
    if n < 100:
        return _HI_UNDER_100[n]
    out = []
    # Indian grouping: crore (1e7) / lakh (1e5) / thousand / hundred / 0-99
    for value, name in ((10**9, "अरब"), (10**7, "करोड़"), (10**5, "लाख"),
                        (1000, "हज़ार"), (100, "सौ")):
        if n >= value:
            out.append(_hi_cardinal(n // value) + " " + name)
            n %= value
    if n:
        out.append(_HI_UNDER_100[n])
    return " ".join(out)


_HI_ORD_IRREG = {1: "पहला", 2: "दूसरा", 3: "तीसरा", 4: "चौथा", 6: "छठा"}


def _hi_ordinal(n: int) -> str:
    return _HI_ORD_IRREG.get(n, _hi_cardinal(n) + "वाँ")


# ---------------------------------------------------------------- fallbacks
_DIGIT_WORDS = {
    "ar": ["صفر", "واحد", "اثنان", "ثلاثة", "أربعة", "خمسة", "ستة", "سبعة",
           "ثمانية", "تسعة"],
}

_CARDINALS = {
    "en": _en_cardinal, "es": _es_cardinal, "fr": _fr_cardinal,
    "de": _de_cardinal, "it": _it_cardinal, "pt": _pt_cardinal,
    "nl": _nl_cardinal, "tr": _tr_cardinal, "hu": _hu_cardinal,
    "ru": _ru_cardinal, "pl": _pl_cardinal, "cs": _cs_cardinal,
    "cz": _cs_cardinal, "ko": _ko_cardinal, "hi": _hi_cardinal,
}
_ORDINALS = {
    "en": _en_ordinal, "es": _es_ordinal, "fr": _fr_ordinal,
    "de": _de_ordinal, "it": _it_ordinal, "pt": _pt_ordinal,
    "hi": _hi_ordinal,
}

_POINT_WORD = {"en": "point", "es": "coma", "fr": "virgule", "de": "Komma",
               "it": "virgola", "pt": "vírgula", "nl": "komma", "pl": "przecinek",
               "ru": "запятая", "cs": "celá", "cz": "celá", "tr": "virgül",
               "hu": "egész", "ko": "점", "ar": "فاصلة", "hi": "दशमलव"}


def cardinal(n: int, lang: str = "en") -> str:
    fn = _CARDINALS.get(lang.split("-")[0])
    if fn is not None:
        try:
            return fn(int(n))
        except (IndexError, KeyError, RecursionError):
            # beyond the language's scale table (wild TTS input: digit
            # strings, ids, hashes — a 300-digit run overflowed the en/ru/
            # pl/cs/ko tables, found by the frontend fuzz) — read digit by
            # digit the way a human reads an id number
            return " ".join(fn(int(d)) for d in str(abs(int(n))))
    digits = _DIGIT_WORDS.get(lang.split("-")[0])
    if digits is not None:
        return " ".join(digits[int(d)] for d in str(abs(int(n))))
    try:
        return _en_cardinal(int(n))
    except (IndexError, KeyError, RecursionError):
        return " ".join(_en_cardinal(int(d)) for d in str(abs(int(n))))


def ordinal(n: int, lang: str = "en") -> str:
    fn = _ORDINALS.get(lang.split("-")[0])
    if fn is None:
        return cardinal(n, lang)
    try:
        return fn(int(n))
    except (IndexError, KeyError, RecursionError):
        # same scale-table overflow guard as cardinal()
        return cardinal(n, lang)


def decimal(x: float, lang: str = "en") -> str:
    """Read a decimal like num2words: integer part, point word, then each
    fractional digit individually."""
    s = f"{x}"
    if "." not in s:
        return cardinal(int(x), lang)
    int_part, frac = s.split(".")
    point = _POINT_WORD.get(lang.split("-")[0], "point")
    frac_words = " ".join(cardinal(int(d), lang) for d in frac)
    return f"{cardinal(int(int_part), lang)} {point} {frac_words}"


# ------------------------------------------------------------------ currency
_CURRENCY_UNITS = {
    # (currency, lang) -> (unit_sing, unit_plural, cent_sing, cent_plural, sep)
    ("USD", "en"): ("dollar", "dollars", "cent", "cents", ", "),
    ("USD", "es"): ("dólar", "dólares", "centavo", "centavos", " con "),
    ("USD", "fr"): ("dollar", "dollars", "cent", "cents", " et "),
    ("USD", "de"): ("Dollar", "Dollar", "Cent", "Cent", " und "),
    ("USD", "it"): ("dollaro", "dollari", "centesimo", "centesimi", " e "),
    ("USD", "pt"): ("dólar", "dólares", "centavo", "centavos", " e "),
    ("EUR", "en"): ("euro", "euro", "cent", "cents", ", "),
    ("EUR", "es"): ("euro", "euros", "céntimo", "céntimos", " con "),
    ("EUR", "fr"): ("euro", "euros", "centime", "centimes", " et "),
    ("EUR", "de"): ("Euro", "Euro", "Cent", "Cent", " und "),
    ("EUR", "it"): ("euro", "euro", "centesimo", "centesimi", " e "),
    ("EUR", "pt"): ("euro", "euros", "cêntimo", "cêntimos", " e "),
    ("GBP", "en"): ("pound", "pounds", "penny", "pence", ", "),
    ("GBP", "es"): ("libra", "libras", "penique", "peniques", " con "),
    ("GBP", "fr"): ("livre", "livres", "penny", "pence", " et "),
    ("GBP", "de"): ("Pfund", "Pfund", "Penny", "Pence", " und "),
    ("GBP", "it"): ("sterlina", "sterline", "penny", "penny", " e "),
    ("GBP", "pt"): ("libra", "libras", "pêni", "pence", " e "),
}
_DEFAULT_UNITS = {"USD": ("dollar", "dollars", "cent", "cents", ", "),
                  "EUR": ("euro", "euro", "cent", "cents", ", "),
                  "GBP": ("pound", "pounds", "penny", "pence", ", ")}


def currency(amount: float, curr: str = "USD", lang: str = "en") -> str:
    """'3.14' USD en -> 'three dollars, fourteen cents'; integer amounts omit
    the cents clause (mirrors reference usage, tokenizer.py:647-673)."""
    base = lang.split("-")[0]
    units = _CURRENCY_UNITS.get((curr, base)) or _DEFAULT_UNITS.get(curr)
    if units is None:
        return decimal(amount, lang)
    unit_s, unit_p, cent_s, cent_p, sep = units
    whole = int(amount)
    cents = int(round((amount - whole) * 100))
    head = f"{cardinal(whole, base)} {unit_s if whole == 1 else unit_p}"
    if cents == 0:
        return head
    return head + sep + f"{cardinal(cents, base)} {cent_s if cents == 1 else cent_p}"
