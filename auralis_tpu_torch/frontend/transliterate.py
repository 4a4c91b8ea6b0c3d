"""First-party transliteration helpers.

The reference depends on cutlet (ja romaji), hangul_romanize (ko) and pypinyin
(zh) — none of which exist in this image. Kana->romaji and hangul->latin are
algorithmic and implemented fully here. Hanzi->pinyin and kanji->kana use the
embedded first-party reading tables in `frontend/data/` (phrase/word entries
matched longest-first, then per-character most-common readings); a `pypinyin`
package, when importable, overrides the zh table.
"""
from __future__ import annotations

# --------------------------------------------------------------------- kana
_KANA_BASE = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "ka", "き": "ki", "く": "ku", "け": "ke", "こ": "ko",
    "さ": "sa", "し": "shi", "す": "su", "せ": "se", "そ": "so",
    "た": "ta", "ち": "chi", "つ": "tsu", "て": "te", "と": "to",
    "な": "na", "に": "ni", "ぬ": "nu", "ね": "ne", "の": "no",
    "は": "ha", "ひ": "hi", "ふ": "fu", "へ": "he", "ほ": "ho",
    "ま": "ma", "み": "mi", "む": "mu", "め": "me", "も": "mo",
    "や": "ya", "ゆ": "yu", "よ": "yo",
    "ら": "ra", "り": "ri", "る": "ru", "れ": "re", "ろ": "ro",
    "わ": "wa", "ゐ": "i", "ゑ": "e", "を": "o", "ん": "n",
    "が": "ga", "ぎ": "gi", "ぐ": "gu", "げ": "ge", "ご": "go",
    "ざ": "za", "じ": "ji", "ず": "zu", "ぜ": "ze", "ぞ": "zo",
    "だ": "da", "ぢ": "ji", "づ": "zu", "で": "de", "ど": "do",
    "ば": "ba", "び": "bi", "ぶ": "bu", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pu", "ぺ": "pe", "ぽ": "po",
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o", "ゔ": "vu",
}
_KANA_DIGRAPH = {
    "きゃ": "kya", "きゅ": "kyu", "きょ": "kyo",
    "しゃ": "sha", "しゅ": "shu", "しょ": "sho",
    "ちゃ": "cha", "ちゅ": "chu", "ちょ": "cho",
    "にゃ": "nya", "にゅ": "nyu", "にょ": "nyo",
    "ひゃ": "hya", "ひゅ": "hyu", "ひょ": "hyo",
    "みゃ": "mya", "みゅ": "myu", "みょ": "myo",
    "りゃ": "rya", "りゅ": "ryu", "りょ": "ryo",
    "ぎゃ": "gya", "ぎゅ": "gyu", "ぎょ": "gyo",
    "じゃ": "ja", "じゅ": "ju", "じょ": "jo",
    "びゃ": "bya", "びゅ": "byu", "びょ": "byo",
    "ぴゃ": "pya", "ぴゅ": "pyu", "ぴょ": "pyo",
}
_SMALL_Y = "ゃゅょ"


def _to_hiragana(ch: str) -> str:
    o = ord(ch)
    if 0x30A1 <= o <= 0x30F6:  # katakana -> hiragana
        return chr(o - 0x60)
    return ch


def kana_to_romaji(text: str) -> str:
    """Hepburn-style romanization of hiragana/katakana. Non-kana characters
    (incl. kanji) pass through unchanged."""
    out: list[str] = []
    chars = [_to_hiragana(c) for c in text]
    i = 0
    pending_sokuon = False
    while i < len(chars):
        ch = chars[i]
        nxt = chars[i + 1] if i + 1 < len(chars) else ""
        if ch == "っ":
            pending_sokuon = True
            i += 1
            continue
        if ch == "ー":
            if out and out[-1] and out[-1][-1] in "aiueo":
                out.append(out[-1][-1])
            i += 1
            continue
        syl = None
        if nxt in _SMALL_Y and (ch + nxt) in _KANA_DIGRAPH:
            syl = _KANA_DIGRAPH[ch + nxt]
            i += 2
        elif ch in _KANA_BASE:
            syl = _KANA_BASE[ch]
            i += 1
        else:
            out.append(ch)
            i += 1
            pending_sokuon = False
            continue
        if pending_sokuon:
            first = "t" if syl.startswith("ch") else syl[0]
            syl = first + syl
            pending_sokuon = False
        # ん before vowel/y -> n'
        if out and out[-1].endswith("n") and syl[0] in "aiueoy" and out[-1] in _KANA_BASE.values():
            pass
        out.append(syl)
    return "".join(out)


# ------------------------------------------------------------------- hangul
_HANGUL_INITIALS = ["g", "kk", "n", "d", "tt", "r", "m", "b", "pp", "s", "ss",
                    "", "j", "jj", "ch", "k", "t", "p", "h"]
_HANGUL_MEDIALS = ["a", "ae", "ya", "yae", "eo", "e", "yeo", "ye", "o", "wa",
                   "wae", "oe", "yo", "u", "wo", "we", "wi", "yu", "eu", "ui", "i"]
# Finals use the Revised-Romanization pronunciation values (final ㄱ is "k",
# final ㅂ is "p", ...), which reads better for TTS than letter transliteration.
_HANGUL_FINALS = ["", "k", "k", "k", "n", "n", "n", "t", "l", "k", "m",
                  "p", "l", "l", "p", "l", "m", "p", "p", "t", "t", "ng",
                  "t", "t", "k", "t", "p", "t"]


def hangul_to_latin(text: str) -> str:
    """Revised-Romanization-style transliteration of Hangul syllables."""
    out: list[str] = []
    for ch in text:
        o = ord(ch)
        if 0xAC00 <= o <= 0xD7A3:
            idx = o - 0xAC00
            ini, rest = divmod(idx, 588)
            med, fin = divmod(rest, 28)
            out.append(_HANGUL_INITIALS[ini] + _HANGUL_MEDIALS[med] + _HANGUL_FINALS[fin])
        else:
            out.append(ch)
    return "".join(out)


# -------------------------------------------------------- Japanese numbers
_JA_DIGITS = ["", "ichi", "ni", "san", "yon", "go", "roku", "nana", "hachi", "kyuu"]
_JA_HUNDRED = {1: "hyaku", 3: "sanbyaku", 6: "roppyaku", 8: "happyaku"}
_JA_THOUSAND = {1: "sen", 3: "sanzen", 8: "hassen"}


def ja_number_to_romaji(n: int) -> str:
    """Sino-Japanese reading (romaji) for integers, with the standard phonetic
    sandhi (300=sanbyaku, 600=roppyaku, 800=happyaku, 3000=sanzen, ...)."""
    if n == 0:
        return "zero"
    if n < 0:
        return "mainasu " + ja_number_to_romaji(-n)

    def under_10000(m: int) -> str:
        parts = []
        th, m = divmod(m, 1000)
        if th:
            parts.append(_JA_THOUSAND.get(th) or _JA_DIGITS[th] + "sen")
        h, m = divmod(m, 100)
        if h:
            parts.append(_JA_HUNDRED.get(h) or _JA_DIGITS[h] + "hyaku")
        t, o = divmod(m, 10)
        if t:
            parts.append(("" if t == 1 else _JA_DIGITS[t]) + "juu")
        if o:
            parts.append(_JA_DIGITS[o])
        return " ".join(parts)

    groups = []
    for scale, word in ((10**12, "chou"), (10**8, "oku"), (10**4, "man")):
        if n >= scale:
            q, n = divmod(n, scale)
            groups.append(f"{under_10000(q)} {word}")
    if n:
        groups.append(under_10000(n))
    return " ".join(groups)


def pinyin_available() -> bool:
    try:
        import pypinyin  # noqa: F401

        return True
    except ImportError:
        return False


def _is_han(ch: str) -> bool:
    o = ord(ch)
    return 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF


def chinese_to_pinyin(text: str) -> str:
    """Hanzi -> TONE3 pinyin (tone digit appended, neutral = 5), matching the
    reference's pypinyin call (tokenizer.py:727-730). Uses pypinyin when
    importable; otherwise the embedded first-party table
    (frontend/data/pinyin.py): longest-first phrase match for heteronym words,
    then per-character most-common reading. Non-han characters pass through;
    han characters outside the ~2.7k-char table become a space (a raw hanzi
    the BPE has never seen is worse than a dropped syllable)."""
    try:
        import pypinyin
    except ImportError:
        pypinyin = None
    if pypinyin is not None:
        return "".join(
            p[0]
            for p in pypinyin.pinyin(
                text, style=pypinyin.Style.TONE3, heteronym=False,
                neutral_tone_with_five=True,
            )
        )

    from .data.pinyin import CHAR_READINGS, MAX_PHRASE_LEN, PHRASE_READINGS

    out: list[str] = []
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if not _is_han(ch):
            out.append(ch)
            i += 1
            continue
        matched = False
        for k in range(min(MAX_PHRASE_LEN, n - i), 1, -1):
            cand = text[i:i + k]
            reading = PHRASE_READINGS.get(cand)
            if reading is not None:
                out.append(reading)
                i += k
                matched = True
                break
        if matched:
            continue
        out.append(CHAR_READINGS.get(ch, " "))
        i += 1
    return "".join(out)


def ja_kanji_to_kana(text: str) -> str:
    """Kanji -> hiragana via the embedded word + per-character tables
    (frontend/data/kanji.py) — the first-party stand-in for the reference's
    cutlet/MeCab pipeline (tokenizer.py:732-735). Kana and other characters
    pass through (kana_to_romaji romanizes them next); unknown kanji become
    a space."""
    from .data.kanji import CHAR_READINGS, MAX_WORD_LEN, WORD_READINGS

    out: list[str] = []
    i = 0
    n = len(text)
    while i < n:
        matched = False
        for k in range(min(MAX_WORD_LEN, n - i), 0, -1):
            cand = text[i:i + k]
            # word entries may mix kanji and okurigana; only consult the
            # table when the window contains at least one kanji
            if any(_is_han(c) for c in cand):
                reading = WORD_READINGS.get(cand)
                if reading is not None:
                    out.append(reading)
                    i += k
                    matched = True
                    break
        if matched:
            continue
        ch = text[i]
        if _is_han(ch):
            out.append(CHAR_READINGS.get(ch, " "))
        else:
            out.append(ch)
        i += 1
    return "".join(out)
