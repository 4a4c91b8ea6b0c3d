"""Chinese numeral normalization: digits -> spoken hanzi.

Capability parity with the reference's zh_num2words TextNorm (reference:
components/tts/layers/xtts/zh_num2words.py) for the cases TTS text hits:
integers, decimals, percentages, fractions, ranges, dates (年月日/号, the
reference's Date class, zh_num2words.py:831-886), money amounts before
currency units (Money, :889-910), mainland mobile/landline phone numbers
(TelePhone, :784-810), measure-word quantities (normalize_nsw, :985-991),
phone-like digit strings and years. Implemented fresh and compactly.
"""
from __future__ import annotations

import re

_DIGITS = "零一二三四五六七八九"
_UNITS = ["", "十", "百", "千"]
_GROUPS = ["", "万", "亿", "万亿"]


def _four_digits(n: int) -> str:
    """0-9999 -> hanzi with correct 零 insertion."""
    if n == 0:
        return ""
    out = []
    need_zero = False
    for i in range(3, -1, -1):
        d = (n // 10**i) % 10
        if d == 0:
            if out:
                need_zero = True
            continue
        if need_zero:
            out.append("零")
            need_zero = False
        if d == 1 and i == 1 and not out:
            out.append("十")  # 10-19: 十X not 一十X
        else:
            out.append(_DIGITS[d] + _UNITS[i])
    return "".join(out)


def int_to_hanzi(n: int) -> str:
    if n < 0:
        return "负" + int_to_hanzi(-n)
    if n == 0:
        return "零"
    groups = []
    while n > 0:
        n, g = divmod(n, 10000)
        groups.append(g)
    out = []
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        piece = _four_digits(g) + _GROUPS[i]
        # a group below 1000 after a higher group needs a leading 零
        if out and g < 1000:
            piece = "零" + piece
        out.append(piece)
    return "".join(out)


def digits_to_hanzi(s: str) -> str:
    """Digit-by-digit reading (phone numbers, years); 1 read as 幺 is a
    telephony convention we skip — TTS prefers 一."""
    return "".join(_DIGITS[int(c)] if c.isdigit() else c for c in s)


def decimal_to_hanzi(s: str) -> str:
    if "." in s:
        int_part, frac = s.split(".", 1)
        return int_to_hanzi(int(int_part or 0)) + "点" + digits_to_hanzi(frac)
    return int_to_hanzi(int(s))


_PERCENT_RE = re.compile(r"(\d+(?:\.\d+)?)\s*[%％]")
_FRACTION_RE = re.compile(r"(\d+)\s*/\s*(\d+)")
_RANGE_RE = re.compile(r"(\d+(?:\.\d+)?)\s*[-~—]\s*(\d+(?:\.\d+)?)")
# Full dates: [YYYY年][M月[D日/号]] — year digit-by-digit, month/day cardinal
# (reference Date.date2chntext, zh_num2words.py:864-886)
_DATE_RE = re.compile(r"(?:(\d{2,4})\s*年)?\s*(\d{1,2})\s*月(?:\s*(\d{1,2})\s*([日号]))?")
_YEAR_RE = re.compile(r"(\d{4})\s*年")
# Money: number (+ 多/余/几 approximators) before a currency unit
# (reference Money + CURRENCY_UNITS, zh_num2words.py:51,889-910)
_MONEY_RE = re.compile(
    r"(\d+(?:\.\d+)?)([多余几]?(?:千万|百万|[亿万千百])?(?:元|块|角|毛|分))"
)
# Mainland mobile (+86 optional, 1[3-9]xxxxxxxxx) and landline (0xx(x)-number)
_MOBILE_RE = re.compile(r"(?:\+?86[\s-]?)?(1[3-9]\d{9})(?!\d)")
_LANDLINE_RE = re.compile(r"(0(?:10|2[1-3]|[3-9]\d{2}))-(\d{7,8})(?!\d)")
# Quantity before a common measure word reads as a cardinal
# (reference COM_QUANTIFIERS, zh_num2words.py:52; compact high-frequency set)
_QUANT_RE = re.compile(
    r"(\d+(?:\.\d+)?)([多余几]?)"
    r"(个|只|条|张|件|位|名|岁|人|次|遍|回|天|年|月|日|号|小时|分钟|秒|"
    r"层|楼|米|公里|千米|厘米|毫米|公斤|千克|克|吨|斤|两|升|毫升|度|块|本|"
    r"台|辆|架|艘|间|家|所|座|套|双|对"
    r")"
)
_PHONE_RE = re.compile(r"\d{7,}")
_NUMBER_RE = re.compile(r"\d+(?:,\d{3})*(?:\.\d+)?")
# Clock times HH:MM[:SS] with a plausible hour (reference normalizes 时:分
# through its Date/number path; 点/分/秒 is the spoken form). A trailing
# source 整/分 is captured and consumed only when it agrees with the spoken
# form _time_sub emits (整 with :00, 分 with nonzero minutes) — see _time_sub.
# Score contexts (比分是2:30) are excluded by _SCORE_CUE_RE in __call__ and
# fall through to the generic per-number rule (二比三十 -> 二:三十).
_TIME_RE = re.compile(r"(?<!\d)([01]?\d|2[0-3]):([0-5]\d)(?::([0-5]\d))?(?!\d)([整分])?")
_SCORE_CUE_RE = re.compile(r"(?:比分|比数|得分)[是为到]?$|[战胜负输赢]$")
# ISO dash dates YYYY-MM-DD (with valid month/day) read as a date, not as the
# generic range rule ('2023-12-25' was mangled to 二千零二十三到十二-二十五)
_ISO_DATE_RE = re.compile(
    r"(?<!\d)(\d{4})-(0?[1-9]|1[0-2])-(0?[1-9]|[12]\d|3[01])(?!\d)"
)
# Two 4-digit years joined by a dash read digit-by-digit on both sides
# (2023-2024赛季 -> 二零二三到二零二四), unlike generic numeric ranges
_YEAR_RANGE_RE = re.compile(r"(?<!\d)((?:1[0-9]|20)\d{2})\s*[-~—]\s*((?:1[0-9]|20)\d{2})(?!\d)")
# Financial/banker's numerals (壹贰叁...拾佰仟) -> everyday forms so the
# BPE sees the characters the model was trained on (reference TextNorm
# accepts both series, zh_num2words.py CN_* tables). Only runs of >=2
# financial chars (or one followed by 元/圆/角/分) are rewritten — a lone
# 伍 or 佰 is likelier a surname/transliteration character.
_FINANCIAL_MAP = str.maketrans(
    "壹贰叁肆伍陆柒捌玖拾佰仟萬億圆", "一二三四五六七八九十百千万亿元"
)
_FINANCIAL_RE = re.compile(
    r"[壹贰叁肆伍陆柒捌玖拾佰仟萬億零]{2,}|[壹贰叁肆伍陆柒捌玖拾佰仟](?=[元圆角分])"
)


def _time_sub(m: re.Match) -> str:
    h, mi, s, suffix = m.group(1), m.group(2), m.group(3), m.group(4)
    out = int_to_hanzi(int(h)) + "点"
    if mi == "00" and not s:
        # '9:00' / '9:00整' -> 九点整; '9:00分' keeps the source's explicit
        # unit as 零分 (emitting 整 for a consumed 分 would contradict it)
        out += "零分" if suffix == "分" else "整"
    else:
        out += int_to_hanzi(int(mi)) + "分"
        if suffix == "整" and not s:
            out += "整"  # '8:30整' -> 八点三十分整 (sharp), not dropped
    if s:
        out += int_to_hanzi(int(s)) + "秒"
        if suffix == "整":
            out += "整"  # '9:00:00整' -> 九点零分零秒整 (sharp)
        # a trailing 分 after seconds ('14:05:09分') contradicts the spoken
        # form — the minutes already carry 分 — so it is consumed, not echoed
    return out


def _date_sub(m: re.Match) -> str:
    year, month, day, day_unit = m.group(1), m.group(2), m.group(3), m.group(4)
    out = []
    if year:
        out.append(digits_to_hanzi(year) + "年")
    out.append(int_to_hanzi(int(month)) + "月")
    if day:
        out.append(int_to_hanzi(int(day)) + day_unit)
    return "".join(out)


class TextNorm:
    """Callable normalizer: replaces every numeric pattern in the text with
    its spoken hanzi form (same call signature as the reference class)."""

    def __call__(self, text: str) -> str:
        # order matters: most-specific patterns first so the generic number
        # rule never eats a date/money/phone prefix
        text = re.sub(r"(?<=\d),(?=\d{3})", "", text)  # 1,234 -> 1234
        text = _FINANCIAL_RE.sub(
            lambda m: m.group(0).translate(_FINANCIAL_MAP), text
        )
        text = _ISO_DATE_RE.sub(
            lambda m: digits_to_hanzi(m.group(1)) + "年"
            + int_to_hanzi(int(m.group(2))) + "月"
            + int_to_hanzi(int(m.group(3))) + "日",
            text,
        )
        text = _YEAR_RANGE_RE.sub(
            lambda m: digits_to_hanzi(m.group(1)) + "到" + digits_to_hanzi(m.group(2)),
            text,
        )
        text = _DATE_RE.sub(_date_sub, text)
        text = _YEAR_RE.sub(lambda m: digits_to_hanzi(m.group(1)) + "年", text)
        text = _MOBILE_RE.sub(lambda m: digits_to_hanzi(m.group(1)), text)
        text = _LANDLINE_RE.sub(
            lambda m: digits_to_hanzi(m.group(1)) + digits_to_hanzi(m.group(2)), text
        )
        text = _TIME_RE.sub(
            lambda m: m.group(0)
            if _SCORE_CUE_RE.search(text[max(0, m.start() - 4):m.start()])
            else _time_sub(m),
            text,
        )
        text = _PERCENT_RE.sub(lambda m: "百分之" + decimal_to_hanzi(m.group(1)), text)
        text = _FRACTION_RE.sub(
            lambda m: int_to_hanzi(int(m.group(2))) + "分之" + int_to_hanzi(int(m.group(1))), text
        )
        text = _RANGE_RE.sub(
            lambda m: decimal_to_hanzi(m.group(1)) + "到" + decimal_to_hanzi(m.group(2)), text
        )
        text = _MONEY_RE.sub(
            lambda m: decimal_to_hanzi(m.group(1)) + m.group(2), text
        )
        text = _QUANT_RE.sub(
            lambda m: decimal_to_hanzi(m.group(1)) + m.group(2) + m.group(3), text
        )
        text = _PHONE_RE.sub(lambda m: digits_to_hanzi(m.group(0)), text)
        text = _NUMBER_RE.sub(lambda m: decimal_to_hanzi(m.group(0).replace(",", "")), text)
        return text
