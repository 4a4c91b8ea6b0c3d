"""Smart sentence chunking for TTS (capability parity with reference
tokenizer.py:51-236 `split_sentence` / `find_best_split_point`, built on a
first-party rule-based sentencizer instead of spaCy).

Long text is split into chunks no longer than the per-language character
limit; boundaries prefer sentence ends, then clause punctuation, then any
whitespace — this is what bounds decode sequence length (SURVEY.md §5
long-context strategy) so requests scale out, not up.
"""
from __future__ import annotations

import re
from typing import List

# Sentence-terminal punctuation across the supported scripts
# (। ॥ are the Devanagari danda/double-danda used by Hindi).
_TERMINALS = ".!?…。！？؟।॥"
_SENT_RE = re.compile(
    rf"[^{_TERMINALS}]*[{_TERMINALS}]+[\"'»”’)]*\s*|[^{_TERMINALS}]+$",
    re.DOTALL,
)

# Common abbreviations that end with '.' but don't end a sentence.
_NON_TERMINAL_DOT = {
    "mr", "mrs", "dr", "st", "co", "jr", "sr", "prof", "rev", "gen", "lt",
    "col", "sgt", "capt", "maj", "etc", "vs", "e.g", "i.e", "fig", "no",
    "vol", "dept", "approx", "sra", "sig", "mme", "dhr", "ing",
}

# Break-point preference used when a single sentence exceeds the limit.
_BREAK_PATTERNS: list[tuple[re.Pattern, float]] = [
    (re.compile(rf"[{_TERMINALS}]+[\s]*"), 1.0),
    (re.compile(r"[\n\r]+\s*[\n\r]+"), 1.0),
    (re.compile(r"[:;；：][\s]*"), 0.9),
    (re.compile(r"[,，、،][\s]*"), 0.8),
    (re.compile(r"[)\]}）】』»›》][\s]*"), 0.7),
    (re.compile(r"[-—–−]+[\s]*"), 0.7),
    (re.compile(r"\s+"), 0.5),
]


def split_into_sentences(text: str) -> List[str]:
    """Rule-based sentencizer: split at terminal punctuation unless it
    belongs to a known abbreviation or a decimal number."""
    raw = [m.group(0) for m in _SENT_RE.finditer(text) if m.group(0).strip()]
    sentences: List[str] = []
    for piece in raw:
        if sentences:
            prev = sentences[-1].rstrip()
            last_word = prev[:-1].rsplit(" ", 1)[-1].lower().strip("\"'()") if prev.endswith(".") else ""
            # merge "Dr." + "Smith went..." and "3." + "5 percent"
            if prev.endswith(".") and (
                last_word in _NON_TERMINAL_DOT
                or (last_word[:-0] or "").isdigit() and piece[:1].isdigit()
                or last_word.isdigit() and piece[:1].isdigit()
                or len(last_word) == 1 and last_word.isalpha()
            ):
                sentences[-1] = sentences[-1] + piece
                continue
        sentences.append(piece)
    return [s.strip() for s in sentences if s.strip()]


def find_split_point(text: str, target_pos: int, window_size: int = 30) -> int:
    """Best break position near `target_pos`, scoring marker strength against
    distance from the target."""
    start = max(0, target_pos - window_size)
    end = min(len(text), target_pos + window_size)
    window = text[start:end]

    best_pos, best_score = target_pos, 0.0
    for pattern, priority in _BREAK_PATTERNS:
        for m in pattern.finditer(window):
            pos = start + m.end()
            if pos <= 0 or pos >= len(text):
                continue
            distance_score = 1.0 - abs(pos - target_pos) / (window_size * 2)
            score = priority * distance_score
            if score > best_score:
                best_score, best_pos = score, pos
    return best_pos


def split_text_into_chunks(text: str, max_length: int = 250, window_size: int = 30) -> List[str]:
    """Pack sentences greedily into chunks of <= max_length chars; sentences
    longer than the limit are split at the best interior break points."""
    text = text.strip()
    if len(text) <= max_length:
        return [text] if text else []

    chunks: List[str] = []
    current: List[str] = []
    current_len = 0

    def flush():
        nonlocal current, current_len
        if current:
            chunks.append(" ".join(current))
            current, current_len = [], 0

    for sent in split_into_sentences(text):
        n = len(sent)
        if current_len + n <= max_length:
            current.append(sent)
            current_len += n + 1
        elif n > max_length:
            flush()
            remaining = sent
            while len(remaining) > max_length:
                pos = find_split_point(remaining, max_length, window_size)
                if pos <= 0 or pos >= len(remaining):
                    pos = max_length
                chunks.append(remaining[:pos].strip())
                remaining = remaining[pos:].strip()
            if remaining:
                current = [remaining]
                current_len = len(remaining)
        else:
            flush()
            current = [sent]
            current_len = n
    flush()

    # Trailing hard stop can produce clicky artifacts in some languages
    # (reference keeps this tweak, tokenizer.py:234): soften final '.'
    return [c[:-1] + " " if c.endswith(".") else c for c in chunks if c]
