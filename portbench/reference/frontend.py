"""The reference's text front end, for the texts the benchmark generates:
sentences of lower-case words and commas, each ending in one period, with
no number, symbol or abbreviation for the published cleaners to expand.

For such a text the published front end (XTTS `tokenizer.py`:
`split_sentence` and `preprocess_text`) comes down to: keep a text of at
most `limit` characters whole; else pack whole sentences greedily into
chunks of at most `limit` characters and drop each chunk's final period;
lower-case, collapse and strip the whitespace; prefix `[en]`, write each
space as `[SPACE]`, BPE-encode, and add `[START]` and `[STOP]`."""
from __future__ import annotations

import re

from tokenizers import Tokenizer
from tokenizers.pre_tokenizers import WhitespaceSplit

LIMIT_EN = 250


def chunks(text: str, limit: int = LIMIT_EN) -> list[str]:
    """The text chunks the front end decodes separately."""
    text = text.strip()
    if len(text) <= limit:
        return [text] if text else []
    sentences = [s.strip() for s in re.findall(r"[^.]*\.", text) if s.strip()]
    if any(len(s) > limit for s in sentences) or "".join(sentences).count(".") != text.count("."):
        raise ValueError("a generated sentence is longer than the chunk limit")
    out, cur, cur_len = [], [], 0
    for s in sentences:
        if cur_len + len(s) <= limit:
            cur.append(s)
            cur_len += len(s) + 1
        else:
            out.append(" ".join(cur))
            cur, cur_len = [s], len(s)
    out.append(" ".join(cur))
    return [c[:-1] + " " if c.endswith(".") else c for c in out]


def encoder(tokenizer_json: str) -> Tokenizer:
    """The BPE tokenizer as the published wrapper configures it."""
    tok = Tokenizer.from_str(tokenizer_json)
    tok.pre_tokenizer = WhitespaceSplit()
    return tok


def prompt_ids(tok: Tokenizer, chunk: str, lang: str = "en") -> list[int]:
    """[START] + BPE ids of "[lang]" + the normalised chunk + [STOP]."""
    text = re.sub(r"\s+", " ", chunk.lower()).strip()
    ids = tok.encode(f"[{lang}]" + text.replace(" ", "[SPACE]")).ids
    return [tok.token_to_id("[START]"), *ids, tok.token_to_id("[STOP]")]
