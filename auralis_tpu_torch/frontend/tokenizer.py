"""XTTS text tokenizer (capability parity with reference
models/xttsv2/config/tokenizer.py:742-1002 `XTTSTokenizerFast`).

A thin first-party wrapper over a `tokenizers` BPE: whitespace-split
pre-tokenization, per-language normalization (cleaners), a `[lang]` prefix,
`[SPACE]` word separators and `[START]`/`[STOP]` sentinels. Also owns the
per-language character limits that drive smart chunking.
"""
from __future__ import annotations

import os
from typing import List, Union

from tokenizers import Tokenizer
from tokenizers.pre_tokenizers import WhitespaceSplit

from .cleaners import preprocess_text
from .sentence import split_text_into_chunks

# Max characters per chunk for each language (limits decode length; reference
# tokenizer.py:784-789).
CHAR_LIMITS = {
    "en": 250, "de": 253, "fr": 273, "es": 239,
    "it": 213, "pt": 203, "pl": 224, "zh": 82,
    "ar": 166, "cs": 186, "ru": 182, "nl": 251,
    "tr": 226, "ja": 71, "hu": 224, "ko": 95,
    # the reference lists hi but never assigns it a limit (falls to the 250
    # default); Devanagari is an abugida — denser than Latin per syllable —
    # so it gets a budget between ru (182) and ar (166)
    "hi": 180,
}
DEFAULT_CHAR_LIMIT = 250


class TTSTokenizer:
    """BPE tokenizer + multilingual normalization front end."""

    def __init__(
        self,
        tokenizer: Tokenizer,
        bos_token: str = "[START]",
        eos_token: str = "[STOP]",
        unk_token: str = "[UNK]",
        pad_token: str = "[PAD]",
        space_token: str = "[SPACE]",
    ):
        tokenizer.pre_tokenizer = WhitespaceSplit()
        self.tokenizer = tokenizer
        self.bos_token, self.eos_token = bos_token, eos_token
        self.unk_token, self.pad_token = unk_token, pad_token
        self.space_token = space_token
        self.bos_token_id = tokenizer.token_to_id(bos_token)
        self.eos_token_id = tokenizer.token_to_id(eos_token)
        self.pad_token_id = tokenizer.token_to_id(pad_token)
        self.unk_token_id = tokenizer.token_to_id(unk_token)
        self.char_limits = dict(CHAR_LIMITS)

    # ------------------------------------------------------------- loading
    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "TTSTokenizer":
        """Load from a model directory containing tokenizer.json (or a direct
        path to the json file)."""
        candidates = [path] if path.endswith(".json") else [
            os.path.join(path, "tokenizer.json"),
            os.path.join(path, "vocab.json"),
        ]
        for cand in candidates:
            if os.path.isfile(cand):
                return cls(Tokenizer.from_file(cand), **kwargs)
        raise FileNotFoundError(f"No tokenizer.json found under {path}")

    def save(self, path: str) -> None:
        self.tokenizer.save(path)

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.get_vocab_size()

    # ------------------------------------------------------------ encoding
    def _format(self, text: str, lang: str) -> str:
        base = lang.split("-")[0]
        lang_code = "zh-cn" if base == "zh" else base
        text = preprocess_text(text, lang)
        return f"[{lang_code}]{text}".replace(" ", self.space_token)

    def encode(self, text: str, lang: str = "en") -> List[int]:
        """Normalized token ids WITHOUT bos/eos (the engine adds those —
        reference XTTSv2.py:519-522)."""
        return self.tokenizer.encode(self._format(text, lang)).ids

    def batch_encode(self, texts: List[str], lang: Union[str, List[str]] = "en") -> List[List[int]]:
        langs = [lang] * len(texts) if isinstance(lang, str) else lang
        if len(langs) == 1 and len(texts) > 1:
            langs = langs * len(texts)
        if len(langs) != len(texts):
            raise ValueError(f"{len(texts)} texts but {len(langs)} languages")
        encodings = self.tokenizer.encode_batch(
            [self._format(t, l) for t, l in zip(texts, langs)]
        )
        return [e.ids for e in encodings]

    def encode_with_split(
        self, text: Union[str, List[str]], lang: str = "en"
    ) -> List[List[int]]:
        """Chunk long text by the language's character limit, then encode each
        chunk (reference tokenizer.py:821-869 `batch_encode_with_split`).
        List inputs chunk per-element (each element is an independent text
        unit, matching the reference's list handling) and encode as one
        batch."""
        base = lang.split("-")[0]
        limit = self.char_limits.get(base, DEFAULT_CHAR_LIMIT)
        texts = [text] if isinstance(text, str) else list(text)
        chunks = [
            c for t in texts for c in split_text_into_chunks(t, max_length=limit)
        ]
        if not chunks:
            return []
        return self.batch_encode(chunks, lang)

    def split_text(self, text: str, lang: str = "en") -> List[str]:
        base = lang.split("-")[0]
        limit = self.char_limits.get(base, DEFAULT_CHAR_LIMIT)
        return split_text_into_chunks(text, max_length=limit)

    def decode(self, ids: List[int]) -> str:
        text = self.tokenizer.decode(list(ids), skip_special_tokens=False)
        return text.replace(self.space_token, " ")

    def check_input_length(self, text: str, lang: str) -> bool:
        base = lang.split("-")[0]
        return len(text) <= self.char_limits.get(base, DEFAULT_CHAR_LIMIT)


# Reference-compatible alias (public name in the reference API surface).
XTTSTokenizerFast = TTSTokenizer
