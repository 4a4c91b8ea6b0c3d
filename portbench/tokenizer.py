"""The benchmark's text tokenizer: a BPE of at most 3000 ids trained with
the `tokenizers` library on the traffic's word list, so every generated
word encodes to one or a few ids, as a published vocabulary encodes
English. The program gets it wrapped in its own front end; the reference
reads the same JSON."""
from __future__ import annotations

from pathlib import Path

SPECIAL = ["[PAD]", "[UNK]", "[START]", "[STOP]", "[SPACE]", "[en]"]


def train(root: Path) -> str:
    """The trained tokenizer as its JSON string."""
    from tokenizers import Tokenizer, models, trainers

    tok = Tokenizer(models.BPE(unk_token="[UNK]"))
    trainer = trainers.BpeTrainer(vocab_size=3000, special_tokens=SPECIAL, show_progress=False)
    words = (root / "portbench" / "traffic" / "words.txt").read_text().split()
    tok.train_from_iterator(words + ["abcdefghijklmnopqrstuvwxyz.,"], trainer)
    return tok.to_str()
