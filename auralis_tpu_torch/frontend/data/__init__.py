"""Embedded reading tables for first-party zh/ja transliteration
(replaces the reference's pypinyin / cutlet+MeCab dependencies,
reference tokenizer.py:727-735, which are unavailable in this image)."""
