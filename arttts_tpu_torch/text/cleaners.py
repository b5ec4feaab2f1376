"""Text cleaners (Tacotron lineage), ref `src/text/cleaners.py` (a copy of
`arttts_tpu/text/cleaners.py`, which the port may not import).

`english_cleaners` is the GradTTS path; `english_cleaners_v2` additionally
isolates punctuation with spaces (the ArtTTS ternary path). ASCII
transliteration is done with a unicodedata NFKD fallback instead of the
unidecode dependency.
"""

from __future__ import annotations

import re
import unicodedata

from arttts_tpu_torch.text.numbers import normalize_numbers
from arttts_tpu_torch.text.symbols import PUNCTUATION

_whitespace_re = re.compile(r"\s+")

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
        ("&", "and"),
    ]
]

_PUNCTUATION_LIST = list(PUNCTUATION) + ["--"]

# Common transliterations NFKD alone cannot produce.
_TRANSLIT = {
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE", "ß": "ss", "ø": "o",
    "Ø": "O", "đ": "d", "Đ": "D", "þ": "th", "Þ": "Th", "ð": "d", "Ð": "D",
    "ł": "l", "Ł": "L", "’": "'", "‘": "'", "“": '"', "”": '"', "—": "-",
    "–": "-", "…": "...",
}


def convert_to_ascii(text: str) -> str:
    text = "".join(_TRANSLIT.get(c, c) for c in text)
    text = unicodedata.normalize("NFKD", text)
    return text.encode("ascii", "ignore").decode("ascii")


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _ABBREVIATIONS:
        text = regex.sub(replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text)


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


def english_cleaners_v2(text: str) -> str:
    """english_cleaners + punctuation isolated by spaces and stripped ends."""

    def pad_punctuation(t: str) -> str:
        return "".join(f" {c} " if c in _PUNCTUATION_LIST else c for c in t)

    text = lowercase(text)
    text = expand_numbers(text)
    text = convert_to_ascii(text)
    text = expand_abbreviations(text)
    text = pad_punctuation(text)
    text = collapse_whitespace(text)
    return text.strip()


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
    "english_cleaners_v2": english_cleaners_v2,
}


def clean_text(text: str, cleaner_names) -> str:
    for name in cleaner_names:
        text = CLEANERS[name](text)
    return text
