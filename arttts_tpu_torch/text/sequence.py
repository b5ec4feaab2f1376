"""Text -> symbol-id sequences for the GradTTS path (ref `src/text/__init__.py`;
a copy of `arttts_tpu/text/sequence.py`).

Supports curly-brace embedded ARPAbet ("{HH AW1 S}") and CMUdict lookup.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

from arttts_tpu_torch.text.cleaners import clean_text
from arttts_tpu_torch.text.cmudict import CMUDict
from arttts_tpu_torch.text.symbols import symbols

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def get_arpabet(word: str, dictionary: CMUDict) -> str:
    prons = dictionary.lookup(word)
    return "{" + prons[0] + "}" if prons is not None else word


def text_to_sequence(
    text: str,
    cleaner_names: Sequence[str] = ("english_cleaners",),
    dictionary: Optional[CMUDict] = None,
) -> List[int]:
    """Symbol-id encoding with optional CMUdict ARPAbet substitution."""
    sequence: List[int] = []
    space = _symbols_to_sequence(" ")
    while len(text):
        m = _curly_re.match(text)
        if not m:
            cleaned = clean_text(text, cleaner_names)
            if dictionary is not None:
                words = [get_arpabet(w, dictionary) for w in cleaned.split(" ")]
                for t in words:
                    if t.startswith("{"):
                        sequence += _arpabet_to_sequence(t[1:-1])
                    else:
                        sequence += _symbols_to_sequence(t)
                    sequence += space
            else:
                sequence += _symbols_to_sequence(cleaned)
            break
        sequence += _symbols_to_sequence(clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)

    if dictionary is not None and sequence and sequence[-1] == space[0]:
        sequence = sequence[:-1]
    return sequence


def sequence_to_text(sequence: Sequence[int]) -> str:
    result = ""
    for sid in sequence:
        if sid in _id_to_symbol:
            s = _id_to_symbol[sid]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            result += s
    return result.replace("}{", " ")


def intersperse(lst: List[int], item: int) -> List[int]:
    """Insert `item` between/around every element (ref `src/utils.py:36`)."""
    result = [item] * (len(lst) * 2 + 1)
    result[1::2] = lst
    return result


def _symbols_to_sequence(syms) -> List[int]:
    return [_symbol_to_id[s] for s in syms if _should_keep(s)]


def _arpabet_to_sequence(text: str) -> List[int]:
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep(s: str) -> bool:
    return s in _symbol_to_id and s not in ("_", "~")
