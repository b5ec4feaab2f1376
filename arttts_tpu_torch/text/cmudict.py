"""CMU pronouncing dictionary parser (ARPAbet), ref `src/text/cmudict.py` (a
copy of `arttts_tpu/text/cmudict.py`).

The dictionary file itself is the public-domain CMUdict resource
(`src/resources/cmu_dictionary`); entries are `WORD  AR P AH0 BET` lines in
latin-1, with `(n)` suffixes marking alternate pronunciations.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

VALID_ARPABET = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0", "AH1",
    "AH2", "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2", "AY", "AY0",
    "AY1", "AY2", "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2", "ER", "ER0",
    "ER1", "ER2", "EY", "EY0", "EY1", "EY2", "F", "G", "HH", "IH", "IH0",
    "IH1", "IH2", "IY", "IY0", "IY1", "IY2", "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1", "OY2", "P", "R", "S", "SH",
    "T", "TH", "UH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2", "V", "W",
    "Y", "Z", "ZH",
]

_VALID_SET = frozenset(VALID_ARPABET)
_ALT_RE = re.compile(r"\([0-9]+\)")


class CMUDict:
    """Word -> list of ARPAbet pronunciation strings."""

    def __init__(self, file_or_path, keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse(f)
        else:
            entries = _parse(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries: Dict[str, List[str]] = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        return self._entries.get(word.upper())


def _parse(file) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for line in file:
        if len(line) and (("A" <= line[0] <= "Z") or line[0] == "'"):
            parts = line.split("  ")
            if len(parts) < 2:
                continue
            word = _ALT_RE.sub("", parts[0])
            pron = _validate(parts[1])
            if pron:
                out.setdefault(word, []).append(pron)
    return out


def _validate(s: str) -> Optional[str]:
    parts = s.strip().split(" ")
    for p in parts:
        if p not in _VALID_SET:
            return None
    return " ".join(parts)
