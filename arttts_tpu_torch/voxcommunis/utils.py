"""Small sequence helpers (a copy of `arttts_tpu/voxcommunis/utils.py`,
ref `src/voxcommunis/utils.py:16-32`)."""

from __future__ import annotations

import itertools
from typing import Sequence


def flatten_lists(lists_2d):
    return [x for sub in lists_2d for x in sub]


def unique_consecutive(seq: Sequence, return_counts: bool = False):
    """Run-length encode: ("a","a","b") -> ("a","b") [, (2, 1)]."""
    pairs = [(el, len(list(gr))) for el, gr in itertools.groupby(seq)]
    unique = tuple(p[0] for p in pairs)
    if return_counts:
        return unique, tuple(p[1] for p in pairs)
    return unique
