"""Filelist parsing (ref `src/utils.py:43-46`): pipe-separated lines."""

from __future__ import annotations

from typing import List


def parse_filelist(filelist_path: str, split_char: str = "|") -> List[List[str]]:
    with open(filelist_path, encoding="utf-8") as f:
        return [line.strip().split(split_char) for line in f if line.strip()]
