"""VoxCommunis manifest/alignment IO (a copy of
`arttts_tpu/voxcommunis/io.py`).

File formats (behavioral spec from `src/voxcommunis/io.py:10-41`):

* manifest (``.tsv``): first line is the dataset root directory; every
  following line is ``<relative wav path>\t<num samples>``. Sample ids are
  the file stems and must be unique.
* alignment (``.align``): lines of ``<file id>\t<space-joined phone string>``
  (100 Hz frame-level phones from the forced aligner).

Frame counts are read with the stdlib ``wave`` module — no soundfile
dependency.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Dict, Tuple


def write_manifest(dataset, output, file_extension: str = ".wav") -> None:
    """Scan `dataset` recursively and write a manifest TSV."""
    root = Path(dataset).resolve()
    rows = [root.as_posix()]
    for wav_path in sorted(root.rglob(f"*{file_extension}")):
        with wave.open(str(wav_path), "rb") as handle:
            n = handle.getnframes()
        rows.append(f"{wav_path.relative_to(root)}\t{n}")
    Path(output).write_text("\n".join(rows) + "\n")


def read_manifest(file_path) -> Dict[str, Tuple[Path, int]]:
    """Manifest TSV -> {file_id: (absolute path, num_samples)}."""
    lines = Path(file_path).read_text().splitlines()
    if not lines:
        raise ValueError(f"empty manifest: {file_path}")
    root = Path(lines[0].strip())
    manifest: Dict[str, Tuple[Path, int]] = {}
    for line in lines[1:]:
        if not line.strip():
            continue
        rel, _, count = line.partition("\t")
        if not count:
            raise ValueError(f"Invalid tsv file: {file_path}")
        wav_path = root / rel
        if wav_path.stem in manifest:
            raise ValueError(f"Duplicate file id: {wav_path.stem}")
        manifest[wav_path.stem] = (wav_path, int(count))
    return manifest


def read_alignment(path) -> Dict[str, str]:
    """Alignment TSV -> {file_id: phone string} (kept as strings — parsing
    every line to a list up front is memory-heavy at corpus scale)."""
    phones: Dict[str, str] = {}
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        file_id, _, phone_str = line.partition("\t")
        if not phone_str:
            raise ValueError(f"malformed alignment row in {path}: {line!r}")
        phones[file_id] = phone_str
    return phones
