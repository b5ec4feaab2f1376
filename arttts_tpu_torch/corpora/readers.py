"""Corpus file readers (port of `arttts_tpu/corpora/readers.py`): label
files -> phnm3, EMA binaries -> (T, 12) arrays.

Equivalents of `src/utils_dataset/{mngu0,mocha,mspka,pb2007}.py`: EST-format
binary EMA tracks, per-corpus label parsing, and IPA conversion through the
tables in `arttts_tpu_torch/corpora/tables.py`.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from arttts_tpu_torch.corpora.tables import (
    MNGU0_TO_IPA,
    MOCHA_IDX_TO_KEEP,
    MSPKA_EMA_IDX_TO_KEEP,
    MSPKA_TO_IPA,
    PB2007_IDX_TO_KEEP,
    PB2007_TO_IPA,
)
from arttts_tpu_torch.text.phnms import PHNM3_DTYPE

PB2007_EMA_SR = 100


# --------------------------------------------------------------------------
# MNGU0
# --------------------------------------------------------------------------
def get_mngu0_sentence(utt_file) -> str | None:
    """Extract the prompt from a MNGU0 .utt file ('iform' attribute)."""
    with open(utt_file, "r", encoding="utf-8") as f:
        for line in f:
            if line.startswith("Features"):
                m = re.search(r'iform\s+"?(\\?"?[^";]+\\?"?)"?\s*;', line)
                if m:
                    return m.group(1).strip('"\\')
    return None


def get_mngu0_phnm3(lab_file) -> np.ndarray:
    """MNGU0 .lab (end-time, level, phone) rows after '#' -> phnm3."""
    with open(lab_file, "r", encoding="utf-8") as f:
        lines = f.readlines()
    first = lines.index("#\n") + 1
    rows: List[Tuple[float, float, str]] = []
    start = 0.0
    for line in lines[first:]:
        parts = line.split()
        end = float(parts[0])
        rows.append((start, end, MNGU0_TO_IPA[parts[2]]))
        start = end
    return np.array(rows, dtype=PHNM3_DTYPE)


def read_mngu0_ema(raw_ema_fp) -> Dict[str, np.ndarray]:
    """EST-track binary reader: header declares per-channel columns; body is
    float32 frames of (time, present, channels...)."""
    columns = {"time": 0, "present": 1}
    with open(raw_ema_fp, "rb") as f:
        f.readline()  # EST_File Track
        f.readline()  # DataType
        f.readline()  # ByteOrder
        f.readline()  # NumFrames
        f.readline()  # NumChannels
        while "CommentChar" not in f.readline().decode("utf-8", "ignore"):
            pass
        f.readline()  # blank
        line = f.readline()
        while "EST_Header_End" not in line.decode("utf-8", "ignore"):
            text = line.decode("utf-8").strip()
            idx = int(text.split()[0].split("_")[1]) + 2
            columns[text.split()[1]] = idx
            line = f.readline()
        data = np.frombuffer(f.read(), dtype=np.float32).reshape(-1, len(columns))
    return {"columns": columns, "data": data}


# --------------------------------------------------------------------------
# MOCHA-TIMIT
# --------------------------------------------------------------------------
def get_mocha_sentence(trans_file) -> str:
    with open(trans_file, "r") as f:
        return f.readline().strip()


def get_mocha_phnm3(phnm_file) -> np.ndarray:
    """MOCHA .phnm rows (start end phone); 'sil' -> '.', rhotacized vowels
    normalized to the ARPAbet-derived forms."""
    special = {"sil": ".", "ɚ": "ə˞", "ɝ": "ɜ˞"}
    rows = []
    with open(phnm_file, "r") as f:
        for line in f:
            if not line.strip():
                continue
            s, e, phone = line.strip().split()
            rows.append((float(s), float(e), special.get(phone, phone)))
    return np.array(rows, dtype=PHNM3_DTYPE)


def read_mocha_ema(src_ema_fp) -> Dict[str, np.ndarray]:
    """EST-format binary: ASCII header to EST_Header_End, then float32
    frames of (time, valid, 20 EMA values)."""
    header = []
    with open(src_ema_fp, "rb") as f:
        while True:
            line = f.readline().decode("ascii")
            header.append(line)
            if line.strip() == "EST_Header_End":
                break
        data = np.fromfile(f, dtype=np.float32)
    frames = data.reshape(-1, 22)
    return {
        "time": frames[:, 0],
        "valid": frames[:, 1],
        "ema": frames[:, 2:22],
        "header": header,
    }


def get_mocha_ema(src_ema_fp) -> np.ndarray:
    """(T, 12) SPARC-ordered midsagittal channels."""
    return read_mocha_ema(src_ema_fp)["ema"][:, MOCHA_IDX_TO_KEEP].astype(np.float32)


# --------------------------------------------------------------------------
# MSPKA
# --------------------------------------------------------------------------
def _decode_mspka(lab_file) -> List[List[str]]:
    """MSPKA .lab files carry octal-escaped UTF-8 in latin1."""
    with open(lab_file, "rb") as f:
        raw = f.read()
    text = (
        raw.decode("latin1")
        .encode("latin1")
        .decode("unicode_escape")
        .encode("latin1")
        .decode("utf-8")
    )
    return [ln.strip().split(" ") for ln in text.splitlines() if ln.strip()]


def get_mspka_sentence(lab_file) -> str:
    words = [ln[3] for ln in _decode_mspka(lab_file) if len(ln) == 4 and ln[2] != "sil"]
    return " ".join(words)


def get_mspka_phnm3(lab_file) -> np.ndarray:
    rows: List[Tuple[float, float, str]] = []
    for ln in _decode_mspka(lab_file):
        if len(ln) == 4:
            s, e, phone = ln[0], ln[1], ln[2]
        elif len(ln) == 3:
            s, e, phone = ln
        else:
            continue
        s, e = float(s), float(e)
        if phone == "nf":  # split the n-f cluster evenly
            mid = (s + e) / 2
            rows += [(s, mid, "n"), (mid, e, "f")]
        else:
            rows.append((s, e, phone))
    rows = [(s, e, MSPKA_TO_IPA[p]) for s, e, p in rows]
    return np.array(rows, dtype=PHNM3_DTYPE)


def get_mspka_ema(src_ema_fp) -> np.ndarray:
    """ASCII (n_channels, T) matrix -> (T, 12) midsagittal selection."""
    with open(src_ema_fp, "r") as f:
        lines = [ln.strip().split() for ln in f]
    ema = np.array(lines, dtype=np.float32)
    return ema[MSPKA_EMA_IDX_TO_KEEP, :].T


# --------------------------------------------------------------------------
# PB2007
# --------------------------------------------------------------------------
def get_pb2007_phnm3(phone_file) -> np.ndarray:
    rows = []
    with open(phone_file, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) == 3:
                s, e, phone = parts
                rows.append(
                    (float(s) / PB2007_EMA_SR, float(e) / PB2007_EMA_SR,
                     PB2007_TO_IPA[phone])
                )
    return np.array(rows, dtype=PHNM3_DTYPE)


def get_pb2007_ema(src_ema_fp) -> np.ndarray:
    ema = np.fromfile(src_ema_fp, dtype=np.float32).reshape(-1, 12)
    return ema[:, PB2007_IDX_TO_KEEP]
