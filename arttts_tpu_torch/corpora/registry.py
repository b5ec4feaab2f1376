"""Corpus registry (port of `arttts_tpu/corpora/registry.py`, ref
`src/generate_phnm3.py:8-13` dataset_params). mngu0 has no EMA reader
here, as in the JAX package."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from arttts_tpu_torch.corpora import readers


@dataclass(frozen=True)
class Corpus:
    name: str
    label_ext: str
    get_phnm3: Callable
    get_ema: Callable | None = None
    get_sentence: Callable | None = None


CORPORA = {
    "mngu0": Corpus("mngu0", ".lab", readers.get_mngu0_phnm3, None,
                    readers.get_mngu0_sentence),
    "mocha": Corpus("mocha", ".phnm", readers.get_mocha_phnm3,
                    readers.get_mocha_ema, readers.get_mocha_sentence),
    "mspka": Corpus("mspka", ".lab", readers.get_mspka_phnm3,
                    readers.get_mspka_ema, readers.get_mspka_sentence),
    "pb2007": Corpus("pb2007", ".phone", readers.get_pb2007_phnm3,
                     readers.get_pb2007_ema, None),
}


def get_corpus(name: str) -> Corpus:
    if name not in CORPORA:
        raise KeyError(f"unknown corpus {name!r}; have {sorted(CORPORA)}")
    return CORPORA[name]
