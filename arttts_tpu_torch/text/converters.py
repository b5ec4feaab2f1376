"""Text -> ARPAbet -> IPA -> ternary trait embeddings (ArtTTS path).

A copy of `arttts_tpu/text/converters.py`, on the port's own trait table
(`text/ipa_features.py`). Behavioral equivalent of the reference's
`src/text/converters.py`: CMUdict
lookup with dash-splitting for composed words, the NVIDIA NeMo
ARPAbet->IPA table, "%"-joined IPA phoneme strings, and 25-dim ternary
sequences (24 phonological traits + 1 silence/punctuation dim) with optional
diphthong merging by trait agreement.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import numpy as np

from arttts_tpu_torch.text.cleaners import clean_text
from arttts_tpu_torch.text.cmudict import CMUDict
from arttts_tpu_torch.text.ipa_features import (
    N_TRAITS,
    segment_features,
    word_features,
)
from arttts_tpu_torch.text.symbols import PUNCTUATION

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")
_composed_re = re.compile(r"\b[a-zA-Z]+(?:-[a-zA-Z]+)+\b")

PUNCTUATION_LIST = list(PUNCTUATION) + ["--"]
SIGNIFICATIVE_PUNC = ["!", ",", ".", ":", ";", "?", "|", "--"]

EMB_DIM = N_TRAITS + 1  # +1 silence/punctuation dim (converters.py:56-60)

_space_tok = np.zeros((1, EMB_DIM), dtype=np.float32)
_space_tok[0, -1] = -1
_punc_tok = np.zeros((1, EMB_DIM), dtype=np.float32)
_punc_tok[0, -1] = 1

# CMU ARPAbet -> IPA (NVIDIA NeMo cmudict-arpabet_to_ipa table, as used at
# converters.py:65-108; affricates use tie bars to stay single segments).
ARPABET2IPA = {
    "AA": "ɑ", "AE": "æ", "AH0": "ə", "AH1": "ʌ", "AH2": "ʌ", "AO": "ɔ",
    "AW": "aʊ", "AY": "aɪ", "B": "b", "CH": "t͡ʃ", "D": "d", "DH": "ð",
    "EH": "ɛ", "ER": "ɜ˞", "ER0": "ə˞", "EY": "eɪ", "F": "f", "G": "ɡ",
    "HH": "h", "IH": "ɪ", "IY": "i", "JH": "d͡ʒ", "K": "k", "L": "l",
    "M": "m", "N": "n", "NG": "ŋ", "OW": "oʊ", "OY": "ɔɪ", "P": "p",
    "R": "ɹ", "S": "s", "SH": "ʃ", "T": "t", "TH": "θ", "UH": "ʊ",
    "UW": "u", "V": "v", "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}

DIPHTHONGS_IPA = [
    "aʊ", "aɪ", "ɔɪ", "eɪ", "oʊ",  # CMU vocab
    "əʊ", "ɛɪ", "ɪə", "ɛə", "ʊə",  # MNGU0 vocab
]


def text_to_ipa(
    text: str,
    dictionary: Optional[CMUDict] = None,
    cleaner_names: Sequence[str] = ("english_cleaners_v2",),
    remove_punctuation: bool = False,
) -> Optional[List[str]]:
    """Text -> list of "%"-joined IPA words (or punctuation tokens)."""
    arp_list = text_to_arpabet(text, dictionary, cleaner_names)
    arp_list = check_arpabet(arp_list, remove_punctuation=remove_punctuation)
    if arp_list is None:
        return None
    return [get_ipa_from_arp(w) for w in arp_list]


def ipa_to_ternary(
    ipawords_list: List[str],
    merge_diphtongues: bool = True,
) -> np.ndarray:
    """List of "%"-joined IPA words -> (n_chars, 25) float ternary sequence.

    Diphthongs optionally merge into one vector keeping only agreeing traits
    (converters.py:172-179); spaces/significant punctuation map to the
    dedicated 25th dim (-1 space, +1 punctuation).
    """
    joined = "%".join(ipawords_list)
    rows: List[np.ndarray] = []
    for char_ipa in joined.split("%"):
        if char_ipa in PUNCTUATION_LIST:
            if char_ipa == " ":
                rows.append(_space_tok)
            elif char_ipa in SIGNIFICATIVE_PUNC:
                rows.append(_punc_tok)
        else:
            if merge_diphtongues and char_ipa in DIPHTHONGS_IPA:
                emb_0 = segment_features(char_ipa[0]).astype(np.float32)
                emb_1 = segment_features(char_ipa[1]).astype(np.float32)
                emb = np.where(emb_0 == emb_1, emb_0, 0.0)[None, :]
            else:
                feats = word_features(char_ipa)  # multi-segment aware
                if feats is None:
                    continue  # unknown segment: skip, like the reference
                emb = feats.astype(np.float32)
            rows.append(
                np.pad(emb, ((0, 0), (0, 1)), constant_values=0.0)
            )
    return np.concatenate(rows, axis=0)


def get_arpabet_dash(word: str, dictionary: CMUDict) -> List[str]:
    """Dict lookup; composed dashed words fall back to per-part lookup."""
    prons = dictionary.lookup(word)
    if prons is not None:
        return ["{" + prons[0] + "}"]
    if _composed_re.match(word):
        return [get_arpabet_dash(w, dictionary)[0] for w in word.split("-")]
    return [word]


def text_to_arpabet(
    text: str,
    dictionary: Optional[CMUDict] = None,
    cleaner_names: Sequence[str] = ("english_cleaners_v2",),
) -> List[str]:
    """Text -> list of "{AR P AH0}" words / punctuation tokens."""
    arp_words: List[str] = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            cleaned = clean_text(text, cleaner_names)
            for w in cleaned.split(" "):
                arp_words += get_arpabet_dash(w, dictionary)
            break
        arp_words += text_to_arpabet(m.group(1), dictionary, cleaner_names)
        arp_words += ["{" + m.group(2) + "}"]
        text = m.group(3)
    return arp_words


def check_arpabet(
    arp_words: List[str], remove_punctuation: bool = False
) -> Optional[List[str]]:
    """None unless every token is ARPAbet-braced or punctuation."""
    for elem in arp_words:
        is_arp = elem.startswith("{") and elem.endswith("}")
        if not (is_arp or elem in PUNCTUATION_LIST):
            return None
    if remove_punctuation:
        return [e for e in arp_words if e not in PUNCTUATION_LIST]
    return arp_words


def get_ipa_from_arp(arp_seq: str) -> Optional[str]:
    """"{P R IH1 N T}" -> "p%ɹ%ɪ%n%t"; punctuation passes through."""

    def arpchar_to_ipa(arp: str) -> str:
        if arp in ARPABET2IPA:
            return ARPABET2IPA[arp]
        return ARPABET2IPA[arp.replace("1", "").replace("2", "").replace("0", "")]

    if arp_seq.startswith("{") and arp_seq.endswith("}"):
        return "%".join(arpchar_to_ipa(a) for a in arp_seq[1:-1].split(" "))
    if arp_seq in PUNCTUATION_LIST:
        return arp_seq
    return None
