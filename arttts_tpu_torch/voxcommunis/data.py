"""VoxCommunis phonological-feature tokenization (a copy of
`arttts_tpu/voxcommunis/data.py`, ref `src/voxcommunis/data.py:226-368`).

A `FeatureTokenizer` turns IPA phone strings into 24-dim feature rows
(multi-segment phones spread over their repetition counts), a
`PanPhonInventory` applies a correction map and downsamples 100 Hz
alignment frames to the 50 Hz model rate, and `phonological_feature_rows`
gives the (24 traits + silence + repetition-count) = 26-dim rows the
articulatory model reads, `PhoneticFeatureDataset` yields those rows for a
VoxCommunis manifest and alignment (one merged pair, or one a language),
and `LANGUAGES` maps CommonVoice codes to names.
"""

from __future__ import annotations

import pickle
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from arttts_tpu_torch.voxcommunis.decoder import FeatureDecoder
from arttts_tpu_torch.voxcommunis.io import read_alignment, read_manifest
from arttts_tpu_torch.voxcommunis.utils import unique_consecutive

SAMPLE_RATE = 16_000
ALIGNMENT_FREQ = 100  # Hz
MODEL_FREQ = 50  # Hz
SUBSAMPLE = ALIGNMENT_FREQ // MODEL_FREQ

# CommonVoice language code -> English name: the full 205-code map the
# reference ships (src/voxcommunis/data.py:17-223) — a factual constant.
LANGUAGES: Dict[str, str] = {
    "ab": "Abkhaz", "ace": "Acehnese", "ady": "Adyghe", "af": "Afrikaans",
    "am": "Amharic", "an": "Aragonese", "ar": "Arabic", "arn": "Mapudungun",
    "as": "Assamese", "ast": "Asturian", "az": "Azerbaijani", "ba": "Bashkir",
    "bas": "Basaa", "be": "Belarusian", "bg": "Bulgarian", "bm": "Bambara",
    "bn": "Bengali", "bo": "Tibetan", "br": "Breton", "bs": "Bosnian",
    "bxr": "Buryat", "byv": "Medumba", "ca": "Catalan", "cak": "Kaqchikel",
    "ckb": "Central Kurdish", "cnh": "Hakha Chin", "co": "Corsican",
    "crh": "Crimean Tatar", "cs": "Czech", "cv": "Chuvash", "cy": "Welsh",
    "da": "Danish", "dag": "Dagbani", "de": "German", "dsb": "Sorbian, Lower",
    "dv": "Dhivehi", "dyu": "Dioula", "el": "Greek", "en": "English",
    "eo": "Esperanto", "es": "Spanish", "et": "Estonian", "eu": "Basque",
    "ewo": "Ewondo", "fa": "Persian", "ff": "Fulah", "fi": "Finnish",
    "fo": "Faroese", "fr": "French", "fuf": "Pular Guinea",
    "fy-NL": "Frisian", "ga-IE": "Irish", "gl": "Galician", "gn": "Guarani",
    "gom": "Goan Konkani", "gu-IN": "Gujarati", "guc": "Wayuunaiki",
    "ha": "Hausa", "he": "Hebrew", "hi": "Hindi", "hil": "Hiligaynon",
    "hr": "Croatian", "hsb": "Sorbian, Upper", "ht": "Haitian",
    "hu": "Hungarian", "hy-AM": "Armenian", "hyw": "Armenian Western",
    "ia": "Interlingua", "id": "Indonesian", "ie": "Interlingue",
    "ig": "Igbo", "is": "Icelandic", "it": "Italian", "izh": "Izhorian",
    "ja": "Japanese", "jbo": "Lojban", "jv": "Javanese", "ka": "Georgian",
    "kaa": "Karakalpak", "kab": "Kabyle", "kbd": "Kabardian", "ki": "Kikuyu",
    "kk": "Kazakh", "km": "Khmer", "kmr": "Kurmanji Kurdish", "kn": "Kannada",
    "knn": "Konkani (Devanagari)", "ko": "Korean", "kpv": "Komi-Zyrian",
    "kw": "Cornish", "ky": "Kyrgyz", "lb": "Luxembourgish", "lg": "Luganda",
    "lij": "Ligurian", "ln": "Lingala", "lo": "Lao", "lt": "Lithuanian",
    "ltg": "Latgalian", "lv": "Latvian", "lzz": "Laz", "mai": "Maithili",
    "mdf": "Moksha", "mg": "Malagasy", "mhr": "Meadow Mari",
    "mk": "Macedonian", "ml": "Malayalam", "mn": "Mongolian",
    "mni": "Meetei Lon", "mos": "Mossi", "mr": "Marathi", "mrj": "Hill Mari",
    "ms": "Malay", "mt": "Maltese", "my": "Burmese", "myv": "Erzya",
    "nan-tw": "Taiwanese (Minnan)", "nb-NO": "Norwegian Bokmål",
    "nd": "IsiNdebele (North)", "ne-NP": "Nepali",
    "nhe": "Eastern Huasteca Nahuatl",
    "nhi": "Western Sierra Puebla Nahuatl", "nia": "Nias", "nl": "Dutch",
    "nn-NO": "Norwegian Nynorsk", "nr": "IsiNdebele (South)",
    "nso": "Northern Sotho", "ny": "Chinyanja", "nyn": "Runyankole",
    "oc": "Occitan", "om": "Afaan Oromo", "or": "Odia", "os": "Ossetian",
    "pa-IN": "Punjabi", "pap-AW": "Papiamento (Aruba)", "pl": "Polish",
    "ps": "Pashto", "pt": "Portuguese", "quc": "K'iche'",
    "quy": "Quechua Chanka", "qvi": "Kichwa",
    "rm-sursilv": "Romansh Sursilvan", "rm-vallader": "Romansh Vallader",
    "ro": "Romanian", "ru": "Russian", "rw": "Kinyarwanda", "sah": "Sakha",
    "sat": "Santali (Ol Chiki)", "sc": "Sardinian", "scn": "Sicilian",
    "sco": "Scots", "sd": "Sindhi", "sdh": "Southern Kurdish",
    "shi": "Shilha", "si": "Sinhala", "sk": "Slovak", "skr": "Saraiki",
    "sl": "Slovenian", "snk": "Soninke", "so": "Somali", "sq": "Albanian",
    "sr": "Serbian", "ss": "Siswati", "st": "Southern Sotho",
    "sv-SE": "Swedish", "sw": "Swahili", "syr": "Syriac", "ta": "Tamil",
    "te": "Telugu", "tg": "Tajik", "th": "Thai", "ti": "Tigrinya",
    "tig": "Tigre", "tk": "Turkmen", "tl": "Tagalog", "tn": "Setswana",
    "tok": "Toki Pona", "tr": "Turkish", "ts": "Xitsonga", "tt": "Tatar",
    "tw": "Twi", "ty": "Tahitian", "tyv": "Tuvan", "uby": "Ubykh",
    "udm": "Udmurt", "ug": "Uyghur", "uk": "Ukrainian", "ur": "Urdu",
    "uz": "Uzbek", "ve": "Tshivenda", "vec": "Venetian", "vi": "Vietnamese",
    "vmw": "Emakhuwa", "vot": "Votic", "wep": "Westphalian", "wo": "Wolof",
    "xh": "Xhosa", "yi": "Yiddish", "yo": "Yoruba", "yue": "Cantonese",
    "zgh": "Tamazight", "zh-CN": "Chinese (China)",
    "zh-HK": "Chinese (Hong Kong)", "zh-TW": "Chinese (Taiwan)", "zu": "Zulu",
    "zza": "Zaza",
}


class FeatureTokenizer:
    """IPA phone -> representative form + (n_components, 24) feature rows
    (data.py:226-353); `encode` spreads multi-segment phones over their
    repetition counts with rounded boundaries."""

    def __init__(self, feature_decoder: FeatureDecoder):
        self._feat_decoder = feature_decoder

    @property
    def num_features(self) -> int:
        return len(self._feat_decoder.header)

    @property
    def multilingual_mode(self) -> bool:
        return self._feat_decoder.multilingual_mode

    @lru_cache(maxsize=None)
    def ipa_to_features(self, ipa_phone: str) -> Tuple[Tuple[str, ...], np.ndarray]:
        rep = self._feat_decoder.segment_to_representative(ipa_phone)
        rep, vector = self._feat_decoder.canonical_representation(rep)
        return rep, vector.astype(np.float32)

    def encode(
        self, ipa_phones: Sequence[str], counts: Sequence[int]
    ) -> Tuple[np.ndarray, List[str]]:
        """Expand phones into per-frame feature rows. A phone held for
        ``counts[i]`` frames repeats its vector; a k-component phone splits
        its frames into k near-equal runs (half-to-even rounded boundaries,
        matching ref data.py:304-338 semantics)."""
        if len(counts) != len(ipa_phones):
            raise ValueError(
                f"Length mismatch between IPA phones ({len(ipa_phones)}) and "
                f"counts ({len(counts)})"
            )
        chunks: List[np.ndarray] = []
        frame_phones: List[str] = []
        for phone, frames in zip(ipa_phones, counts):
            names, vectors = self.ipa_to_features(phone)
            k = len(names)
            edges = np.rint(np.arange(k + 1) * frames / k).astype(np.int64)
            runs = np.diff(edges)
            chunks.append(np.repeat(vectors, runs, axis=0))
            frame_phones.extend(np.repeat(np.asarray(names, dtype=object), runs))
        return np.concatenate(chunks, axis=0), frame_phones

    def decode(self, tokens: np.ndarray) -> List[str]:
        """Feature rows -> segments via the decoder's inverse lookup."""
        return [
            self._feat_decoder.find_segment(tuple(int(v) for v in row))
            for row in np.asarray(tokens)
        ]


class PanPhonInventory:
    """Correction-map application + 100->50 Hz downsampling (data.py:356-368).

    The reference loads `correction_map.pickle`; pass a dict or pickle path,
    default empty."""

    def __init__(self, corrections: Optional[object] = None):
        if corrections is None:
            self._corrections: Dict[str, str] = {}
        elif isinstance(corrections, (str, Path)):
            with open(corrections, "rb") as fp:
                self._corrections = pickle.load(fp)
        else:
            self._corrections = dict(corrections)

    def convert_to_ipa(self, panphon_phones) -> str:
        if isinstance(panphon_phones, str):
            panphon_phones = panphon_phones.split(" ")
        panphon_phones = panphon_phones[::SUBSAMPLE]
        return " ".join(self._corrections.get(p, p) for p in panphon_phones)


def phonological_feature_rows(
    phones_str: str, tokenizer: FeatureTokenizer
) -> np.ndarray:
    """Aligned phone string -> (seq_len, 26) rows: 24 traits + silence trait
    (+1 sil / -1 speech) + frame repetition count (data_ms.py:110-124)."""
    phones = phones_str.split(" ")
    phones, counts = unique_consecutive(phones, return_counts=True)
    ones = [1] * len(phones)
    feats, _ = tokenizer.encode(phones, ones)
    sil = (np.all(feats == 0, axis=1) * 2 - 1).astype(np.float32)[:, None]
    cnt = np.asarray(counts, np.float32)[:, None]
    return np.concatenate([feats, sil, cnt], axis=1)


class PhoneticFeatureDataset:
    """Standalone phonological-feature dataset (data.py:371-435)."""

    def __init__(
        self,
        manifest_path,
        alignment_path,
        feature_tokenizer: FeatureTokenizer,
        separate_files: bool = False,
        corrections=None,
    ):
        self.feature_tokenizer = feature_tokenizer
        inv = PanPhonInventory(corrections)
        if separate_files:
            manifests = sorted(Path(manifest_path).glob("*.tsv"))
            self.langs = [fp.stem for fp in manifests]
            self.lang_sizes: List[int] = []
            self.manifest: List = []
            self.ipa_phones: Dict[str, str] = {}
            for man_path in manifests:
                man = read_manifest(man_path)
                self.manifest += list(man.items())
                self.lang_sizes.append(len(man))
            for lang in self.langs:
                aligns = read_alignment(Path(alignment_path) / f"{lang}.align")
                self.ipa_phones.update(
                    {f: inv.convert_to_ipa(a) for f, a in aligns.items()}
                )
        else:
            man = read_manifest(manifest_path)
            self.manifest = list(man.items())
            aligns = read_alignment(alignment_path)
            assert feature_tokenizer.multilingual_mode
            self.ipa_phones = {f: inv.convert_to_ipa(a) for f, a in aligns.items()}

    def __len__(self) -> int:
        return len(self.manifest)

    def __getitem__(self, idx: int):
        file_id, (path, num_samples) = self.manifest[idx]
        feats = phonological_feature_rows(
            self.ipa_phones[file_id], self.feature_tokenizer
        )
        return feats, file_id
