"""Dataset classes for the single-speaker experiment versions (port of
`arttts_tpu/data/datasets.py`, and of `build_dataset`, which the JAX package
keeps in `arttts_tpu/cli/train.py:19-75`).

Equivalents of the reference's dataset modules (`src/data.py`,
`data_phnm.py`, `data_textmel.py`, `data_textart.py`, `data_phnmmel.py`),
producing numpy items `{"x", "y"[, "durations"]}` in feature-last layout:

- TextArticDataset  (v0): text -> 25-dim ternary traits; SPARC art 16ch.
- PhnmArticDataset  (v1/v1_1/v5): phnm3 forced alignments -> traits; art.
- TextMelDataset    (v2): symbol ids (CMUdict + blanks); 80-mel from wav.
- PhnmMelDataset    (v3): phnm3 traits; mel; optional frame durations.
- TextArtDataset    (v4): symbol ids; art.

Mel extraction runs through `audio/mel.py` on `device` (default "cuda", no
fallback), with an optional on-disk cache.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from arttts_tpu_torch.audio.io import load_wav
from arttts_tpu_torch.audio.mel import MelConfig, MelSpectrogram
from arttts_tpu_torch.core.paths import CMUDICT_PATH
from arttts_tpu_torch.data.features import load_art_features
from arttts_tpu_torch.data.filelist import parse_filelist
from arttts_tpu_torch.text.cmudict import CMUDict
from arttts_tpu_torch.text.converters import (
    DIPHTHONGS_IPA,
    ipa_to_ternary,
    text_to_arpabet,
    text_to_ipa,
)
from arttts_tpu_torch.text.sequence import intersperse, text_to_sequence
from arttts_tpu_torch.text.symbols import symbols


def _resolve(fp: str, data_root_dir: str) -> str:
    """The reference filelists use a DUMMY/ prefix placeholder."""
    return fp.replace("DUMMY/", str(data_root_dir) + "/")


def _text_to_symbol_ids(text: str, cmudict: CMUDict, gradtts_text_conv: bool):
    """GradTTS direct symbol conversion, or the "phnmtext" ARPAbet-first path
    (ref data_textmel.py:95-107: text -> ARPAbet word list -> sequence with
    english_cleaners_v2)."""
    if gradtts_text_conv:
        return text_to_sequence(text, dictionary=cmudict)
    arp_words = text_to_arpabet(text, dictionary=cmudict)
    return text_to_sequence(
        " ".join(arp_words),
        cleaner_names=("english_cleaners_v2",),
        dictionary=cmudict,
    )


class _Base:
    def __len__(self) -> int:
        return len(self.entries)

    def lengths(self) -> np.ndarray:
        """Approximate output lengths for length-grouped batching; subclasses
        override when cheap exact lengths exist."""
        return np.array([len(e[-1]) for e in self.entries])

    def sample_test_batch(self, size: int, seed: int = 37) -> List[Dict]:
        idx = np.random.default_rng(seed).choice(len(self), size=size, replace=False)
        return [self[int(i)] for i in idx]


class TextArticDataset(_Base):
    """v0: text -> ternary traits + SPARC articulatory features (data.py:35)."""

    def __init__(
        self,
        filelist_path: str,
        cmudict_path: str,
        artic_dir: str,
        add_blank: bool = True,
        merge_diphtongues: bool = True,
        log_normalize_loudness: bool = False,
        shuffle: bool = True,
        seed: int = 37,
    ):
        self.entries = parse_filelist(filelist_path)
        if shuffle:
            np.random.default_rng(seed).shuffle(self.entries)
        self.cmudict = CMUDict(cmudict_path)
        self.artic_dir = Path(artic_dir)
        self.add_blank = add_blank
        self.merge_diphtongues = merge_diphtongues
        self.log_normalize_loudness = log_normalize_loudness

    def get_text(self, text: str) -> np.ndarray:
        ipa = text_to_ipa(text, dictionary=self.cmudict)
        if ipa is None:
            raise ValueError(f"unconvertible text: {text!r}")
        if self.add_blank:
            ipa = intersperse(ipa, " ")
        return ipa_to_ternary(ipa, merge_diphtongues=self.merge_diphtongues)

    def get_art(self, filepath: str) -> np.ndarray:
        stem = Path(filepath).stem
        return load_art_features(
            self.artic_dir / "emasrc" / f"{stem}.npy",
            log_normalize_loudness=self.log_normalize_loudness,
        )

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        filepath, text = self.entries[index][0], self.entries[index][1]
        return {"x": self.get_text(text), "y": self.get_art(filepath)}


class PhnmArticDataset(_Base):
    """v1/v1_1/v5: forced-aligned phnm3 -> traits + art (data_phnm.py:35).

    Filelist rows: [wav_fp, phnm3_fp]; art npys live next to the phnm3 dir
    under encoded_audio_en/emasrc (data_phnm.py:139-151)."""

    def __init__(
        self,
        filelist_path: str,
        data_root_dir: str,
        merge_diphtongues: bool = False,
        log_normalize_loudness: bool = False,
        shuffle: bool = True,
        seed: int = 37,
        artic_subdir: str = "encoded_audio_en",
    ):
        self.entries = parse_filelist(filelist_path)
        if shuffle:
            np.random.default_rng(seed).shuffle(self.entries)
        self.data_root_dir = data_root_dir
        self.merge_diphtongues = merge_diphtongues
        self.log_normalize_loudness = log_normalize_loudness
        self.artic_subdir = artic_subdir

    def get_phnm_emb(self, phnm3_fp: str) -> np.ndarray:
        phnm3 = np.load(_resolve(phnm3_fp, self.data_root_dir))
        word = "%".join(str(e[2]) for e in phnm3)
        return ipa_to_ternary([word], merge_diphtongues=self.merge_diphtongues)

    def get_durations(self, phnm3_fp: str) -> np.ndarray:
        """phnm3 (start, end, phone) seconds -> frame counts at 50 Hz with
        diphthong halving (data_phnmmel.py:132-150)."""
        phnm3 = np.load(_resolve(phnm3_fp, self.data_root_dir))
        durations = []
        for start, end, phone in phnm3:
            start, end = float(start), float(end)
            if not self.merge_diphtongues and str(phone) in DIPHTHONGS_IPA:
                mid = (end + start) / 2
                durations += [mid - start, end - mid]
            else:
                durations.append(end - start)
        return np.asarray(durations, np.float32) * 50.0

    def get_art(self, phnm3_fp: str) -> np.ndarray:
        phnm3_fp = _resolve(phnm3_fp, self.data_root_dir)
        stem = Path(phnm3_fp).stem
        art_name = f"{stem[:-6]}.npy"  # strip "_phnm3"
        art_fp = Path(phnm3_fp).parent.parent / self.artic_subdir / "emasrc" / art_name
        return load_art_features(
            art_fp, log_normalize_loudness=self.log_normalize_loudness
        )

    def lengths(self) -> np.ndarray:
        """Exact 50 Hz frame counts from the phnm3 end times (the filelist's
        last field is a path of near-constant length, so the base heuristic
        would degenerate to arbitrary order)."""
        if getattr(self, "_lengths", None) is None:
            out = []
            for entry in self.entries:
                phnm3 = np.load(_resolve(entry[1], self.data_root_dir))
                out.append(int(round(float(phnm3[-1][1]) * 50.0)))
            self._lengths = np.asarray(out)
        return self._lengths

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        phnm3_fp = self.entries[index][1]
        return {"x": self.get_phnm_emb(phnm3_fp), "y": self.get_art(phnm3_fp)}


class _MelReader:
    """wav path -> (T, 80) log-mel through `MelSpectrogram` on `device`,
    cached as `{stem}.npy` under `cache_dir` when one is given."""

    def __init__(self, data_root_dir: str, mel_config: MelConfig,
                 cache_dir: Optional[str], device):
        self.data_root_dir = data_root_dir
        self.mel = MelSpectrogram(mel_config, device)
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def __call__(self, filepath: str) -> np.ndarray:
        wav_fp = _resolve(filepath, self.data_root_dir)
        if self.cache_dir:
            cached = self.cache_dir / (Path(wav_fp).stem + ".npy")
            if cached.exists():
                return np.load(cached)
        audio, _ = load_wav(wav_fp, target_sr=self.mel.config.sample_rate)
        mel = self.mel(audio[None, :])[0].cpu().numpy()  # (T, 80)
        if self.cache_dir:
            np.save(cached, mel)
        return mel


class TextMelDataset(_Base):
    """v2: symbol ids + 80-mel (data_textmel.py:34-131)."""

    def __init__(
        self,
        filelist_path: str,
        cmudict_path: str,
        data_root_dir: str,
        add_blank: bool = True,
        mel_config: MelConfig = MelConfig(),
        shuffle: bool = True,
        seed: int = 37,
        mel_cache_dir: Optional[str] = None,
        gradtts_text_conv: bool = True,
        device="cuda",
    ):
        self.entries = parse_filelist(filelist_path)
        if shuffle:
            np.random.default_rng(seed).shuffle(self.entries)
        self.cmudict = CMUDict(cmudict_path)
        self.add_blank = add_blank
        self.gradtts_text_conv = gradtts_text_conv
        self.get_mel = _MelReader(data_root_dir, mel_config, mel_cache_dir, device)

    def get_text(self, text: str) -> np.ndarray:
        seq = _text_to_symbol_ids(text, self.cmudict, self.gradtts_text_conv)
        if self.add_blank:
            seq = intersperse(seq, len(symbols))
        return np.asarray(seq, np.int32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        filepath, text = self.entries[index][0], self.entries[index][1]
        return {"x": self.get_text(text), "y": self.get_mel(filepath)}


class PhnmMelDataset(PhnmArticDataset):
    """v3: phnm3 traits + mel target (data_phnmmel.py:35-208)."""

    def __init__(
        self,
        filelist_path: str,
        data_root_dir: str,
        mel_config: MelConfig = MelConfig(),
        merge_diphtongues: bool = False,
        shuffle: bool = True,
        seed: int = 37,
        mel_cache_dir: Optional[str] = None,
        device="cuda",
    ):
        super().__init__(
            filelist_path,
            data_root_dir,
            merge_diphtongues=merge_diphtongues,
            shuffle=shuffle,
            seed=seed,
        )
        self.get_mel = _MelReader(data_root_dir, mel_config, mel_cache_dir, device)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        wav_fp, phnm3_fp = self.entries[index][0], self.entries[index][1]
        return {
            "x": self.get_phnm_emb(phnm3_fp),
            "y": self.get_mel(wav_fp),
            "durations": self.get_durations(phnm3_fp),
        }


class TextMelSpeakerDataset(TextMelDataset):
    """Multi-speaker text+mel (LibriTTS-style filelists `wav|text|spk_id`,
    ref data_textmel.py's TextMelSpeaker* collators)."""

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        row = self.entries[index]
        filepath, text, spk = row[0], row[1], int(row[2])
        return {
            "x": self.get_text(text),
            "y": self.get_mel(filepath),
            "spk": np.asarray(spk, np.int32),
        }


class TextArtDataset(_Base):
    """v4: GradTTS symbol ids + articulatory target (data_textart.py:38)."""

    def __init__(
        self,
        filelist_path: str,
        cmudict_path: str,
        artic_dir: str,
        add_blank: bool = True,
        log_normalize_loudness: bool = False,
        shuffle: bool = True,
        seed: int = 37,
        gradtts_text_conv: bool = True,
    ):
        self.entries = parse_filelist(filelist_path)
        if shuffle:
            np.random.default_rng(seed).shuffle(self.entries)
        self.cmudict = CMUDict(cmudict_path)
        self.artic_dir = Path(artic_dir)
        self.add_blank = add_blank
        self.gradtts_text_conv = gradtts_text_conv
        self.log_normalize_loudness = log_normalize_loudness

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        filepath, text = self.entries[index][0], self.entries[index][1]
        seq = _text_to_symbol_ids(text, self.cmudict, self.gradtts_text_conv)
        if self.add_blank:
            seq = intersperse(seq, len(symbols))
        art = load_art_features(
            self.artic_dir / "emasrc" / f"{Path(filepath).stem}.npy",
            log_normalize_loudness=self.log_normalize_loudness,
        )
        return {"x": np.asarray(seq, np.int32), "y": art}


def build_dataset(cfg, args, filelist, device="cuda"):
    """The dataset of preset `cfg` over `filelist` (port of the JAX package's
    `arttts_tpu/cli/train.py:build_dataset`). `args` carries the CLIs' data
    flags: `data_root`, `cmudict`, `artic_dir`, `mel_cache` and, for the
    multi-speaker kind, `manifest`, `alignment`, `separate_files`. Mel
    targets are extracted on `device`."""
    kind = cfg.data.dataset
    cmudict = args.cmudict or str(CMUDICT_PATH)
    if kind == "text_mel":
        return TextMelDataset(
            filelist,
            cmudict,
            data_root_dir=args.data_root,
            mel_cache_dir=args.mel_cache,
            gradtts_text_conv=cfg.data.gradtts_text_conv,
            device=device,
        )
    if kind == "text_artic":
        return TextArticDataset(filelist, cmudict, artic_dir=args.artic_dir or args.data_root)
    if kind == "phnm_artic":
        return PhnmArticDataset(filelist, data_root_dir=args.data_root)
    if kind == "phnm_mel":
        return PhnmMelDataset(
            filelist, data_root_dir=args.data_root, mel_cache_dir=args.mel_cache, device=device
        )
    if kind == "text_art":
        return TextArtDataset(
            filelist,
            cmudict,
            artic_dir=args.artic_dir or args.data_root,
            gradtts_text_conv=cfg.data.gradtts_text_conv,
        )
    if kind == "ms_phnm_artic":
        from arttts_tpu_torch.data.ms_datasets import MsPhnmArticDataset
        from arttts_tpu_torch.voxcommunis.data import FeatureTokenizer
        from arttts_tpu_torch.voxcommunis.decoder import FeatureDecoder

        tok = FeatureTokenizer(FeatureDecoder(sum_diphthong=True))
        separate = args.separate_files or cfg.data.separate_files
        # monolingual v6/v6_zhCN: the preset's lang picks the per-language
        # manifest/alignment file inside the given directories
        manifest, alignment = args.manifest, args.alignment
        if not separate and cfg.data.lang:
            if manifest and Path(manifest).is_dir():
                manifest = str(Path(manifest) / f"{cfg.data.lang}.tsv")
            if alignment and Path(alignment).is_dir():
                alignment = str(Path(alignment) / f"{cfg.data.lang}.align")
        return MsPhnmArticDataset(
            args.data_root,
            manifest,
            alignment,
            tok,
            separate_files=separate,
            exclude_langs=list(cfg.data.exclude_langs) or None,
        )
    raise ValueError(f"unknown dataset kind {kind}")
