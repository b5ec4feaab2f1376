"""Multi-speaker/multilingual datasets (v6 family; a copy of
`arttts_tpu/data/ms_datasets.py`).

Equivalent of the reference's `src/data_ms.py:34-425`: VoxCommunis manifests
+ forced alignments -> 26-dim phonological features (24 traits + silence +
repetition counts), SPARC articulatory targets from
`encoded_audio_multi/{lang}/emasrc`, and 1024-d SSL speaker pre-embeddings
from `spk_preemb/`. Durations for the aligned-input GradTTArtic model are
the 26th input channel.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from arttts_tpu_torch.data.features import (
    load_art_features,
)
from arttts_tpu_torch.voxcommunis.data import (
    FeatureTokenizer,
    PanPhonInventory,
    phonological_feature_rows,
)
from arttts_tpu_torch.voxcommunis.io import read_alignment, read_manifest


class MsPhnmArticDataset:
    """Items: {"x": (T_x, 26), "y": (T_y, 16), "spk": (1024,)}."""

    def __init__(
        self,
        dataset_dir,
        manifest_path,
        alignment_path,
        feature_tokenizer: FeatureTokenizer,
        separate_files: bool = False,
        log_normalize_loudness: bool = False,
        custom_dataset: Optional[str] = None,
        exclude_langs: Optional[List[str]] = None,
        corrections=None,
    ):
        self.feature_tokenizer = feature_tokenizer
        self.dataset_dir = Path(dataset_dir)
        self.log_normalize_loudness = log_normalize_loudness
        self.custom_dataset = custom_dataset

        inv = PanPhonInventory(corrections)
        if separate_files:
            manifests = sorted(Path(manifest_path).glob("*.tsv"))
            if exclude_langs:
                manifests = [fp for fp in manifests if fp.stem not in exclude_langs]
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
            self.ipa_phones = {f: inv.convert_to_ipa(a) for f, a in aligns.items()}
            self.langs, self.lang_sizes = None, None

    def _encoded_dir(self, file_id: str) -> Path:
        if self.custom_dataset is None:
            lang = file_id.split("_")[2]  # voxcommunis id convention
            return self.dataset_dir / "encoded_audio_multi" / lang
        return self.dataset_dir / "encoded_audio_multi" / self.custom_dataset

    def get_phon_feats(self, file_id: str) -> np.ndarray:
        return phonological_feature_rows(
            self.ipa_phones[file_id], self.feature_tokenizer
        )

    def get_art(self, file_id: str) -> np.ndarray:
        return load_art_features(
            self._encoded_dir(file_id) / "emasrc" / f"{file_id}.npy",
            log_normalize_loudness=self.log_normalize_loudness,
        )

    def get_spk_features(self, file_id: str) -> np.ndarray:
        return np.load(
            self._encoded_dir(file_id) / "spk_preemb" / f"{file_id}.npy"
        ).astype(np.float32)

    def __len__(self) -> int:
        return len(self.manifest)

    def lengths(self) -> np.ndarray:
        return np.array([n for _, (_, n) in self.manifest])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        file_id, _ = self.manifest[index]
        x = self.get_phon_feats(file_id)
        return {
            "x": x,
            "y": self.get_art(file_id),
            "spk": self.get_spk_features(file_id),
            "durations": x[:, -1].astype(np.float32),
        }

    def sample_test_batch(self, size: int, seed: int = 37):
        idx = np.random.default_rng(seed).choice(len(self), size=size, replace=False)
        return [self[int(i)] for i in idx]


class MsPhnmDataset(MsPhnmArticDataset):
    """Inference-time variant without articulatory targets (data_ms.py's
    PhnmDataset): items {"x", "spk"}."""

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        file_id, _ = self.manifest[index]
        x = self.get_phon_feats(file_id)
        return {
            "x": x,
            "spk": self.get_spk_features(file_id),
            "durations": x[:, -1].astype(np.float32),
        }
