"""VoxCommunis phone features for the multi-speaker articulatory model (the
port's copy of `arttts_tpu/voxcommunis/`)."""

from arttts_tpu_torch.voxcommunis.decoder import FeatureDecoder
from arttts_tpu_torch.voxcommunis.data import (
    FeatureTokenizer,
    PanPhonInventory,
    PhoneticFeatureDataset,
    LANGUAGES,
)
from arttts_tpu_torch.voxcommunis.io import read_alignment, read_manifest, write_manifest

__all__ = [
    "FeatureDecoder",
    "FeatureTokenizer",
    "PanPhonInventory",
    "PhoneticFeatureDataset",
    "LANGUAGES",
    "read_alignment",
    "read_manifest",
    "write_manifest",
]
