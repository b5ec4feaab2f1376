"""EMA corpus layout configs (port of `arttts_tpu/corpora/configs.py`, ref
`src/config_ema/*.yaml`).

Per-corpus signal rates and directory layout templates ("speaker#" expands
to the speaker id, "id#" to the sentence id). Defaults replicate the
reference YAMLs; `load_corpus_config` reads the same YAML schema for custom
corpora (PyYAML, imported when it is called).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CorpusLayout:
    name: str
    audio_sr: int
    ema_sr: int
    src_audio_reldir: str = "speaker#/"
    src_ema_reldir: str = "speaker#/"
    src_phone_reldir: str = "speaker#/"
    sentences_relpath: Optional[str] = None
    filestem: str = "item_id#"

    def expand(self, template: str, speaker: str, sent_id: str = "") -> str:
        return template.replace("speaker#", speaker).replace("id#", sent_id)

    def audio_dir(self, root, speaker: str) -> Path:
        return Path(root) / self.expand(self.src_audio_reldir, speaker)

    def ema_dir(self, root, speaker: str) -> Path:
        return Path(root) / self.expand(self.src_ema_reldir, speaker)

    def phone_dir(self, root, speaker: str) -> Path:
        return Path(root) / self.expand(self.src_phone_reldir, speaker)


# defaults mirroring config_ema/*.yaml
CORPUS_LAYOUTS = {
    "mspka": CorpusLayout(
        name="mspka",
        audio_sr=22050,
        ema_sr=400,
        src_audio_reldir="speaker#_1.0.0/wav_1.0.0/",
        src_ema_reldir="speaker#_1.0.0/ema_1.0.0/",
        src_phone_reldir="speaker#_1.0.0/lab_1.0.0/",
        sentences_relpath="speaker#_1.0.0/list_sentences",
        filestem="speaker#_id#",
    ),
    "mocha": CorpusLayout(
        name="mocha", audio_sr=16000, ema_sr=500, filestem="speaker#_id#"
    ),
    "pb2007": CorpusLayout(name="pb2007", audio_sr=16000, ema_sr=100),
    "mngu0": CorpusLayout(name="mngu0", audio_sr=16000, ema_sr=200),
}


def load_corpus_config(yaml_path, name: Optional[str] = None) -> CorpusLayout:
    import yaml

    with open(yaml_path) as f:
        d = yaml.safe_load(f)
    return CorpusLayout(
        name=name or Path(yaml_path).stem,
        audio_sr=int(d["audio_sr"]),
        ema_sr=int(d["ema_sr"]),
        src_audio_reldir=d.get("src_audio_reldir", "speaker#/"),
        src_ema_reldir=d.get("src_ema_reldir", "speaker#/"),
        src_phone_reldir=d.get("src_phone_reldir", "speaker#/"),
        sentences_relpath=d.get("sentences_relpath"),
        filestem=d.get("filestem", "item_id#"),
    )
