"""A synthetic VoxCommunis layout on disk for the port's parity tests
(`tests/test_torch_artic_data.py`, `tests/test_torch_frontend.py`,
`tests/test_torch_utils.py`). It imports only numpy, the standard library
and the port's manifest writer, so that a test file using it pays for no
JAX or SciPy import of its own.
"""

import wave

import numpy as np

from arttts_tpu_torch.voxcommunis.io import write_manifest


def _save_wav(path, audio, sr):
    """Float [-1, 1] audio as a 16-bit mono wav, the samples that
    `audio/io.py:save_wav` writes."""
    pcm = (np.clip(np.asarray(audio, np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def write_layout(root, rng, langs=("ab", "it"), n=3, art_frames=(30, 41, 25)):
    """Per language a manifest (`{lang}.tsv` under `manifests/`) over 16 kHz
    wavs, an alignment (`{lang}.align` under `alignments/`, 100 Hz phones),
    SPARC tracks under `encoded_audio_multi/{lang}/emasrc` and 1024-d
    speaker pre-embeddings under `spk_preemb`. One merged manifest and
    alignment at the root too."""
    (root / "manifests").mkdir()
    (root / "alignments").mkdir()
    merged_align = []
    for lang in langs:
        wavs = root / "wavs" / lang
        wavs.mkdir(parents=True)
        enc = root / "encoded_audio_multi" / lang
        (enc / "emasrc").mkdir(parents=True)
        (enc / "spk_preemb").mkdir(parents=True)
        lines = []
        for i in range(n):
            fid = f"cv_{lang}_{lang}_{i:04d}"
            _save_wav(wavs / f"{fid}.wav", rng.standard_normal(800 + 160 * i) * 0.1, 16000)
            art = rng.standard_normal((art_frames[i % len(art_frames)], 14)).astype(np.float32)
            art[:, 13] = np.abs(art[:, 13]) + 0.1  # loudness > 0
            np.save(enc / "emasrc" / f"{fid}.npy", art)
            np.save(enc / "spk_preemb" / f"{fid}.npy", rng.standard_normal(1024).astype(np.float32))
            phones = []
            for p in rng.choice(["a", "t", "t͡ʃ", "aɪ", "kʰ", "SIL", "ɛ", "˥"], size=6 + i):
                phones += [str(p)] * int(rng.integers(2, 9))
            lines.append(f"{fid}\t{' '.join(phones)}")
        write_manifest(wavs, root / "manifests" / f"{lang}.tsv")
        (root / "alignments" / f"{lang}.align").write_text("\n".join(lines) + "\n")
        merged_align += lines
    write_manifest(root / "wavs", root / "all.tsv")
    (root / "all.align").write_text("\n".join(merged_align) + "\n")
