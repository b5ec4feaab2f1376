"""Offline SPARC feature extraction driver, sharded (port of
`arttts_tpu/cli/encode_audio.py`, the reference's `encode_audio_voxcom.py`):
over a wav manifest, save `emasrc/{id}.npy` (14-channel features) and the
speaker vectors (`spk_emb/`, or the 1024-d `spk_preemb/`).

    python -m arttts_tpu_torch.cli.encode_audio --manifest train.tsv \
        --save-dir encoded --native [--wavlm-ckpt wavlm.pt --probe probe.npz]

Sharding: `--shard-id/--num-shards` split the manifest as the reference's
SLURM array jobs do, and default to `SLURM_ARRAY_TASK_ID` /
`SLURM_ARRAY_TASK_COUNT`. Backends:
  * `--native`: the port's encoder (`models/sparc_encoder.py`: WavLM tap +
    linear EMA probe + YIN pitch + log-RMS loudness) on `--device` (the
    card by default), weights from `--wavlm-ckpt` (a torch file with an HF
    WavLM state dict) and `--probe` (npz); either may be left out for
    random-weight smoke runs. Speaker vectors go to `spk_preemb/`.
  * default: the external `sparc` coder package; without it this CLI exits
    with a message (`--dry-run` lists what it would encode).
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--manifest", required=True,
                        help="voxcommunis tsv manifest or filelist of wavs")
    parser.add_argument("--save-dir", required=True)
    parser.add_argument("--sparc-ckpt", default="sparc_multi.ckpt")
    parser.add_argument("--shard-id", type=int,
                        default=int(os.environ.get("SLURM_ARRAY_TASK_ID", 0)))
    parser.add_argument("--num-shards", type=int,
                        default=int(os.environ.get("SLURM_ARRAY_TASK_COUNT", 1)))
    parser.add_argument("--spk-preemb", action="store_true",
                        help="save 1024-d pre-projection speaker embeddings")
    parser.add_argument("--native", action="store_true",
                        help="use the port's encoder instead of the external sparc package")
    parser.add_argument("--wavlm-ckpt", default=None,
                        help="torch file with an HF WavLM state dict (native backbone)")
    parser.add_argument("--probe", default=None,
                        help="npz with the (1024, 12) EMA probe (native backend)")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("encode_audio")

    if args.manifest.endswith(".tsv"):
        from arttts_tpu_torch.voxcommunis.io import read_manifest

        entries = [(k, str(v[0])) for k, v in read_manifest(args.manifest).items()]
    else:
        from arttts_tpu_torch.data.filelist import parse_filelist

        entries = [(Path(row[0]).stem, row[0]) for row in parse_filelist(args.manifest)]
    shard = entries[args.shard_id:: args.num_shards]
    log.info("shard %d/%d: %d of %d files", args.shard_id, args.num_shards, len(shard),
             len(entries))

    save_dir = Path(args.save_dir)
    (save_dir / "emasrc").mkdir(parents=True, exist_ok=True)
    (save_dir / "spk_emb").mkdir(exist_ok=True)
    if args.spk_preemb or args.native:
        # the native encoder only makes the 1024-d pre-projection vector
        (save_dir / "spk_preemb").mkdir(exist_ok=True)

    if args.dry_run:
        for fid, path in shard:
            log.info("would encode %s -> %s", path, save_dir / "emasrc" / f"{fid}.npy")
        return

    if args.native:
        _encode_native(args, shard, save_dir, log)
        return

    try:
        from sparc import load_model  # external speech-articulatory-coding
    except ImportError as e:
        raise SystemExit(
            "the external `sparc` coder package is required for feature "
            "extraction (pip package speech-articulatory-coding); use "
            "--native for the port's encoder, or --dry-run to validate sharding"
        ) from e

    coder = load_model(ckpt=args.sparc_ckpt)
    if args.spk_preemb and hasattr(coder, "spk_ft_proj"):
        import torch

        coder.spk_ft_proj = torch.nn.Identity()  # keep the 1024-d pre-embeddings

    for fid, path in shard:
        out_fp = save_dir / "emasrc" / f"{fid}.npy"
        if out_fp.exists():
            continue
        try:
            outputs = coder.encode(path, concat=True)
            np.save(out_fp, outputs["features"])
            np.save(save_dir / ("spk_preemb" if args.spk_preemb else "spk_emb") / f"{fid}.npy",
                    outputs["spk_emb"])
        except Exception as e:  # log and continue, as the reference job does
            log.error("failed on %s: %s", path, e)


def _encode_native(args, shard, save_dir: Path, log) -> None:
    """The port's encoder over the shard, one bucketed forward a file."""
    import torch

    from arttts_tpu_torch.audio.io import load_wav
    from arttts_tpu_torch.core.runtime import setup_runtime
    from arttts_tpu_torch.eval.quanti import encode_padded
    from arttts_tpu_torch.models.sparc_encoder import (
        SparcEncoderConfig,
        build_encoder,
        load_probe_npz,
    )

    device = setup_runtime(args.device)
    cfg = SparcEncoderConfig()
    hf_sd = None
    if args.wavlm_ckpt:
        obj = torch.load(args.wavlm_ckpt, map_location="cpu", weights_only=False)
        hf_sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    probe = load_probe_npz(args.probe) if args.probe else None
    if hf_sd is None or probe is None:
        log.warning("native encoder running with %s weights: outputs are for pipeline "
                    "smoke only", "partially converted" if (hf_sd or probe) else "random")
    enc = build_encoder(hf_sd, cfg, probe=probe, device=device)

    for fid, path in shard:
        out_fp = save_dir / "emasrc" / f"{fid}.npy"
        if out_fp.exists():
            continue
        try:
            wav, _ = load_wav(path, target_sr=cfg.pitch.sample_rate)
            feats, spk = encode_padded(enc, wav, device)
            np.save(out_fp, feats)
            # the native speaker vector is the 1024-d PRE-projection embedding,
            # so it goes to spk_preemb/ whatever the flag says
            np.save(save_dir / "spk_preemb" / f"{fid}.npy", spk)
        except Exception as e:  # log and continue, as the reference job does
            log.error("failed on %s: %s", path, e)


if __name__ == "__main__":
    main()
