"""Chained pipeline driver (port of `arttts_tpu/cli/pipeline.py`, the local
equivalent of the reference's SLURM dependency DAGs,
`src/scripts/ms_chained_inf.sh`):

    python -m arttts_tpu_torch.cli.pipeline --preset v2 --ckpt logs/v2/grad_best \
        --filelist lists/test.txt --data-root /data --workdir out/v2 \
        --vocoder-ckpt hifigan.pt [--utmos-ckpt utmos.ckpt] [--ref-mel-dir mels]

Four stages with the standalone CLIs' file contracts, so any stage can be
run again on its own: 1. `cli.synthesize` -> `workdir/preds/*.npy` (K1-K3 on
every 2D preset); 2. `quanti_mel` (with `--ref-mel-dir`) or `quanti_art`
(with `--ref-art-dir`) -> `workdir/quanti_{mel,art}.csv`; 3. `cli.vocode`
-> `workdir/wavs/*.wav` (K4, K5); 4. `cli.score` -> `workdir/utmos.csv`. A
stage that fails raises, so no stage after it runs (the reference's
`--kill-on-invalid-dep=yes`). Every stage runs on `--device` (the card by
default).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", default="v2")
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--filelist", required=True)
    parser.add_argument("--data-root", default=".")
    parser.add_argument("--cmudict")
    parser.add_argument("--artic-dir")
    parser.add_argument("--mel-cache")
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--n-timesteps", type=int, default=50)
    parser.add_argument("--vocoder-ckpt")
    parser.add_argument("--spk-ft")
    parser.add_argument("--pitch-stats", nargs=2, type=float, default=[0.0, 1.0])
    parser.add_argument("--utmos-ckpt")
    parser.add_argument("--ref-mel-dir", help="ground-truth mels for quanti_mel")
    parser.add_argument("--ref-art-dir", help="SPARC re-encodings for quanti_art")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    from arttts_tpu_torch.core.runtime import setup_runtime

    setup_runtime(args.device)
    log = logging.getLogger("pipeline")

    workdir = Path(args.workdir)
    pred_dir = workdir / "preds"
    wav_dir = workdir / "wavs"

    from arttts_tpu_torch.cli import synthesize as synth_cli
    from arttts_tpu_torch.core.config import get_preset

    is_mel = get_preset(args.preset).model.n_feats == 80
    dev = ["--device", args.device]

    log.info("[1/4] acoustic inference -> %s", pred_dir)
    synth_args = [
        "--preset", args.preset, "--ckpt", args.ckpt, "--filelist", args.filelist,
        "--data-root", args.data_root, "--save-dir", str(pred_dir),
        "--n-timesteps", str(args.n_timesteps), *dev,
    ]
    if args.cmudict:
        synth_args += ["--cmudict", args.cmudict]
    if args.artic_dir:
        synth_args += ["--artic-dir", args.artic_dir]
    synth_cli.main(synth_args)

    from arttts_tpu_torch.eval.quanti import quanti_art, quanti_mel

    if is_mel and args.ref_mel_dir:
        log.info("[2/4] quanti_mel")
        quanti_mel(str(pred_dir), args.ref_mel_dir, str(workdir / "quanti_mel.csv"))
    elif (not is_mel) and args.ref_art_dir:
        log.info("[2/4] quanti_art")
        quanti_art(str(pred_dir), args.ref_art_dir, str(workdir / "quanti_art.csv"))
    else:
        log.info("[2/4] quanti skipped (no reference dir)")

    if args.vocoder_ckpt:
        log.info("[3/4] vocoding -> %s", wav_dir)
        from arttts_tpu_torch.cli import vocode as vocode_cli

        voc_args = [
            "--mode", "mel" if is_mel else "sparc",
            "--torch-ckpt", args.vocoder_ckpt,
            "--pred-dir", str(pred_dir), "--save-dir", str(wav_dir), *dev,
        ]
        if not is_mel:
            voc_args += ["--spk-ft", args.spk_ft, "--pitch-stats",
                         str(args.pitch_stats[0]), str(args.pitch_stats[1])]
        vocode_cli.main(voc_args)
    else:
        log.info("[3/4] vocoding skipped (no vocoder ckpt)")

    if args.utmos_ckpt and args.vocoder_ckpt:
        log.info("[4/4] UTMOS scoring")
        from arttts_tpu_torch.cli import score as score_cli

        score_cli.main([
            "--ckpt", args.utmos_ckpt, "--wav-dir", str(wav_dir),
            "--out-csv", str(workdir / "utmos.csv"), *dev,
        ])
    else:
        log.info("[4/4] UTMOS skipped")
    log.info("pipeline complete: %s", workdir)


if __name__ == "__main__":
    main()
