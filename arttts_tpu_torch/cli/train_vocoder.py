"""HiFi-GAN vocoder training and fine-tuning CLI (port of
`arttts_tpu/cli/train_vocoder.py`, the reference's `hifi-gan/train.py`).
Trains the generator and the MPD/MSD discriminators on real audio with
random segment crops (`data/vocoder_dataset.py`) through the GAN step of
`train/vocoder_trainer.py`:

    python -m arttts_tpu_torch.cli.train_vocoder --wav-dir wavs/ \\
        --out-dir ckpt/hifigan --steps 1000 --batch-size 16

    # fine-tune on acoustic-model output mels (the reference's --fine_tuning)
    python -m arttts_tpu_torch.cli.train_vocoder --wav-dir wavs/ \\
        --base-mels-dir preds/v2 --init-ckpt ckpt/hifigan/voc_1000 ...

Runs on the card (`--device cuda`, the default) unless `--device cpu` is
asked for; with no card a "cuda" run raises. Writes `voc_{step}`
checkpoints (weights only); `--init-ckpt` restores weights only, and the
step count starts again at 1.
"""

from __future__ import annotations

import argparse
import logging
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--wav-dir", required=True, help="directory of .wav files")
    parser.add_argument("--filelist", help="optional newline list of wav paths "
                        "(relative to --wav-dir); default: every *.wav")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--segment-size", type=int, default=8192)
    parser.add_argument("--sample-rate", type=int, default=22050)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--save-every", type=int, default=500)
    parser.add_argument("--base-mels-dir", help="fine-tuning: acoustic-output "
                        "mel .npy dir (the reference's hifi-gan/train.py --fine_tuning)")
    parser.add_argument("--init-ckpt", help="fine-tune from a voc_{step} checkpoint "
                        "written by this CLI (weights only)")
    parser.add_argument("--log-every", type=int, default=50)
    # generator architecture (the reference's hifi-gan config_v1/v2/v3.json knobs)
    parser.add_argument("--upsample-rates", type=int, nargs="+", default=[8, 8, 2, 2])
    parser.add_argument("--upsample-kernels", type=int, nargs="+", default=[16, 16, 4, 4])
    parser.add_argument("--initial-channel", type=int, default=512)
    parser.add_argument("--resblock-kernels", type=int, nargs="+", default=[3, 7, 11])
    parser.add_argument("--resblock-dilations", type=str, nargs="+",
                        default=["1,3,5", "1,3,5", "1,3,5"],
                        help="comma-separated dilations per resblock kernel")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    log = logging.getLogger("train_vocoder")

    import numpy as np
    import torch

    from arttts_tpu_torch.audio.mel import MelConfig
    from arttts_tpu_torch.core.checkpoint import load_vocoder_checkpoint, save_vocoder_checkpoint
    from arttts_tpu_torch.core.runtime import setup_runtime
    from arttts_tpu_torch.data.vocoder_dataset import VocoderDataConfig, VocoderSegmentDataset
    from arttts_tpu_torch.models.hifigan import HiFiGANGenerator
    from arttts_tpu_torch.train.vocoder_trainer import VocoderGAN

    device = setup_runtime(args.device)
    if args.filelist:
        with open(args.filelist) as f:
            paths = [os.path.join(args.wav_dir, line.strip()) for line in f if line.strip()]
    else:
        paths = sorted(os.path.join(args.wav_dir, p)
                       for p in os.listdir(args.wav_dir) if p.endswith(".wav"))
    if not paths:
        raise SystemExit(f"no wavs found under {args.wav_dir}")
    log.info("%d wav files", len(paths))

    mel_cfg = MelConfig(sample_rate=args.sample_rate)
    data_cfg = VocoderDataConfig(segment_size=args.segment_size, sample_rate=args.sample_rate,
                                 fine_tuning=args.base_mels_dir is not None,
                                 base_mels_dir=args.base_mels_dir)
    dataset = VocoderSegmentDataset(paths, data_cfg, mel_cfg, device=device)
    gen = HiFiGANGenerator(
        upsample_rates=tuple(args.upsample_rates),
        upsample_kernel_sizes=tuple(args.upsample_kernels),
        upsample_initial_channel=args.initial_channel,
        resblock_kernel_sizes=tuple(args.resblock_kernels),
        resblock_dilation_sizes=tuple(tuple(int(d) for d in ds.split(","))
                                      for ds in args.resblock_dilations),
    )
    hop = int(np.prod(args.upsample_rates))
    if args.segment_size % hop or hop != mel_cfg.hop_length:
        log.warning("generator hop %d vs mel hop %d: segment/frame alignment assumes "
                    "prod(upsample_rates) == hop_length", hop, mel_cfg.hop_length)
    gan = VocoderGAN(generator=gen, mel_config=mel_cfg, device=device,
                     rng=torch.Generator().manual_seed(args.seed), lr=args.lr)
    if args.init_ckpt:
        ck = load_vocoder_checkpoint(args.init_ckpt)
        gan.load_weights(ck)
        log.info("initialized from %s (step %d)", args.init_ckpt, ck["step"])

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    for step in range(1, args.steps + 1):
        metrics = gan.train_step(dataset.sample_batch(args.batch_size, rng))
        if step % args.log_every == 0 or step == 1:
            m = {k: float(v) for k, v in metrics.items()}
            log.info("step %d gen %.3f disc %.3f mel_l1 %.3f (%.2f s/step)", step,
                     m["gen_loss"], m["disc_loss"], m["mel_l1"], (time.time() - t0) / step)
        if step % args.save_every == 0 or step == args.steps:
            log.info("saved %s", save_vocoder_checkpoint(args.out_dir, step, gan.weights()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
