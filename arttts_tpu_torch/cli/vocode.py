"""Vocoding CLI (port of `arttts_tpu/cli/vocode.py`, the reference's
`vocoder_inference.py` / `hifigan_inference_ms.py`):

    # mel -> wav with a HiFi-GAN hifigan.pt
    python -m arttts_tpu_torch.cli.vocode --mode mel --torch-ckpt hifigan.pt \
        --pred-dir preds/v2 --save-dir wavs/v2

    # articulatory -> wav with a SPARC sparc_*.ckpt
    python -m arttts_tpu_torch.cli.vocode --mode sparc --torch-ckpt sparc_en.ckpt \
        --pred-dir preds/v1 --save-dir wavs/v1 --spk-ft spk.npy \
        --pitch-stats 120.0 30.0

The port's generators carry the reference's state-dict names, so the
reference's checkpoints load as they are (weight-norm pairs folded). Runs on
the card (`--device cuda`, the default) unless `--device cpu` is asked for.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mode", choices=["mel", "sparc"], required=True)
    parser.add_argument("--torch-ckpt", required=True)
    parser.add_argument("--pred-dir", required=True)
    parser.add_argument("--save-dir", required=True)
    parser.add_argument("--spk-ft", help="speaker pre-embedding npy (sparc mode)")
    parser.add_argument("--pitch-stats", nargs=2, type=float, default=[0.0, 1.0],
                        metavar=("MU", "STD"))
    parser.add_argument("--loudness-stats", nargs=2, type=float, default=None)
    parser.add_argument("--sample-rate", type=int)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from pathlib import Path

    import torch

    from arttts_tpu_torch.core.runtime import setup_runtime
    from arttts_tpu_torch.infer.pipeline import run_mel_vocoder, run_sparc_vocoder
    from arttts_tpu_torch.models.hifigan import HiFiGANGenerator, SpkSparcHiFiGANGenerator
    from arttts_tpu_torch.utils.reference_weights import fold_weight_norm

    device = setup_runtime(args.device)
    artifacts = sorted(str(p) for p in Path(args.pred_dir).glob("*.npy"))
    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    if args.mode == "mel":
        with torch.device("meta"):  # the checkpoint's tensors become the parameters
            gen = HiFiGANGenerator()
        gen.load_state_dict(fold_weight_norm(ckpt.get("generator", ckpt)), assign=True)
        out = run_mel_vocoder(gen.to(device).eval(), artifacts, args.save_dir,
                              sample_rate=args.sample_rate or 22050, device=device)
    else:
        parts = ckpt["state_dict"]
        with torch.device("meta"):
            gen = SpkSparcHiFiGANGenerator()
        gen.load_state_dict({f"{part}.{k}": v for part in ("spk_ft", "generator")
                             for k, v in fold_weight_norm(parts[part]).items()}, assign=True)
        out = run_sparc_vocoder(
            gen.to(device).eval(), artifacts, np.load(args.spk_ft), args.save_dir,
            pitch_stats=tuple(args.pitch_stats),
            loudness_stats=tuple(args.loudness_stats) if args.loudness_stats else None,
            sample_rate=args.sample_rate or ckpt.get("config", {}).get("sr", 16000),
            device=device)
    logging.info("wrote %d wavs to %s", len(out), args.save_dir)
    return out


if __name__ == "__main__":
    main()
