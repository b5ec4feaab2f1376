"""Acoustic inference CLI (port of `arttts_tpu/cli/synthesize.py`, the
reference's `arttts_inference.py`):

    python -m arttts_tpu_torch.cli.synthesize --preset v2 --ckpt logs/v2/grad_best \
        --filelist lists/test.txt --data-root /data --save-dir preds/v2

Writes the (29|161, T) per-sample npy artifacts consumed by the vocoder and
quanti stages. Runs on the card (`--device cuda`, the default) unless
`--device cpu` is asked for; with no card a "cuda" run raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", default="v2")
    parser.add_argument("--ckpt", required=True,
                        help="a checkpoint directory of the port's trainer (core/checkpoint.py)")
    parser.add_argument("--filelist", required=True)
    parser.add_argument("--data-root", default=".")
    parser.add_argument("--cmudict")
    parser.add_argument("--artic-dir")
    parser.add_argument("--mel-cache")
    parser.add_argument("--save-dir", required=True)
    parser.add_argument("--n-timesteps", type=int, default=50)
    parser.add_argument("--solver", choices=["euler", "heun", "dpm"], default="euler",
                        help="heun: 2nd-order ODE solver (2 evals/step); dpm: "
                             "DPM-Solver++(2M), 1 eval/step")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--length-scale", type=float, default=1.0)
    parser.add_argument("--use-align", action="store_true",
                        help="use ground-truth phnm3 durations (x_durations)")
    parser.add_argument("--batch-size", type=int, default=1,
                        help=">1 uses batched serving mode (masked-norm model)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from arttts_tpu_torch.core.checkpoint import load_checkpoint
    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.core.runtime import setup_runtime
    from arttts_tpu_torch.data.datasets import build_dataset
    from arttts_tpu_torch.infer.pipeline import (
        run_acoustic_inference,
        run_acoustic_inference_batched,
    )
    from arttts_tpu_torch.models.tts import GradTTSModel

    device = setup_runtime(args.device)
    cfg = get_preset(args.preset)
    if args.batch_size > 1:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, decoder=dataclasses.replace(cfg.model.decoder, masked_norm=True)))
    dataset = build_dataset(cfg, args, args.filelist, device=device)
    with torch.device("meta"):  # the checkpoint's tensors become the parameters
        model = GradTTSModel(cfg.model)
    model.load_state_dict(load_checkpoint(args.ckpt, map_location=device)["model"],
                          assign=True)
    model.eval()
    if args.batch_size > 1:
        paths = run_acoustic_inference_batched(
            cfg, model, dataset, args.save_dir, batch_size=args.batch_size,
            n_timesteps=args.n_timesteps, temperature=args.temperature, solver=args.solver,
            device=device)
    else:
        paths = run_acoustic_inference(
            cfg, model, dataset, args.save_dir, n_timesteps=args.n_timesteps,
            temperature=args.temperature, length_scale=args.length_scale,
            use_align=args.use_align, solver=args.solver, device=device)
    logging.info("saved %d artifacts to %s", len(paths), args.save_dir)
    return paths


if __name__ == "__main__":
    main()
