"""UTMOS batch scoring CLI (port of `arttts_tpu/cli/score.py`, the
reference's UTMOS-demo `predict.py`):

    python -m arttts_tpu_torch.cli.score --ckpt epoch=3-step=7459.ckpt \
        --wav-dir wavs/v2 --out-csv scores.csv --bs 32

Appends one `filename,score` row a wav to `--out-csv`. Runs on the card
(`--device cuda`, the default) unless `--device cpu` is asked for.
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True, help="UTMOS lightning ckpt")
    parser.add_argument("--wav-dir", required=True)
    parser.add_argument("--out-csv", required=True)
    parser.add_argument("--bs", type=int, default=32)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from arttts_tpu_torch.core.runtime import setup_runtime
    from arttts_tpu_torch.eval.utmos_scorer import UTMOSScorer

    device = setup_runtime(args.device)
    scorer = UTMOSScorer.from_lightning_checkpoint(args.ckpt, device=device)
    results = scorer.score_directory(args.wav_dir, args.out_csv, batch_size=args.bs)
    if results:
        mean = sum(results.values()) / len(results)
        logging.info("scored %d files, mean MOS %.3f", len(results), mean)
    return results


if __name__ == "__main__":
    main()
