"""Batch phnm3 generation CLI (port of `arttts_tpu/cli/generate_phnm3.py`,
ref `src/generate_phnm3.py`):

    python -m arttts_tpu_torch.cli.generate_phnm3 --corpus mngu0 \
        --phnm-dir labels/ --save-dir phnm3/

Writes `{stem}_phnm3.npy` for every label file of the corpus and returns
the paths written; a file that fails is logged and skipped. It reads labels on the host and runs no model,
so it takes no `--device`.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--corpus", required=True,
                        choices=["mngu0", "mocha", "mspka", "pb2007"])
    parser.add_argument("--phnm-dir", required=True)
    parser.add_argument("--save-dir", required=True)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("generate_phnm3")

    from arttts_tpu_torch.corpora import get_corpus

    corpus = get_corpus(args.corpus)
    phnm_dir = Path(args.phnm_dir)
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(phnm_dir.glob(f"*{corpus.label_ext}"))
    log.info("found %d label files", len(files))
    written = []
    for fp in files:
        try:
            phnm3 = corpus.get_phnm3(fp)
            np.save(save_dir / f"{fp.stem}_phnm3.npy", phnm3)
            written.append(str(save_dir / f"{fp.stem}_phnm3.npy"))
        except Exception as e:  # log-and-continue like the reference
            log.error("error processing %s: %s", fp, e)
    return written


if __name__ == "__main__":
    main()
