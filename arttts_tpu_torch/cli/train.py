"""Training CLI (port of `arttts_tpu/cli/train.py`, the reference's
per-version `train_v*.py` scripts):

    python -m arttts_tpu_torch.cli.train --preset v1 --data-root /data \
        --train-filelist lists/train.txt --valid-filelist lists/valid.txt

Every preset trains: the single-speaker ones from a filelist, the v6
family from a VoxCommunis layout (`--manifest`, `--alignment`, and for
msml1h `--separate-files`, with the preset's language upsampling unless
`--language-upsample` says otherwise). Runs on the card (`--device cuda`,
the default) unless `--device cpu` is asked for; with no card a "cuda" run
raises. Losses are logged to TensorBoard where `tensorboardX` imports.

`--mesh` trains data-parallel, one process a card, under a launcher:

    python -m torch.distributed.run --nproc_per_node=N \
        -m arttts_tpu_torch.cli.train --mesh --preset v2 ...

Each rank joins the process group (NCCL; gloo with `--device cpu`), keeps
its rows of every global batch of `--batch-size` and steps on the global
batch's loss (`train/trainer.py`). Without a launcher `--mesh` is a world
of one.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging


def tensorboard_writer(log_dir: str):
    """A `tensorboardX.SummaryWriter` on `log_dir`, or None where tensorboardX
    is not installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", default="v2")
    parser.add_argument("--data-root", default=".")
    parser.add_argument("--train-filelist")
    parser.add_argument("--valid-filelist")
    parser.add_argument("--cmudict")
    parser.add_argument("--artic-dir")
    parser.add_argument("--manifest")
    parser.add_argument("--alignment")
    parser.add_argument("--separate-files", action="store_true")
    parser.add_argument("--mel-cache")
    parser.add_argument("--log-dir")
    parser.add_argument("--epochs", type=int)
    parser.add_argument("--batch-size", type=int)
    parser.add_argument("--mesh", action="store_true",
                        help="data-parallel, one rank a device (under torch.distributed.run)")
    parser.add_argument("--language-upsample", type=float,
                        help="temperature-based language upsampling factor "
                             "(e.g. 0.5, multilingual v6/msml1h)")
    parser.add_argument("--resume", nargs="?", const="latest")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import torch

    from arttts_tpu_torch.core.config import get_preset
    from arttts_tpu_torch.core.runtime import setup_runtime
    from arttts_tpu_torch.data.datasets import build_dataset
    from arttts_tpu_torch.parallel.distributed import init_distributed
    from arttts_tpu_torch.parallel.mesh import make_mesh
    from arttts_tpu_torch.train.trainer import Trainer

    mesh = None
    joined = torch.distributed.is_initialized()
    if args.mesh:
        init_distributed(device=None if args.device == "cuda" else args.device)
        mesh = make_mesh(device_type=torch.device(args.device).type)
    device = setup_runtime(args.device if mesh is None else mesh.device)
    cfg = get_preset(args.preset)
    overrides = {k: v for k, v in {"batch_size": args.batch_size, "log_dir": args.log_dir}.items()
                 if v}
    if overrides:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **overrides))
    train_ds = build_dataset(cfg, args, args.train_filelist or cfg.data.train_filelist,
                             device=device)
    valid_ds = (build_dataset(cfg, args, args.valid_filelist, device=device)
                if args.valid_filelist else None)
    language_upsample = (args.language_upsample if args.language_upsample is not None
                         else (cfg.data.language_upsample or None))
    main_rank = mesh is None or mesh.coords == {"data": 0, "model": 0}
    writer = tensorboard_writer(cfg.train.log_dir) if main_rank else None
    try:
        trainer = Trainer(cfg, train_ds, valid_dataset=valid_ds, tb_writer=writer,
                          device=device, language_upsample=language_upsample, mesh=mesh)
        if args.resume:
            trainer.resume(None if args.resume == "latest" else args.resume)
        trainer.fit(n_epochs=args.epochs)
    finally:
        if writer is not None:
            writer.close()
        if torch.distributed.is_initialized() and not joined:
            torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
