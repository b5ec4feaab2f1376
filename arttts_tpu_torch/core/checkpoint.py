"""Checkpoint save and restore (port of `arttts_tpu/core/checkpoint.py`).

The JAX package's file policy: one directory per named checkpoint
(`grad_{epoch}`, `grad_best`, `grad_final`) holding the weights, the
optimizer state (so a resumed run continues Adam's moments) and
`meta.json` with the step and extra metadata (epoch, early stopping). The
format is the port's own: `state.pt`, a `torch.save` of the model's and the
optimizer's state dicts. The vocoder trainer's `voc_{step}` checkpoints
hold the generator's and the discriminators' weights only, as the JAX
`cli/train_vocoder.py` saves them.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional

import torch


def save_checkpoint(
    ckpt_dir: str,
    name: str,
    model_state: Dict[str, Any],
    optimizer_state: Optional[Dict[str, Any]] = None,
    step: int = 0,
    extra: Optional[Dict] = None,
) -> str:
    """Save a named checkpoint (e.g. "grad_12", "grad_best"); returns its path."""
    path = Path(ckpt_dir).resolve() / name
    path.mkdir(parents=True, exist_ok=True)
    tree = {"model": model_state}
    if optimizer_state is not None:
        tree["optimizer"] = optimizer_state
    torch.save(tree, path / "state.pt.tmp")
    os.replace(path / "state.pt.tmp", path / "state.pt")
    (path / "meta.json").write_text(json.dumps({"step": int(step), "extra": extra or {}}))
    return str(path)


def load_checkpoint(path: str, map_location="cpu") -> Dict:
    """Load a checkpoint directory -> {"model", "optimizer"?, "step", "extra"}."""
    path = Path(path).resolve()
    out = torch.load(path / "state.pt", map_location=map_location, weights_only=True)
    meta = {"step": 0, "extra": {}}
    meta_fp = path / "meta.json"
    if meta_fp.exists():
        meta = json.loads(meta_fp.read_text())
    out["step"] = meta["step"]
    out["extra"] = meta["extra"]
    return out


def latest_checkpoint(ckpt_dir: str, prefix: str = "grad_") -> Optional[str]:
    """The numbered checkpoint with the highest epoch, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    best, best_n = None, -1
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(rf"{re.escape(prefix)}(\d+)", p.name)
        if m and int(m.group(1)) > best_n:
            best, best_n = p, int(m.group(1))
    return str(best) if best else None


def save_vocoder_checkpoint(ckpt_dir: str, step: int, weights: Dict[str, Any]) -> str:
    """Save `VocoderGAN.weights()` ({"gen", "disc"}) as `voc_{step}`; no
    optimizer state. Returns its path."""
    return save_checkpoint(ckpt_dir, f"voc_{step}", weights, step=step)


def load_vocoder_checkpoint(path: str) -> Dict:
    """A `voc_{step}` checkpoint -> {"gen", "disc", "step"}, on the CPU."""
    out = load_checkpoint(path)
    return {**out["model"], "step": out["step"]}
