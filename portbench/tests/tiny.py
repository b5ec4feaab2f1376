"""Cells at a size a CPU test can hold: the cells' own files with the
encoder and vocoder narrowed, few solver steps and short utterances. The
U-Net keeps its widths (the port's kernels take only the flagship U-Net;
on the CPU they run their plain versions)."""

from __future__ import annotations

import copy
import json

import torch

from portbench import harness


def tiny_config(name: str) -> dict:
    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    enc = cfg["model"]["encoder"]
    enc.update(n_channels=16, filter_channels=32, filter_channels_dp=16, n_layers=1)
    if cfg["vocoder"]["kind"] == "hifigan":
        cfg["vocoder"]["upsample_initial_channel"] = 32
    else:
        cfg["vocoder"]["channels"] = 32
        cfg["sparc"].update(chunk=64, halo=16, win_batch=2)
    if "train" in cfg:
        cfg["train"].update(batch_size=4, out_size=32)
    return cfg


def tiny_spec(workload: str, full_width: bool = False) -> harness.Spec:
    """The cell with little traffic; the model narrowed and few solver
    steps, or with `full_width` the cell's own model and steps (on a card)."""
    spec = copy.deepcopy(harness.load_spec(workload))
    tr = spec.traffic
    steps = tr.get("n_timesteps") if full_width else 8
    if not full_width:
        spec.config = tiny_config(spec.cell["config"])
    if tr["kind"] == "closed_loop_serve":
        tr.update(pool=6, strata=2, n_timesteps=steps,
                  duration_s={"dist": "uniform", "min": 0.5, "max": 1.4})
        tr["check"].update(sample=3, control_requests=2)
        tr["trace"].update(skip=1, units=2)
    elif tr["kind"] == "batch_pipeline":
        tr.update(chunk_items=6, batch_size=4, speakers=2, n_timesteps=steps,
                  duration_s={"dist": "uniform", "min": 0.6, "max": 1.6})
        tr["check"].update(sample=3, control_items=2)
        tr["trace"].update(skip=0, units=1)
    else:
        tr.update(distinct_batches=3, duration_s={"dist": "uniform", "min": 0.4, "max": 1.2},
                  frames_per_symbol=3.0)
        tr["trace"].update(skip=1, units=2)
    return spec


def run_tiny(workload: str, seed: int = 3, seconds: float = 0.5, trace: bool = False,
             control: bool = False, fault=None) -> dict:
    run = harness.Run(tiny_spec(workload), seed, seconds, torch.device("cpu"), trace, workload,
                      fault=fault, control=control)
    return harness.run_cell(run, t0=0.0, log=lambda *a: None)
