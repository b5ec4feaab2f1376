"""The check: a run of each cell at a small size on the CPU comes out
correct; the same run with the timed path broken underneath comes out not
correct, once for each fault the cell can have. On the card, the control
(the reference in the program's place, in TF32) comes out not correct."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.tests.tiny import run_tiny, tiny_spec

FAULTS = {"v2.serve": ("state_unchanged", "answer_altered"),
          "v6.batch": ("state_unchanged", "answer_altered"),
          "v2.train": ("state_unchanged", "half_batch")}


@pytest.mark.parametrize("workload", list(FAULTS))
def test_sound_run_is_correct(workload):
    r = run_tiny(workload, seed=2 ** 31 + 77, seconds=0.3)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in FAULTS.items() for f in fs])
def test_planted_fault_is_caught(workload, fault):
    r = run_tiny(workload, seed=5, seconds=0.3, fault=fault)
    assert not r["correct"], (fault, r["checks"])


def test_a_fault_of_the_window_alone_is_caught():
    """A training step that goes wrong only once set-up is over (as a step
    captured after warm-up could) passes the check of the first steps and
    fails that of the window's own."""
    import torch
    from arttts_tpu_torch.train import losses

    from portbench.faults import planted

    run = harness.Run(tiny_spec("v2.train"), 8, 0.3, torch.device("cpu"), False, "v2.train")
    drv = harness.driver_class("train_steps")(run)
    drv.setup()
    with planted("half_batch"):
        drv.loss_fn = losses.grad_tts_loss  # broken from the window's first step on
        w = drv.window(harness.Tracer(False, 0, 0, run.device))
    checks = harness.compare(drv.check(w), run.spec.limits["limits"])
    assert harness.passed({k: c for k, c in checks.items() if not k.startswith("window_")})
    assert not harness.passed(checks), checks


def test_traced_run_reports_per_layer_metrics_only():
    r = run_tiny("v2.train", seed=6, seconds=0.6, trace=True)
    assert r["correct"]
    assert "train_utts_per_s" not in r["metrics"] and "setup_s" not in r["metrics"]
    assert "mfu.train" in r["metrics"]
    assert r["metrics"]["mfu.train"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("workload", list(FAULTS))
def test_control_in_tf32_is_not_correct(card, workload):
    """The control at a size a test run holds (the cell's model and solver,
    little traffic): the reference in TF32 in the program's place fails the
    cell's limits (the cell's own size is read by `python3 -m
    portbench.calibrate --mode control`)."""
    from arttts_tpu_torch.core.runtime import setup_runtime

    setup_runtime(card)
    spec = tiny_spec(workload, full_width=True)
    run = harness.Run(spec, 11, 0.3, card, False, workload, control=True)
    r = harness.run_cell(run, 0.0, log=lambda *a: None)
    assert not r["correct"], r["checks"]
