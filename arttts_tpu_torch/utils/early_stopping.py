"""Multi-loss early stopping (the port's own copy of
`arttts_tpu/utils/early_stopping.py`).

Patience counts consecutive validation checks where *none* of the tracked
sublosses (prior, diff, dur, total) improved; `glob_improv` flags a new best
total loss (drives `grad_best` checkpointing). State is a plain dict so it
serialises into the checkpoint's metadata for resume.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


class EarlyStopping:
    def __init__(self, patience: int = 10, step_size: int = 5, n_losses: int = 4):
        self.patience = patience
        self.step_size = step_size
        self.counter = 0
        self.best_losses: List[float] = [float("inf")] * n_losses

    def step(self, losses: Sequence[float]) -> Tuple[int, bool]:
        """losses ordered (prior, diff, dur, total) — any improvement resets
        the counter; returns (counter, total_improved)."""
        if len(losses) != len(self.best_losses):
            raise ValueError(f"want {len(self.best_losses)} losses, got {len(losses)}")
        improvements = [l < b for l, b in zip(losses, self.best_losses)]
        glob_improv = False
        if any(improvements):
            self.counter = 0
            for i, imp in enumerate(improvements):
                if imp:
                    self.best_losses[i] = float(losses[i])
            glob_improv = improvements[-1]
        else:
            self.counter += 1
        return self.counter, glob_improv

    @property
    def should_stop(self) -> bool:
        # patience <= 0 disables early stopping (msml1h trains without it)
        return self.patience > 0 and self.counter >= self.patience

    def state_dict(self) -> dict:
        return {
            "patience": self.patience,
            "step_size": self.step_size,
            "counter": self.counter,
            "best_losses": list(self.best_losses),
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "EarlyStopping":
        es = cls(d["patience"], d["step_size"], n_losses=len(d["best_losses"]))
        es.counter = d["counter"]
        es.best_losses = list(d["best_losses"])
        return es
