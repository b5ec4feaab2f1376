"""VP-SDE noise schedule (port of `get_noise` in
`arttts_tpu/models/diffusion_sde.py`).

Linear schedule beta(t) = beta_min + (beta_max - beta_min) * t; the Euler
sampler that uses it is `arttts_tpu_torch/infer/sampler.py`.
"""

from __future__ import annotations


def get_noise(t, beta_min: float, beta_max: float, cumulative: bool = False):
    """beta(t), or its integral from 0 to t when cumulative."""
    if cumulative:
        return beta_min * t + 0.5 * (beta_max - beta_min) * (t**2)
    return beta_min + (beta_max - beta_min) * t
