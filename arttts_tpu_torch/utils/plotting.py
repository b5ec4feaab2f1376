"""Matplotlib -> numpy image helpers for TensorBoard logging (port of
`arttts_tpu/utils/plotting.py`, ref `src/utils.py:67-96,167-231`).
matplotlib is imported when a function is called."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _fig_to_numpy(fig) -> np.ndarray:
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    return data.reshape(h, w, 4)[:, :, :3].copy()


def plot_tensor(tensor: np.ndarray, title: str = "") -> np.ndarray:
    """Heatmap image of a (C, T) or (T, C) feature matrix."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    arr = np.asarray(tensor)
    if arr.shape[0] > arr.shape[1]:
        arr = arr.T
    fig, ax = plt.subplots(figsize=(8, 3))
    im = ax.imshow(arr, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    if title:
        ax.set_title(title)
    out = _fig_to_numpy(fig)
    plt.close(fig)
    return out


def plot_art_trajectories(
    tensors: Sequence[np.ndarray],
    labels: Optional[Sequence[str]] = None,
    sr: int = 50,
    n_channels: int = 14,
) -> np.ndarray:
    """Per-channel line plots of articulatory trajectories, overlaying
    multiple tensors (e.g. prediction vs ground truth), like the 14-channel
    plotter at utils.py:167-231."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(n_channels, tensors[0].shape[-1] if tensors[0].ndim == 2 else n_channels)
    fig, axes = plt.subplots(n, 1, figsize=(8, 1.2 * n), sharex=True)
    if n == 1:
        axes = [axes]
    for k, arr in enumerate(tensors):
        arr = np.asarray(arr)
        if arr.shape[0] < arr.shape[1]:
            arr = arr.T  # (T, C)
        t = np.arange(arr.shape[0]) / sr
        for c in range(n):
            axes[c].plot(
                t, arr[:, c], lw=0.8, label=(labels[k] if labels else None)
            )
    if labels:
        axes[0].legend(loc="upper right", fontsize=6)
    out = _fig_to_numpy(fig)
    plt.close(fig)
    return out


def plot_alignment(attn: np.ndarray, title: str = "alignment") -> np.ndarray:
    """(T_x, T_y) binary/soft alignment heatmap."""
    return plot_tensor(np.asarray(attn), title=title)
