"""Trajectory and spectrogram quality metrics (a copy of
`arttts_tpu/eval/metrics.py`, NumPy only).

Equivalents of the reference's tslearn-based `normalized_dtw_score` (DTW
distance / sqrt(path length) and the path-aligned signals) and of the PCC
computations of its quantitative evaluation: classic O(nm) DTW with
Euclidean frame distance, as `tslearn.metrics.dtw_path`. The trainer logs
`normalized_dtw_score` of each synthesized validation sample.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def dtw_path(s1: np.ndarray, s2: np.ndarray) -> Tuple[List[Tuple[int, int]], float]:
    """Dynamic time warping between (T1, C) and (T2, C) sequences.

    Returns (path [(i, j), ...], distance) with distance =
    sqrt(sum of squared Euclidean frame distances along the optimal path) —
    the tslearn convention.
    """
    s1 = np.atleast_2d(np.asarray(s1, np.float64))
    s2 = np.atleast_2d(np.asarray(s2, np.float64))
    if s1.shape[0] == 1 and s1.shape[1] > 1 and s2.shape[0] == 1:
        s1, s2 = s1.T, s2.T
    n, m = s1.shape[0], s2.shape[0]
    # pairwise squared distances via the Gram expansion (vectorized)
    sq = (
        (s1**2).sum(1)[:, None] + (s2**2).sum(1)[None, :] - 2.0 * s1 @ s2.T
    )
    sq = np.maximum(sq, 0.0)

    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        # cumulative DP row; vectorizing the inner min over the three
        # predecessors still needs the left neighbor sequentially
        row_prev = acc[i - 1]
        row = acc[i]
        for j in range(1, m + 1):
            row[j] = sq[i - 1, j - 1] + min(
                row_prev[j], row[j - 1], row_prev[j - 1]
            )

    # backtrace
    path = [(n - 1, m - 1)]
    i, j = n, m
    while (i, j) != (1, 1):
        steps = [(i - 1, j - 1), (i - 1, j), (i, j - 1)]
        costs = [acc[a, b] for a, b in steps]
        i, j = steps[int(np.argmin(costs))]
        path.append((i - 1, j - 1))
    path.reverse()
    return path, float(np.sqrt(acc[n, m]))


def normalized_dtw_score(
    pred: np.ndarray, target: np.ndarray
) -> Tuple[float, np.ndarray, np.ndarray]:
    """DTW distance normalized by sqrt(path length), plus the path-aligned
    signals (metrics.py:36-51)."""
    path, dist = dtw_path(pred, target)
    score = dist / np.sqrt(len(path))
    idx1 = np.array([p[0] for p in path])
    idx2 = np.array([p[1] for p in path])
    return score, np.asarray(pred)[idx1], np.asarray(target)[idx2]


def pearson_correlation(a: np.ndarray, b: np.ndarray) -> float:
    """PCC between two 1-D signals (quanti_art_voxcom.py:140-151)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a**2).sum() * (b**2).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def ema_mean_pcc(pred: np.ndarray, target: np.ndarray, n_ema: int = 12) -> float:
    """Mean per-channel PCC over the 12 EMA channels."""
    return float(
        np.mean(
            [pearson_correlation(pred[:, c], target[:, c]) for c in range(n_ema)]
        )
    )


def mel_l2(pred: np.ndarray, target: np.ndarray) -> float:
    """Mean per-frame L2 distance between (T, n_mels) log-mels."""
    T = min(pred.shape[0], target.shape[0])
    return float(
        np.mean(np.linalg.norm(pred[:T] - target[:T], axis=1))
    )
