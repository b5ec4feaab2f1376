"""Length-grouped samplers (a copy of `arttts_tpu/voxcommunis/sampler.py`,
after the reference's `src/voxcommunis/sampler.py:24-147`, HF lineage):
shuffled mega-batches sorted by length, longest batch first; plus
temperature-based language upsampling (`p ~ size^upsample_factor`).

Pure numpy, so a seed gives the JAX package's index streams exactly. Each
sampler builds its `default_rng(seed)` once and draws from it again on
every `__iter__`: the epochs differ, and the stream carries from one epoch
to the next. They feed the host-side batching (`data/batching.py`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def get_length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    indices: Optional[np.ndarray] = None,
    mega_batch_mult: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    rng = rng or np.random.default_rng()
    if mega_batch_mult is None:
        mega_batch_mult = min(len(lengths) // (batch_size * 4), 50) or 1
    perm = rng.permutation(len(lengths))
    indices = perm if indices is None else np.asarray(indices)[perm]
    mega = mega_batch_mult * batch_size
    lengths = np.asarray(lengths)
    megabatches = [
        sorted(indices[i : i + mega].tolist(), key=lambda i_: lengths[i_], reverse=True)
        for i in range(0, len(indices), mega)
    ]
    maxima = [lengths[mb[0]] for mb in megabatches]
    max_idx = int(np.argmax(maxima))
    megabatches[0][0], megabatches[max_idx][0] = (
        megabatches[max_idx][0],
        megabatches[0][0],
    )
    return [i for mb in megabatches for i in mb]


class LengthGroupedSampler:
    def __init__(self, batch_size: int, lengths: Sequence[int], seed: int = 0):
        self.batch_size = batch_size
        self.lengths = lengths
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.lengths)

    def __iter__(self):
        return iter(
            get_length_grouped_indices(self.lengths, self.batch_size, rng=self.rng)
        )


class LengthGroupedLanguageUpSampler:
    """Samples languages with probability proportional to size^factor, then
    length-groups the drawn indices (sampler.py:99-147)."""

    def __init__(
        self,
        batch_size: int,
        lengths: Sequence[int],
        lang_sizes: Sequence[int],
        upsample_factor: float,
        seed: int = 0,
    ):
        self.batch_size = batch_size
        self.lengths = lengths
        end = 0
        self.lang_boundaries = []
        for size in lang_sizes:
            self.lang_boundaries.append((end, end + size))
            end += size
        total = sum(lang_sizes)
        probas = np.array([(s / total) ** upsample_factor for s in lang_sizes])
        self.probas = probas / probas.sum()
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.lengths)

    def __iter__(self):
        draws = self.rng.choice(len(self.probas), size=len(self), p=self.probas)
        langs, counts = np.unique(draws, return_counts=True)
        indices = np.concatenate(
            [
                self.rng.integers(*self.lang_boundaries[int(l)], size=int(c))
                for l, c in zip(langs, counts)
            ]
        )
        return iter(
            get_length_grouped_indices(
                self.lengths, self.batch_size, indices=indices, rng=self.rng
            )
        )
