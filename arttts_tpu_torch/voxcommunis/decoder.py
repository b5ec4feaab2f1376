"""Segment <-> phonological-feature bijection for multilingual tokenization
(a copy of `arttts_tpu/voxcommunis/decoder.py`).

Same *contract* as the reference decoder
(the reference's `src/voxcommunis/decoder.py:13-223`): segments sharing a
feature vector collapse onto the first-seen representative; diphthongs either
merge under an agreement mask (``sum_diphthong``) or split into their
component characters; ``find_segment`` inverts a ternary feature vector with
a least-zeros tie-break and mints fake segment names for unseen vectors.

The implementation is organised differently: one flat ``_VectorRegistry``
(ordered distinct vectors keyed by raw bytes) replaces the reference's two
inventory classes, and the inverse lookup is a single vectorized numpy
compatibility test (``(F == q) | (F == 0)`` per constrained dim) instead of
per-dimension boolean-mask dictionaries. Feature values come from the native
IPA trait table (`arttts_tpu_torch/text/ipa_features.py`) instead of panphon.
"""

from __future__ import annotations

from functools import cached_property, lru_cache
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from arttts_tpu_torch.text.ipa_features import SEGMENTS, TRAITS, word_features

PHON_FEAT_DIM = 24

SILENCE = "SIL"
ZERO_TONE = "˧"  # level-tone mark: the all-zero feature vector

_ZERO_ROW = np.zeros((1, PHON_FEAT_DIM), dtype=np.int8)


def _component_vectors(segment: str) -> np.ndarray:
    """(k, 24) int8 component vectors for a segment string; unknown segments
    fall back to a single zero row (the reference's silence fallback,
    decoder.py:34-40)."""
    if segment == ZERO_TONE:
        return _ZERO_ROW
    rows = word_features(segment)
    if rows is None:
        return _ZERO_ROW
    return np.asarray(rows, dtype=np.int8).reshape(-1, PHON_FEAT_DIM)


def _agreement_merge(rows: np.ndarray) -> np.ndarray:
    """Collapse component rows to one vector: dims where every component
    agrees keep the value, disagreeing dims zero out."""
    unanimous = (rows == rows[:1]).all(axis=0)
    return np.where(unanimous, rows[0], 0).astype(np.int8)


class _VectorRegistry:
    """Insertion-ordered set of distinct feature vectors.

    The first segment to introduce a vector becomes its representative;
    later segments with the same vector are recorded as aliases.
    """

    __slots__ = ("rows", "reps", "_row_of")

    def __init__(self) -> None:
        self.rows: List[np.ndarray] = []
        self.reps: List[str] = []
        self._row_of: Dict[bytes, int] = {}

    def put(self, segment: str, vector: np.ndarray) -> int:
        key = vector.tobytes()
        row = self._row_of.get(key)
        if row is None:
            row = len(self.rows)
            self._row_of[key] = row
            self.rows.append(vector)
            self.reps.append(segment)
        return row

    def lookup(self, vector: np.ndarray) -> Optional[int]:
        return self._row_of.get(vector.tobytes())


class FeatureDecoder:
    def __init__(
        self, sum_diphthong: bool, lang_segments: Optional[Iterable[str]] = None
    ):
        self.sum_diphthong = sum_diphthong
        self.multilingual_mode = lang_segments is None
        self.fake_segments: Dict[Tuple[int, ...], str] = {}

        self._registry = _VectorRegistry()
        # every known segment string -> the registry rows it expands to
        self._rows_of_segment: Dict[str, Tuple[int, ...]] = {}

        if self.multilingual_mode:
            # whole trait table, one vector per base segment, plus the
            # zero-vector level tone (decoder.py:80-98)
            for seg in (*SEGMENTS, ZERO_TONE):
                self._register(seg, _component_vectors(seg)[:1])
        else:
            # reference ordering: all single-component segments first, then
            # multi-component ones (decoder.py:18-24)
            staged = sorted(
                ((seg, _component_vectors(seg)) for seg in lang_segments),
                key=lambda item: len(item[1]) > 1,
            )
            for seg, vectors in staged:
                self._register(seg, vectors)

        self._matrix = np.stack(self._registry.rows, axis=0).astype(np.int64)
        self._row_of_rep = {rep: i for i, rep in enumerate(self._registry.reps)}

    def _register(self, segment: str, vectors: np.ndarray) -> None:
        if segment in self._rows_of_segment:
            return
        if len(vectors) == 1:
            self._rows_of_segment[segment] = (self._registry.put(segment, vectors[0]),)
        elif self.sum_diphthong:
            merged = _agreement_merge(vectors)
            self._rows_of_segment[segment] = (self._registry.put(segment, merged),)
        else:
            if len(segment) != len(vectors):
                raise ValueError(
                    f"Expected {len(vectors)} characters in {segment!r} to split "
                    "a multi-component segment"
                )
            rows = []
            for char, vec in zip(segment, vectors):
                existing = self._rows_of_segment.get(char)
                if existing is None:
                    existing = (self._registry.put(char, vec),)
                    self._rows_of_segment[char] = existing
                rows.extend(existing)
            self._rows_of_segment[segment] = tuple(rows)

    # -- public inventory views ------------------------------------------

    @cached_property
    def header(self) -> Tuple[str, ...]:
        return tuple(TRAITS[:PHON_FEAT_DIM])

    @cached_property
    def segments(self) -> Tuple[str, ...]:
        return tuple(self._registry.reps)

    @lru_cache(maxsize=None)
    def segment_id(self, segment: str) -> int:
        return self.segments.index(segment)

    @property
    def features(self) -> np.ndarray:
        return self._matrix

    @cached_property
    def zero_index(self) -> int:
        if self.multilingual_mode:
            return self._rows_of_segment[ZERO_TONE][0]
        return self.segments.index(SILENCE)

    # -- forward: segment -> representative -> features -------------------

    def _register_dynamic(self, name: str, vector: np.ndarray) -> int:
        """Grow the multilingual inventory for a parseable segment whose
        vector is not yet registered (e.g. diacritic-modified phones —
        panphon pre-composes thousands of these; our trait table composes
        them on demand)."""
        row = self._registry.put(name, vector)
        self._matrix = np.concatenate(
            [self._matrix, vector[None].astype(np.int64)], axis=0
        )
        self._row_of_rep[name] = row
        self.__dict__.pop("segments", None)  # invalidate cached views
        self.segment_id.cache_clear()
        return row

    def segment_to_representative(self, segment: str) -> Tuple[str, ...]:
        if segment == SILENCE:
            return (self.segments[self.zero_index],)
        rows = self._rows_of_segment.get(segment)
        if rows is not None:
            return tuple(self._registry.reps[r] for r in rows)
        if not self.multilingual_mode:
            raise KeyError(
                f"Unable to find segment {segment!r} in the language inventory."
            )
        # unseen multilingual segment: resolve each component by vector;
        # parseable-but-unregistered vectors extend the inventory in place,
        # truly unknown segments (zero rows from the parse fallback) degrade
        # to the silence representative
        vectors = _component_vectors(segment)
        reps = []
        for i, vec in enumerate(vectors):
            row = self._registry.lookup(vec)
            if row is None:
                name = segment if len(vectors) == 1 else f"{segment}[{i}]"
                row = self._register_dynamic(name, vec)
            reps.append(self._registry.reps[row])
        self._rows_of_segment[segment] = tuple(
            self._row_of_rep[r] for r in reps
        )
        return tuple(reps)

    def canonical_representation(
        self, representative: Tuple[str, ...]
    ) -> Tuple[Tuple[str, ...], np.ndarray]:
        rows = self._matrix[[self._row_of_rep[rep] for rep in representative]]
        if self.sum_diphthong and len(representative) > 1:
            assert self.multilingual_mode
            return ("".join(representative),), _agreement_merge(rows)[None, :]
        return representative, rows

    # -- inverse: features -> segment --------------------------------------

    def find_segment(self, features: Tuple[int, ...]) -> str:
        minted = self.fake_segments.get(features)
        if minted is not None:
            return minted
        if not any(features):
            return self.segments[self.zero_index]
        # a stored vector is compatible when every non-zero query dim is
        # either matched exactly or unspecified (0) in the stored row
        query = np.asarray(features, dtype=np.int64)
        compatible = np.flatnonzero(
            ((query == 0) | (self._matrix == query) | (self._matrix == 0)).all(axis=1)
        )
        if compatible.size == 0:
            return self.fake_segments.setdefault(
                features, str(len(self.fake_segments) + 1)
            )
        # least-zeros wins; np.argmin keeps the first (stable tie-break)
        zeros = (self._matrix[compatible] == 0).sum(axis=1)
        return self.segments[compatible[np.argmin(zeros)]]
