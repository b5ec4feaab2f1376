"""Host-side batching into bucketed, padded batches (the port's own copy of
`arttts_tpu/data/batching.py`).

Batches pad to a small set of static buckets (text and frame axes
independently), as in the JAX package. Length-grouped ordering follows the
reference samplers: shuffle mega-batches of batch_size * mult, sort by
length inside, emit the longest batch first (an out-of-memory error shows
at once). Multilingual sets (the v6 family) may instead draw their indices
by temperature-based language upsampling (`voxcommunis/sampler.py`).
Batches are numpy arrays; the trainer moves them to the card.

Data parallelism (`num_hosts > 1`): every rank walks the same global
batches (the same seed and epoch give the same order) and keeps its
contiguous `batch_size / num_hosts` rows of each, padded to fixed buckets
so that every rank's tensors have one shape.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from arttts_tpu_torch.ops.shape import fix_len_compatibility
from arttts_tpu_torch.voxcommunis.sampler import LengthGroupedLanguageUpSampler

DEFAULT_TEXT_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512)
DEFAULT_FRAME_BUCKETS = (128, 256, 384, 512, 640, 768, 1024, 1536, 2048)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return fix_len_compatibility(n)


def pad_batch(
    items: List[Dict[str, np.ndarray]],
    text_buckets: Sequence[int] = DEFAULT_TEXT_BUCKETS,
    frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS,
    min_frames: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Zero-pad a list of {"x", "y"[, "spk", "durations"]} items into one
    dense batch: x (T_x,) symbol ids or (T_x, C) float traits, y (T_y, C)
    float. `min_frames` lets training guarantee T_y >= out_size for the
    segment cut. "spk" (an int id or a vector) is stacked; "durations"
    (T_x,) is zero-padded to (B, T_x) float32."""
    B = len(items)
    x_lens = np.array([it["x"].shape[0] for it in items], np.int32)
    y_lens = np.array([it["y"].shape[0] for it in items], np.int32)
    T_x = pick_bucket(int(x_lens.max()), text_buckets)
    frames = int(y_lens.max()) if min_frames is None else max(int(y_lens.max()), min_frames)
    T_y = pick_bucket(fix_len_compatibility(frames), frame_buckets)

    x0 = items[0]["x"]
    if x0.ndim == 1:
        x = np.zeros((B, T_x), dtype=x0.dtype)
    else:
        x = np.zeros((B, T_x, x0.shape[1]), dtype=np.float32)
    y = np.zeros((B, T_y, items[0]["y"].shape[1]), dtype=np.float32)
    for i, it in enumerate(items):
        x[i, : x_lens[i]] = it["x"]
        y[i, : y_lens[i]] = it["y"]
    batch = {"x": x, "x_lengths": x_lens, "y": y, "y_lengths": y_lens}
    if "spk" in items[0]:
        batch["spk"] = np.stack([np.asarray(it["spk"]) for it in items])
    if "durations" in items[0]:
        dur = np.zeros((B, T_x), np.float32)
        for i, it in enumerate(items):
            dur[i, : x_lens[i]] = it["durations"]
        batch["durations"] = dur
    return batch


class BucketBatcher:
    """Length-grouped batch index generator.

    Shuffle the indices, split them into mega-batches of
    batch_size * mega_batch_mult, sort each by length, longest first, then
    move the globally longest batch to the front. A last partial batch is
    dropped. With `num_hosts > 1` each global batch yields host `host_id`'s
    contiguous row slice."""

    def __init__(self, lengths: Sequence[int], batch_size: int, shuffle: bool = True,
                 seed: int = 37, host_id: int = 0, num_hosts: int = 1):
        if batch_size % num_hosts:
            raise ValueError(f"global batch_size {batch_size} must divide over {num_hosts} hosts")
        self.lengths = np.asarray(lengths)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.mega_batch_mult = min(len(lengths) // (batch_size * 4), 50) or 1
        rows = batch_size // num_hosts
        self.rows = slice(host_id * rows, (host_id + 1) * rows)  # this host's rows
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[np.ndarray]:
        n = len(self.lengths)
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(n) if self.shuffle else np.arange(n)

        mega = self.batch_size * self.mega_batch_mult
        grouped: List[np.ndarray] = []
        for i in range(0, n, mega):
            chunk = order[i : i + mega]
            chunk = chunk[np.argsort(-self.lengths[chunk], kind="stable")]
            grouped.append(chunk)
        indices = np.concatenate(grouped) if grouped else np.empty(0, np.int64)

        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if batches and len(batches[-1]) < self.batch_size:
            batches = batches[:-1]
        if len(batches) > 1:
            longest = max(
                range(len(batches)), key=lambda b: self.lengths[batches[b]].max()
            )
            batches[0], batches[longest] = batches[longest], batches[0]
        for b in batches:
            yield b[self.rows]

    def __len__(self) -> int:
        return len(self.lengths) // self.batch_size


class DataLoader:
    """Dataset + BucketBatcher + pad_batch. The dataset is any object with
    `__len__`, `__getitem__` -> {"x", "y"} and `lengths()`.

    `language_upsample` draws each epoch's indices instead from
    `LengthGroupedLanguageUpSampler` over `dataset.lang_sizes` (languages
    with probability ~ size^factor, then length-grouped; ref train_v6.py,
    upsample_factor 0.5, msml1h 0.9), cut into full batches of
    `batch_size`.

    `host_id` / `num_hosts` slice every global batch to one rank's rows
    (data parallelism); several hosts need fixed `text_bucket` and
    `frame_bucket` pad lengths, as buckets picked from each rank's rows
    would give the ranks tensors of other shapes and hang the collectives.

    Upcoming batches are assembled on a background thread, `prefetch` at
    most ahead (a bounded queue), so the host's batching overlaps the
    card's steps."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 37,
        min_frames: Optional[int] = None,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 2,
        language_upsample: Optional[float] = None,
        text_bucket: Optional[int] = None,
        frame_bucket: Optional[int] = None,
    ):
        if num_hosts > 1 and not (text_bucket and frame_bucket):
            raise ValueError("a multi-host DataLoader needs fixed text_bucket and frame_bucket "
                             "(e.g. config.data.max_text_len / max_frame_len)")
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self.dataset = dataset
        self.batch_size = batch_size
        lengths = dataset.lengths()
        self.batcher = BucketBatcher(lengths, batch_size, shuffle=shuffle, seed=seed,
                                     host_id=host_id, num_hosts=num_hosts)
        self.text_buckets = (text_bucket,) if text_bucket else DEFAULT_TEXT_BUCKETS
        self.frame_buckets = (frame_bucket,) if frame_bucket else DEFAULT_FRAME_BUCKETS
        self.lang_sampler = None
        if language_upsample is not None:
            if not getattr(dataset, "lang_sizes", None):
                raise ValueError("language_upsample needs a dataset with lang_sizes")
            self.lang_sampler = LengthGroupedLanguageUpSampler(
                batch_size, lengths, dataset.lang_sizes, upsample_factor=language_upsample,
                seed=seed)
        self.min_frames = min_frames
        self.prefetch = prefetch

    def set_epoch(self, epoch: int):
        self.batcher.set_epoch(epoch)

    def _make_batch(self, idx):
        return pad_batch([self.dataset[int(i)] for i in idx], self.text_buckets,
                         self.frame_buckets, min_frames=self.min_frames)

    def _index_batches(self):
        if self.lang_sampler is None:
            return self.batcher
        order = np.fromiter(iter(self.lang_sampler), dtype=np.int64)
        n = self.batch_size
        return [order[i: i + n][self.batcher.rows] for i in range(0, len(order) - n + 1, n)]

    def __iter__(self):
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        _END = object()

        def producer():
            try:
                for idx in self._index_batches():
                    if stop.is_set():
                        return
                    q.put(self._make_batch(idx))
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)
                return
            q.put(_END)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:  # also when the consumer stops early: free a producer blocked on put
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)

    def __len__(self):
        return len(self.batcher)
