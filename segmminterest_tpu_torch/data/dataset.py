"""Fixed-shape batch assembly (port of ``segmminterest_tpu/data/dataset.py``;
host-only numpy, same draws from ``np.random.default_rng(seed)`` so the
batches equal the JAX iterator's).

Behavioral spec: reference MMinterest/utils/dataloader_SegMM.py:186-382
(FrameDatasetSeq_SegMM._getitem + DataCollator) and
reference MMinterest/utils/dataloader_KuaiRand.py:185-288 (ID-only mode).

Every batch has identical static shapes:
  user_identity_id  (B,)        dense 1-based ids
  photo_identity_id (B,)
  label             (B, 40)     {1, 0, -1, -2}
  vid_mask          (B, 40)     bool, True for real segments
  row_mask          (B,)        bool, False for final-batch padding rows
and in feature mode additionally
  photo_lines       (B, 40)     int32 line ids into the feature table (-1 pad)
  user_lines        (B, 100)    int32 line ids (-1 pad)
  user_mask         (B, 100)    bool

The final partial batch is padded (not dropped, not ragged): padded rows carry
all -2 labels and row_mask False, and every loss/metric in the framework is
row_mask-aware, so results match the reference's ragged final batch exactly
while keeping one compiled shape.

Feature batches carry *indices*, not features — the feature table lives in
device memory and the gather happens on the card (engine/train.py).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from .labels import MAX_SEGMENTS
from .reader import InteractionTable, SeqReader
from .feature_store import FeatureStore

USER_MAX_SEGMENTS = 100  # dataloader_SegMM.py:199

_SENTINEL = object()


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    """Run ``it`` on a daemon thread, keeping up to ``size`` items assembled
    ahead of the consumer (SURVEY.md §7 layer 2: double-buffered host work).

    While the device executes step N the thread assembles batch N+1, so host
    batch assembly overlaps device compute instead of serializing against it —
    the reference's bottleneck was exactly this synchronous host path
    (dataloader_SegMM.py:271-362, worked around there with torch DataLoader
    workers). Exceptions raised by the producer are re-raised at the consumer.
    """
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        # bounded put that notices consumer shutdown, so an abandoned
        # iterator (debug break, early stop, NaN abort) does not leave the
        # thread blocked forever holding buffered batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


class BatchIterator:
    def __init__(self, reader: SeqReader, table: InteractionTable,
                 batch_size: int, shuffle: bool = False,
                 feature_store: Optional[FeatureStore] = None,
                 seed: int = 2024, pad_final: bool = True,
                 user_max: int = USER_MAX_SEGMENTS,
                 prefetch_size: int = 2,
                 transform=None):
        self.reader = reader
        self.table = table
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.store = feature_store
        self.rng = np.random.default_rng(seed)
        self.pad_final = pad_final
        self.user_max = user_max
        self.prefetch_size = prefetch_size
        # applied to each batch INSIDE the prefetch thread — e.g.
        # InterestEngine.batch_transform starts the host->device transfer
        # there, so the consumer's put_batch is a no-op and the h2d latency
        # overlaps device compute
        self.transform = transform
        # warm-up line ids are per-user constants; cache them
        self._warmup_cache: Dict[int, np.ndarray] = {}
        # per-table-row gather tables, built once on first iteration: the
        # photo lines and the (uid, position) candidate pools are functions
        # of the fixed table rows, so the per-sample dict lookups + history
        # slicing (the reference's hot path, dataloader_SegMM.py:302-352)
        # collapse into one vectorized index per batch. Only the per-epoch
        # random subsample of oversized pools stays per-row.
        self._photo_tab: Optional[np.ndarray] = None
        # Per-USER played-segment streams: the reference pool for a row is
        # the played line ids of the history window [pos-history_max, pos)
        # plus the warm-up pool (dataloader_SegMM.py:319-350). The window is
        # contiguous in the user's chronological history, so every row's
        # pool is a SLICE of one per-user concatenated stream plus the
        # warm-up suffix — EXACT reference pool semantics in
        # O(total played segments) memory, built in one pass per user
        # (PARITY D7).
        self._user_streams: Optional[Dict[int, tuple]] = None
        self._pool_a: Optional[np.ndarray] = None
        self._pool_b: Optional[np.ndarray] = None

    def _build_row_tables(self):
        t = self.table
        n = len(t)
        self._photo_tab = np.full((n, MAX_SEGMENTS), -1, np.int32)
        for r in range(n):
            n_frames = int((t.labels[r] != -2).sum())
            pl = self.store.photo_line_ids(int(t.video_raw[r]), n_frames)
            self._photo_tab[r, :len(pl)] = pl
        hm = self.reader.history_max
        streams: Dict[int, tuple] = {}
        for uid in np.unique(t.user_raw):
            uid = int(uid)
            items = self.reader.user_his_items.get(uid)
            if items is None:
                streams[uid] = (np.zeros(0, np.int32),
                                np.zeros(1, np.int64))
                continue
            playing = self.reader.user_his_playing[uid]
            chunks = [self.store.played_line_ids(pid, pt)
                      for pid, pt in zip(items, playing)]
            off = np.zeros(len(items) + 1, np.int64)
            if chunks:
                np.cumsum([len(c) for c in chunks], out=off[1:])
            stream = (np.concatenate(chunks).astype(np.int32) if chunks
                      else np.zeros(0, np.int32))
            streams[uid] = (stream, off)
        self._user_streams = streams
        self._pool_a = np.zeros(n, np.int64)
        self._pool_b = np.zeros(n, np.int64)
        for r in range(n):
            _, off = streams[int(t.user_raw[r])]
            pos = min(int(t.position[r]), len(off) - 1)
            lo = max(0, pos - hm)
            self._pool_a[r] = off[lo]
            self._pool_b[r] = off[pos]

    def row_pool(self, r: int) -> np.ndarray:
        """The exact (pre-draw) candidate pool of table row ``r``: history
        window played lines then warm-up lines, reference order
        (dataloader_SegMM.py:319-341). Draws in ``_assemble`` subsample this
        without materializing it."""
        if self._photo_tab is None:
            self._build_row_tables()
        uid = int(self.table.user_raw[r])
        stream, _ = self._user_streams[uid]
        a, b = int(self._pool_a[r]), int(self._pool_b[r])
        return np.concatenate([stream[a:b], self._warmup_lines(uid)])

    def __len__(self) -> int:
        n = len(self.table)
        if self.pad_final:
            return -(-n // self.batch_size)
        return n // self.batch_size

    # ------------------------------------------------------------------
    def _warmup_lines(self, uid: int) -> np.ndarray:
        if uid not in self._warmup_cache:
            frames = self.reader.user_input_dict.get(str(int(uid)), [])
            self._warmup_cache[uid] = self.store.warmup_line_ids(frames)
        return self._warmup_cache[uid]

    def _assemble(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        t = self.table
        n_real = len(idx)
        B = self.batch_size if self.pad_final else n_real
        batch: Dict[str, np.ndarray] = {}

        label = np.full((B, MAX_SEGMENTS), -2, dtype=np.int32)
        label[:n_real] = t.labels[idx]
        uid = np.zeros(B, np.int32)
        uid[:n_real] = t.user_idx[idx]
        iid = np.zeros(B, np.int32)
        iid[:n_real] = t.item_idx[idx]
        row_mask = np.zeros(B, bool)
        row_mask[:n_real] = True

        batch["label"] = label
        batch["user_identity_id"] = uid
        batch["photo_identity_id"] = iid
        # segment-count fields for the watch-time tasks
        # (dataloader_SegMM.py:296: int(play/5000), int(duration/5000))
        play_time = np.zeros(B, np.int32)
        play_time[:n_real] = (t.playing_time[idx] // 5000).astype(np.int32)
        duration_seg = np.zeros(B, np.int32)
        duration_seg[:n_real] = (t.duration_ms[idx] // 5000).astype(np.int32)
        batch["play_time"] = play_time
        batch["duration"] = duration_seg
        batch["vid_mask"] = label != -2
        batch["row_mask"] = row_mask
        # host-side metadata (cold/hot splits, logit export keys)
        batch["user_raw"] = np.concatenate(
            [t.user_raw[idx], np.zeros(B - n_real, np.int64)])
        batch["video_raw"] = np.concatenate(
            [t.video_raw[idx], np.zeros(B - n_real, np.int64)])
        batch["time_ms"] = np.concatenate(
            [t.time_ms[idx], np.zeros(B - n_real, np.int64)])

        if self.store is not None:
            if self._photo_tab is None:
                self._build_row_tables()
            photo_lines = np.full((B, MAX_SEGMENTS), -1, np.int32)
            photo_lines[:n_real] = self._photo_tab[idx]
            user_lines = np.full((B, self.user_max), -1, np.int32)
            user_mask = np.zeros((B, self.user_max), bool)
            for bi, ri in enumerate(idx):
                uid = int(t.user_raw[ri])
                stream, _ = self._user_streams[uid]
                a, b = int(self._pool_a[ri]), int(self._pool_b[ri])
                warm = self._warmup_lines(uid)
                nh, nw = b - a, len(warm)
                L = nh + nw
                if L > self.user_max:
                    # random.sample-style draw (dataloader_SegMM.py:347):
                    # unsorted indices into the virtual [history|warmup]
                    # concat; mapped without materializing the pool
                    pick = self.rng.choice(L, self.user_max, replace=False)
                    if nh == 0:
                        sel = warm[pick]
                    elif nw == 0:
                        sel = stream[a + pick]
                    else:
                        sel = np.where(
                            pick < nh,
                            stream[a + np.minimum(pick, nh - 1)],
                            warm[np.maximum(pick - nh, 0)])
                    m = self.user_max
                else:
                    sel = np.concatenate([stream[a:b], warm])
                    m = L
                user_lines[bi, :m] = sel
                user_mask[bi, :m] = True
            batch["photo_lines"] = photo_lines
            batch["user_lines"] = user_lines
            batch["user_mask"] = user_mask
        else:
            # ID mode: the user stream is the single id token; the model
            # forces its mask to ones (segformerx.py rank-1 path)
            batch["user_mask"] = np.ones((B, 1), bool)
        return batch

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.table))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            if len(idx) < bs and not self.pad_final:
                return
            batch = self._assemble(idx)
            yield self.transform(batch) if self.transform else batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch_size > 0:
            return prefetch(self._batches(), self.prefetch_size)
        return self._batches()
