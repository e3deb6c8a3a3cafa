"""Synthetic SegMM-shaped data made from a seed: an interaction CSV with the
columns of the published sample (``user_id, photo_id, time_ms,
duration_ms, playing_time``, reader.py:54-79) and a lineid map that covers
every (video, segment) a reader can request, strided across a feature table
of ``n_lines`` rows as bench.py:181-218 does."""

from __future__ import annotations

import csv
from typing import Dict, Optional

import numpy as np

from .reader import SeqReader


def write_synthetic_csv(path: str, n_users: int = 12,
                        per_user: tuple = (40, 60), n_videos: int = 300,
                        seed: int = 0) -> str:
    """Interactions of ``n_users`` users with ``per_user`` (lo, hi) rows
    each, rows shuffled. Times come from a narrow range so that ties occur
    (the reader's sorts must be stable); durations span 1..40 segments."""
    rng = np.random.default_rng(seed)
    uids = rng.choice(np.arange(10_000, 10_000 + 50 * n_users), n_users,
                      replace=False)
    vids = rng.choice(np.arange(500_000, 500_000 + 20 * n_videos), n_videos,
                      replace=False)
    rows = []
    for u in uids:
        n = int(rng.integers(per_user[0], per_user[1] + 1))
        t0 = 1_600_000_000_000 + int(rng.integers(0, 10_000_000))
        times = t0 + 1000 * rng.integers(0, max(2, n // 2), size=n)
        for t in times:
            dur = int(rng.integers(3_000, 200_001))
            play = int(rng.integers(1, int(dur * 1.3)))
            rows.append((int(u), int(rng.choice(vids)), int(t), dur, play))
    order = rng.permutation(len(rows))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["user_id", "photo_id", "time_ms", "duration_ms",
                    "playing_time"])
        for i in order:
            w.writerow(rows[i])
    return path


def synthetic_lineid_map(reader: SeqReader,
                         n_lines: Optional[int] = None) -> Dict[str, int]:
    """"{photo}-{frame}" -> line over every segment the reader's tables and
    warm-up pools can request, strided across ``n_lines`` table rows
    (default: one row per segment, the layout ``FeatureStore.open``
    expects of a memmap)."""
    need: Dict[int, int] = {}
    for t in reader.tables.values():
        if not len(t):
            continue
        n_frames = (t.labels != -2).sum(1)
        durs = -(-t.duration_ms // 5000)
        for vid, nf, d in zip(t.video_raw, n_frames, durs):
            need[int(vid)] = max(need.get(int(vid), 0), int(nf), int(d))
    for frames in reader.user_input_dict.values():
        for pf in frames:
            pid_s, frame_s = pf.split("_")
            pid, fi = int(pid_s), int(frame_s)
            need[pid] = max(need.get(pid, 0), fi + 1)
    total = sum(need.values())
    n_lines = total if n_lines is None else n_lines
    stride = max(1, n_lines // max(1, total))
    lineid_map: Dict[str, int] = {}
    line = 0
    for pid, n in need.items():
        for f in range(n):
            lineid_map[f"{pid}-{f}"] = (line * stride) % n_lines
            line += 1
    return lineid_map
