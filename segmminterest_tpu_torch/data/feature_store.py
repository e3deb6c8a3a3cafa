"""Segment CLIP-feature store: memmap + id maps -> device-side gather tables
(port of ``segmminterest_tpu/data/feature_store.py``; host-only numpy).

Behavioral spec: reference MMinterest/main_for_seq_leave_earlystop_SegMM.py:35-40
(np.memmap (N, 1024) float32 + "{photo_id}-{segment_idx}" -> line json) and
reference MMinterest/utils/dataloader_SegMM.py:302-352 (per-sample
gathers for the video stream and the user history/warm-up stream).

The dict is pre-baked once into per-photo line-id arrays; batch assembly
produces int32 index tensors, and the feature table lives in device memory
(engine/train.py), so the feature gather is one index op on the card — the
host ships indices, not features.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

from .labels import SEGMENT_MS


class FeatureStore:
    def __init__(self, feat: np.ndarray, lineid_map: Dict[str, int]):
        """feat: (total_lines, feat_dim) array or memmap; lineid_map:
        "{photo_id}-{frame_idx}" -> line id."""
        self.feat = feat
        self.feat_dim = feat.shape[1]
        # pre-bake: pid -> int32 array of line ids indexed by frame
        photo_frames: Dict[int, Dict[int, int]] = {}
        for key, line in lineid_map.items():
            pid_s, frame_s = key.rsplit("-", 1)
            photo_frames.setdefault(int(pid_s), {})[int(frame_s)] = int(line)
        self.photo_lines: Dict[int, np.ndarray] = {}
        for pid, frames in photo_frames.items():
            n = max(frames) + 1
            arr = np.full(n, -1, dtype=np.int32)
            for f, line in frames.items():
                arr[f] = line
            self.photo_lines[pid] = arr

    @classmethod
    def open(cls, memmap_path: str, lineid_map_path: str,
             feat_dim: int = 1024) -> "FeatureStore":
        with open(lineid_map_path) as f:
            lineid_map = json.load(f)
        total = len(lineid_map)
        feat = np.memmap(memmap_path, dtype="float32", mode="r",
                         shape=(total, feat_dim))
        return cls(feat, lineid_map)

    # ------------------------------------------------------------------
    def photo_line_ids(self, pid: int, n_frames: int,
                       strict: bool = True) -> np.ndarray:
        """Line ids for the first n_frames segments of a photo; raises on a
        missing key like the reference video path (dataloader_SegMM.py:305-308).
        With ``strict`` False (SegRec's candidates) a missing photo gives no
        lines and a missing segment -1."""
        lines = self.photo_lines.get(int(pid))
        if lines is None or len(lines) < n_frames or \
                (n_frames and (lines[:n_frames] < 0).any()):
            if strict:
                raise KeyError(f"No key in lineid dict for photo {pid} "
                               f"up to frame {n_frames - 1}")
            lines = lines if lines is not None else np.zeros(0, np.int32)
        return lines[:n_frames]

    def played_line_ids(self, pid: int, playing_ms: float) -> np.ndarray:
        """Line ids for the segments actually played of a history item;
        silently skips missing keys (dataloader_SegMM.py:322-331)."""
        lines = self.photo_lines.get(int(pid))
        if lines is None:
            return np.zeros(0, np.int32)
        n = max(0, -(-int(playing_ms) // SEGMENT_MS))
        out = lines[:min(n, len(lines))]
        return out[out >= 0]

    def warmup_line_ids(self, frames) -> np.ndarray:
        """Line ids for "{photo}_{frame}" warm-up entries; missing keys are
        skipped (dataloader_SegMM.py:333-341)."""
        out = []
        for pf in frames:
            pid_s, frame_s = pf.split("_")
            lines = self.photo_lines.get(int(pid_s))
            fi = int(frame_s)
            if lines is not None and fi < len(lines) and lines[fi] >= 0:
                out.append(lines[fi])
        return np.asarray(out, dtype=np.int32)
