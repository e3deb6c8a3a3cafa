"""The segment leave-label codec — the framework's executable data spec.

Behavioral spec: reference data_process/get_data_SegMM_public.py:45-89
(construct_label_1D) and
reference MMinterest/utils/dataloader_SegMM.py:213-215,240-249
(frame-id calculation and padding).

A video of ``duration_ms`` is cut into 5-second segments; a view of
``playing_time`` ms produces a label vector of length ceil(duration/5000):

    1   watched segment (before the leave segment)
    0   the segment at which the user left
    -1  unwatched segment (after the leave)
    -2  padding (appended up to MAX_SEGMENTS by the loader)

A completed view (playing_time >= duration_ms) is all 1s (no leave slot).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

SEGMENT_MS = 5000
MAX_SEGMENTS = 40
PAD_VALUE = -2


def frame_count(duration_ms: float) -> int:
    """Number of 5 s segments: len(range(0, int(duration_ms), 5000))."""
    d = int(duration_ms)
    return max(0, -(-d // SEGMENT_MS))


def construct_label_1d(duration_ms: float, playing_time: float) -> np.ndarray:
    """Unpadded label vector for one interaction (spec lines 58-79).

    Requires playing_time > 0 and 0 < duration_ms (the reference filters
    these out upstream, get_data_SegMM_public.py:51-55).
    """
    size = frame_count(duration_ms)
    if playing_time >= duration_ms:
        return np.full(size, 1, dtype=np.int64)
    label = np.full(size, -1, dtype=np.int64)
    # reference: play = [int(i/1000) for i in range(0, int(playing_time), 5000)]
    # -> leave = play[-1] / 5 = (number of started segments) - 1
    n_started = max(1, -(-int(playing_time) // SEGMENT_MS))
    leave = min(n_started - 1, size - 1)
    label[leave] = 0
    label[:leave] = 1
    return label


def parse_label_1d(label_str: str) -> List[int]:
    """Parse the CSV string form ``[ 1  1  0 -1]``
    (dataloader_SegMM.py:240-243)."""
    body = label_str.strip().strip("[").strip("]")
    return [int(tok) for tok in body.split(" ") if tok.strip()]


def pad_label(label: Sequence[int], max_length: int = MAX_SEGMENTS,
              pad_value: int = PAD_VALUE) -> np.ndarray:
    """Truncate/pad to max_length (dataloader_SegMM.py:244-249)."""
    label = list(label)
    if len(label) >= max_length:
        return np.asarray(label[:max_length], dtype=np.int64)
    return np.asarray(label + [pad_value] * (max_length - len(label)),
                      dtype=np.int64)
