"""Interaction readers: CSV splits -> fixed-shape numpy tables + histories
(port of ``segmminterest_tpu/data/reader.py`` without pandas or
scikit-learn).

Behavioral spec:
 * reference MMinterest/utils/dataloader_SegMM.py:41-149 (per-split
   csv, merge-sort history positions, history_max truncation, dense
   second_map id remapping :207-210).
 * reference data_process/get_data_SegMM_public.py:119-162 (per-user
   split: small users dropped, first 80 interactions -> warm-up pool,
   remainder split by a seeded train_test_split; dense 1-based id maps).

The JAX reader's pandas and scikit-learn calls are reproduced exactly:
multi-column ``sort_values`` is a stable lexicographic sort
(``np.lexsort``), ``groupby`` walks keys in ascending order keeping row
order inside a group, and ``train_test_split(test_size=0.1,
random_state=seed)`` takes ``n_test = ceil(0.1 n)`` rows, then
``n - n_test`` rows, from ``RandomState(seed).permutation(n)`` in permuted
order.
"""

from __future__ import annotations

import csv
import json
import math
import os.path as osp
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .labels import MAX_SEGMENTS, construct_label_1d, pad_label, parse_label_1d

SPLIT_SEED = 2024  # get_data_SegMM_public.py:43
NUM_WARMUP = 80    # :121
MIN_INTERACTIONS = 100  # :129

# a split frame: column name -> numpy array (all columns the same length)
Frame = Dict[str, np.ndarray]


@dataclass
class InteractionTable:
    """One split, fully tensorized."""
    user_raw: np.ndarray      # (N,) raw user ids
    video_raw: np.ndarray     # (N,) raw video ids
    time_ms: np.ndarray       # (N,)
    duration_ms: np.ndarray   # (N,)
    playing_time: np.ndarray  # (N,)
    labels: np.ndarray        # (N, MAX_SEGMENTS) int32, padded with -2
    user_idx: np.ndarray      # (N,) dense 1-based identity ids
    item_idx: np.ndarray      # (N,) dense 1-based identity ids
    position: np.ndarray      # (N,) index into the user's chronological seq

    def __len__(self) -> int:
        return len(self.user_raw)


# ---------------------------------------------------------------------------
# frames: a dict of equal-length numpy columns
# ---------------------------------------------------------------------------

_FLOAT = re.compile(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?")
# the powers of ten of pandas' parser, each the double nearest 10**i
_POW10 = [float(f"1e{i}") for i in range(309)]


def pandas_float(text: str) -> float:
    """A float as ``pd.read_csv``'s default parser reads it (pandas
    tokenizer.c ``precise_xstrtod``): at most 17 digits, the rest dropped,
    accumulated in a double, then one multiply or divide by a power of
    ten. Past 2**53 this may differ from ``float(text)`` in the last bit;
    with at most 15 digits and no exponent the digits and the power of ten
    are doubles exactly, the one rounding is correct, and ``float`` gives
    the same bits faster."""
    if len(text) <= 15 or (len(text) == 16 and "." in text):
        if "e" not in text and "E" not in text:
            return float(text)
    return xstrtod(text)


def xstrtod(text: str) -> float:
    """``precise_xstrtod`` digit by digit (:func:`pandas_float` without its
    fast path)."""
    m = _FLOAT.fullmatch(text.strip())
    if not m or not (m.group(2) or m.group(3)):
        return float(text)  # inf, infinity, or not a number: raises
    sign, whole, frac, exp = m.groups()
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in (frac or "")[:max(0, 17 - digits)]:
        number = number * 10.0 + (ord(ch) - 48)
        exponent -= 1
    if sign == "-":
        number = -number
    exponent += int(exp) if exp else 0
    if exponent > 308:
        return float(text)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _column(values: List[str]) -> np.ndarray:
    """Numeric columns as int64 (float64, parsed as pandas parses them, when
    any value is not an integer or a cell is empty, which is NaN), anything
    else as strings — the types ``pd.read_csv`` infers here."""
    try:
        return np.asarray([int(v) for v in values], np.int64)
    except ValueError:
        pass
    try:
        return np.asarray([pandas_float(v) if v else math.nan
                           for v in values], np.float64)
    except ValueError:
        return np.asarray(values, dtype=object)


def read_csv(path: str, sep: str = ",") -> Frame:
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter=sep))
    if not rows:
        return {}
    header, body = rows[0], rows[1:]
    return {name: _column([r[i] for r in body])
            for i, name in enumerate(header)}


def _csv_cells(values: np.ndarray) -> list:
    """One column as ``DataFrame.to_csv`` writes it: floats by numpy's
    shortest repr (NaN empty), anything else by ``str``."""
    if values.dtype.kind == "f":
        cells = values.astype(str).astype(object)
        cells[np.isnan(values)] = ""
        return cells.tolist()
    return values.tolist()


def write_csv(df: Frame, path: str, sep: str = "\t") -> str:
    """``pd.DataFrame(df).to_csv(path, sep=sep, index=False)``, byte for
    byte: the same ``csv`` writer settings (minimal quoting, ``\\n``
    lines)."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        if not df:  # a frame without columns is one empty line
            f.write("\n")
            return path
        w = csv.writer(f, delimiter=sep, lineterminator="\n", quotechar='"',
                       doublequote=True, quoting=csv.QUOTE_MINIMAL)
        w.writerow(list(df))
        w.writerows(zip(*(_csv_cells(np.asarray(v)) for v in df.values())))
    return path


def frame_len(df: Frame) -> int:
    return len(next(iter(df.values()))) if df else 0


def take(df: Frame, idx) -> Frame:
    return {k: v[idx] for k, v in df.items()}


def concat(frames: List[Frame]) -> Frame:
    frames = [f for f in frames if frame_len(f)]
    if not frames:
        return {}
    return {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}


def groups(keys: np.ndarray):
    """``groupby`` order: (key, row indices) for keys ascending, rows in
    frame order."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    bounds = np.flatnonzero(np.diff(sk)) + 1
    for chunk in np.split(order, bounds):
        if len(chunk):
            yield keys[chunk[0]], chunk


def normalize_columns(df: Frame) -> Frame:
    """Unify the SegMM / KuaiRand column dialects
    (dataloader_SegMM.py:73 'playing_time_x' vs dataloader_KuaiRand.py:73
    'play_time_ms_x'): photo_id -> video_id, play_time_ms -> playing_time."""
    renames = {}
    if "photo_id" in df and "video_id" not in df:
        renames["photo_id"] = "video_id"
    for cand in ("play_time_ms", "playing_time_x", "play_time_ms_x"):
        if cand in df and "playing_time" not in df \
                and "playing_time" not in renames.values():
            renames[cand] = "playing_time"
    # renamed in place, as DataFrame.rename keeps the column order
    return {renames.get(k, k): v for k, v in df.items()}


def _labels_from_df(df: Frame) -> np.ndarray:
    n = frame_len(df)
    out = np.full((n, MAX_SEGMENTS), -2, dtype=np.int32)
    if "label_1D" in df:
        for i, s in enumerate(df["label_1D"]):
            out[i] = pad_label(parse_label_1d(str(s)))
    else:
        dur, play = df["duration_ms"], df["playing_time"]
        for i in range(n):
            out[i] = pad_label(construct_label_1d(dur[i], play[i]))
    return out


def train_test_split_indices(n: int, seed: int, test_size: float = 0.1
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) positions of sklearn's ``train_test_split(range(n),
    test_size=test_size, random_state=seed)``."""
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(f"with n_samples={n} and test_size={test_size} "
                         "the train set would be empty")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:n_test + n_train], perm[:n_test]


def split_interactions(df: Frame, seed: int = SPLIT_SEED,
                       num_warmup: int = NUM_WARMUP,
                       min_interactions: int = MIN_INTERACTIONS
                       ) -> Dict[str, Frame]:
    """Per-user warm-up/train/dev/test split (get_data_SegMM_public.py:119-149)."""
    df = take(df, np.lexsort((df["time_ms"], df["user_id"])))
    parts: Dict[str, List[Frame]] = {k: [] for k in
                                     ("input", "train", "dev", "test")}
    sizes = []
    for _, rows in groups(df["user_id"]):
        sizes.append(len(rows))
        if len(rows) < min_interactions:
            continue
        parts["input"].append(take(df, rows[:num_warmup]))
        remaining = rows[num_warmup:]
        tr, te = train_test_split_indices(len(remaining), seed)
        train_valid = remaining[tr]
        tr2, va = train_test_split_indices(len(train_valid), seed)
        parts["train"].append(take(df, train_valid[tr2]))
        parts["dev"].append(take(df, train_valid[va]))
        parts["test"].append(take(df, remaining[te]))
    if not parts["train"]:
        raise ValueError(
            f"no user passed the min_interactions={min_interactions} filter "
            f"({len(sizes)} users, largest has {max(sizes, default=0)} "
            "interactions) — lower --min_interactions/--num_warmup for small "
            "datasets")
    return {k: concat(v) for k, v in parts.items()}


def warmup_dict(warm: Frame) -> Dict[str, List[str]]:
    """The warm-up dict: uid -> ["{photo}_{frame}" ...] over the played
    segments of the user's warm-up interactions, users ascending
    (get_data_SegMM_public.py:104-114)."""
    out: Dict[str, List[str]] = {}
    if not frame_len(warm):
        return out
    for uid, rows in groups(warm["user_id"]):
        frames = []
        for r in rows:
            playing = min(warm["playing_time"][r], warm["duration_ms"][r])
            n = max(0, -(-int(playing) // 5000))
            pid = str(int(warm["video_id"][r]))
            frames.extend(f"{pid}_{i}" for i in range(n))
        out[str(int(uid))] = frames
    return out


def dense_id_maps(dfs: List[Frame], user_col="user_id", item_col="video_id"
                  ) -> Tuple[Dict[int, int], Dict[int, int]]:
    """1-based dense maps over sorted unique raw ids
    (get_data_SegMM_public.py:151-162)."""
    dfs = [d for d in dfs if frame_len(d)]
    uids = np.unique(np.concatenate([d[user_col] for d in dfs]))
    iids = np.unique(np.concatenate([d[item_col] for d in dfs]))
    user2id = {int(u): i for i, u in enumerate(uids, start=1)}
    item2id = {int(v): i for i, v in enumerate(iids, start=1)}
    return user2id, item2id


def _empty_table() -> InteractionTable:
    return InteractionTable(*[np.zeros(0)] * 5,
                            np.zeros((0, MAX_SEGMENTS), np.int32),
                            np.zeros(0, np.int32), np.zeros(0, np.int32),
                            np.zeros(0, np.int32))


class SeqReader:
    """Loads {train,dev,test} interaction splits and builds user histories.

    * ``SeqReader.from_dir(path)`` — pre-split ``{train,dev,test}.csv``
      (tab-separated, reference layout), optional ``user_input_dict.json``
      and ``second_map_{user,item}2id.json``.
    * ``SeqReader.from_single_csv(path)`` — a raw interaction csv; performs
      the reference per-user split and derives warm-up dict + id maps.
    """

    def __init__(self, split_dfs: Dict[str, Frame],
                 user2id: Dict[int, int], item2id: Dict[int, int],
                 user_input_dict: Optional[Dict[str, List[str]]] = None,
                 history_max: int = 50):
        self.history_max = history_max
        self.user2id = user2id
        self.item2id = item2id
        self.user_input_dict = user_input_dict or {}
        self.n_users = max(user2id.values()) if user2id else 0
        self.n_items = max(item2id.values()) if item2id else 0

        # ---- global chronological history (dataloader_SegMM.py:113-134) ----
        all_df = concat([{k: split_dfs[s][k] for k in
                          ("user_id", "video_id", "time_ms", "playing_time")}
                         for s in ("train", "dev", "test")
                         if frame_len(split_dfs[s])])
        sort_df = take(all_df, np.lexsort((all_df["user_id"],
                                           all_df["time_ms"])))
        position = np.zeros(frame_len(sort_df), np.int64)
        self.user_his_items: Dict[int, np.ndarray] = {}
        self.user_his_playing: Dict[int, np.ndarray] = {}
        for uid, rows in groups(sort_df["user_id"]):
            position[rows] = np.arange(len(rows))
            self.user_his_items[int(uid)] = sort_df["video_id"][rows]
            self.user_his_playing[int(uid)] = sort_df["playing_time"][rows]

        # position of each (user, video, time): its first row in sorted order
        # (the left merge + keep-first of the JAX reader)
        first_pos: Dict[tuple, int] = {}
        for u, v, t, p in zip(sort_df["user_id"].tolist(),
                              sort_df["video_id"].tolist(),
                              sort_df["time_ms"].tolist(), position.tolist()):
            first_pos.setdefault((u, v, t), p)

        self.tables: Dict[str, InteractionTable] = {}
        for key in ("train", "dev", "test"):
            df = split_dfs[key]
            if not frame_len(df):
                self.tables[key] = _empty_table()
                continue
            seen = set()
            keep, pos = [], []
            for i, k in enumerate(zip(df["user_id"].tolist(),
                                      df["video_id"].tolist(),
                                      df["time_ms"].tolist())):
                if k in seen:
                    continue
                seen.add(k)
                keep.append(i)
                pos.append(first_pos.get(k, 0))
            df = take(df, np.asarray(keep, np.int64))
            self.tables[key] = InteractionTable(
                user_raw=df["user_id"].astype(np.int64),
                video_raw=df["video_id"].astype(np.int64),
                time_ms=df["time_ms"].astype(np.int64),
                duration_ms=df["duration_ms"].astype(np.int64),
                playing_time=df["playing_time"].astype(np.int64),
                labels=_labels_from_df(df),
                user_idx=np.asarray(
                    [self.user2id.get(int(u), 0) for u in df["user_id"]],
                    np.int32),
                item_idx=np.asarray(
                    [self.item2id.get(int(v), 0) for v in df["video_id"]],
                    np.int32),
                position=np.asarray(pos, np.int64),
            )

    # ------------------------------------------------------------------
    @classmethod
    def from_dir(cls, path: str, sep: str = "\t", history_max: int = 50,
                 dict_path: str = "user_input_dict.json") -> "SeqReader":
        split_dfs = {key: normalize_columns(
            read_csv(osp.join(path, key + ".csv"), sep=sep))
            for key in ("train", "dev", "test")}
        user_input_dict = None
        p = osp.join(path, dict_path)
        if osp.exists(p):
            with open(p) as f:
                user_input_dict = json.load(f)
        u_map_p = osp.join(path, "second_map_user2id.json")
        i_map_p = osp.join(path, "second_map_item2id.json")
        if osp.exists(u_map_p) and osp.exists(i_map_p):
            with open(u_map_p) as f:
                user2id = {int(k): v for k, v in json.load(f).items()}
            with open(i_map_p) as f:
                item2id = {int(k): v for k, v in json.load(f).items()}
        else:
            user2id, item2id = dense_id_maps(list(split_dfs.values()))
        return cls(split_dfs, user2id, item2id, user_input_dict, history_max)

    @classmethod
    def from_single_csv(cls, path: str, sep: str = ",", history_max: int = 50,
                        min_interactions: int = MIN_INTERACTIONS,
                        num_warmup: int = NUM_WARMUP) -> "SeqReader":
        df = normalize_columns(read_csv(path, sep=sep))
        parts = split_interactions(df, num_warmup=num_warmup,
                                   min_interactions=min_interactions)
        user_input_dict = warmup_dict(parts["input"])
        user2id, item2id = dense_id_maps(
            [parts[k] for k in ("input", "train", "dev", "test")])
        return cls({k: parts[k] for k in ("train", "dev", "test")},
                   user2id, item2id, user_input_dict, history_max)
