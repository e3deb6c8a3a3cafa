"""SegRec corpus readers (port of ``segmminterest_tpu/segrec/corpus.py``
without pandas; host-only numpy).

Behavioral spec: reference SegRec/helpers/{BaseReader,SeqReader,
ContextReader,ContextSeqReader}.py:
 * BaseReader: {train,dev,test}.csv with columns user_id, item_id, time
   [, label][, neg_items list-string][, c_* situation columns];
   n_users/n_items = max id + 1; per-user clicked sets (train vs residual).
 * SeqReader: global (time, user) stable sort -> per-interaction position
   into the user's chronological sequence.
 * ContextReader: item_meta.csv / user_meta.csv with i_* / u_* features;
   ``i_duration`` converted to a segment count (:func:`calculate_frame_ids`);
   ``feature_max`` per feature for embedding sizes.
 * ContextSeqReader: history positions + historical situations.

The splits are frames of numpy columns (``data/reader.py``'s ``read_csv``)
with the dtypes ``pd.read_csv`` gives them: integer columns int64, a column
with a fraction or an empty cell float64. pandas' multi-column
``sort_values`` is a stable lexicographic sort, its ``groupby`` walks the
keys ascending keeping row order.
"""

from __future__ import annotations

import ast
import logging
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from ..data.reader import Frame, concat, groups, read_csv, take

logger = logging.getLogger(__name__)

SPLITS = ("train", "dev", "test")


def _parse_list_column(values: np.ndarray) -> np.ndarray:
    """ReChorus stores neg_items as a python-list string per row
    (utils.eval_list_columns)."""
    rows = [np.asarray(ast.literal_eval(s) if isinstance(s, str) else s,
                       dtype=np.int64)
            for s in values]
    lens = {len(r) for r in rows}
    if len(lens) == 1:
        return np.stack(rows)
    # ragged (not in the published datasets) -> pad with 0
    m = max(lens)
    out = np.zeros((len(rows), m), np.int64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def calculate_frame_ids(duration_ms: float) -> int:
    """Segment count from duration (SegRec/utils/utils.py:calculate_frame_ids)."""
    return len(range(0, int(duration_ms), 5000))


def _sort(df: Frame, keys: List[str]) -> Frame:
    """``df.sort_values(by=keys)``: stable, the first key most significant."""
    return take(df, np.lexsort([df[k] for k in reversed(keys)]))


class Corpus:
    def __init__(self, path: str, dataset: str, sep: str = "\t",
                 include_item_features: bool = True,
                 include_user_features: bool = True,
                 include_situation_features: bool = True):
        self.prefix = path
        self.dataset = dataset
        self.sep = sep
        base = osp.join(path, dataset)

        self.data_df: Dict[str, Frame] = {}
        self.neg_items: Dict[str, Optional[np.ndarray]] = {}
        for key in SPLITS:
            df = _sort(read_csv(osp.join(base, key + ".csv"), sep=sep),
                       ["user_id", "time"])
            self.neg_items[key] = (_parse_list_column(df["neg_items"])
                                   if "neg_items" in df else None)
            self.data_df[key] = df

        key_columns = ["user_id", "item_id", "time"]
        self.has_label = "label" in self.data_df["train"]
        if self.has_label:
            key_columns.append("label")
        self.all_df = concat([{c: self.data_df[k][c] for c in key_columns}
                              for k in SPLITS])
        self.n_users = int(self.all_df["user_id"].max()) + 1
        max_item = int(self.all_df["item_id"].max())
        # frame-as-item datasets can carry candidate/meta ids that never
        # appear as interaction targets (leave frames nobody watched)
        for key in ("dev", "test"):
            if self.neg_items[key] is not None and len(self.neg_items[key]):
                max_item = max(max_item, int(self.neg_items[key].max()))
        self.n_items = max_item + 1
        logger.info('"# user": %d, "# item": %d, "# entry": %d',
                    self.n_users - 1, self.n_items - 1,
                    len(self.all_df["user_id"]))

        # clicked sets (BaseReader:30-41)
        self.train_clicked_set: Dict[int, set] = {}
        self.residual_clicked_set: Dict[int, set] = {}
        for key in SPLITS:
            df = self.data_df[key]
            for uid, iid in zip(df["user_id"].tolist(),
                                df["item_id"].tolist()):
                self.train_clicked_set.setdefault(uid, set())
                self.residual_clicked_set.setdefault(uid, set())
                if key == "train":
                    self.train_clicked_set[uid].add(iid)
                else:
                    self.residual_clicked_set[uid].add(iid)

        # ---- context features (ContextReader) ----
        self.situation_feature_names: List[str] = sorted(
            c for c in self.data_df["train"] if c[:2] == "c_"
        ) if include_situation_features else []
        self.item_feature_names: List[str] = []
        self.user_feature_names: List[str] = []
        self.item_features_arr: Dict[str, np.ndarray] = {}
        self.user_features_arr: Dict[str, np.ndarray] = {}
        self.feature_max: Dict[str, int] = {
            "user_id": self.n_users, "item_id": self.n_items}

        item_meta_path = osp.join(base, "item_meta.csv")
        if include_item_features and osp.exists(item_meta_path):
            meta = read_csv(item_meta_path, sep=sep)
            self.item_feature_names = sorted(
                c for c in meta if c[:2] == "i_")
            if "i_duration" in meta:
                meta["i_duration"] = np.asarray(
                    [calculate_frame_ids(d) for d in meta["i_duration"]],
                    np.int64)
            # dense per-item lookup arrays indexed by item_id
            self.n_items = max(self.n_items, int(meta["item_id"].max()) + 1)
            self.feature_max["item_id"] = self.n_items
            for f in self.item_feature_names:
                arr = np.zeros(self.n_items, np.float64)
                arr[meta["item_id"]] = meta[f]
                self.item_features_arr[f] = arr
                self.feature_max[f] = int(arr.max()) + 1
        user_meta_path = osp.join(base, "user_meta.csv")
        if include_user_features and osp.exists(user_meta_path):
            meta = read_csv(user_meta_path, sep=sep)
            self.user_feature_names = sorted(
                c for c in meta if c[:2] == "u_")
            for f in self.user_feature_names:
                arr = np.zeros(self.n_users, np.float64)
                arr[meta["user_id"]] = meta[f]
                self.user_features_arr[f] = arr
                self.feature_max[f] = int(arr.max()) + 1
        for f in self.situation_feature_names:
            self.feature_max[f] = int(
                max(self.data_df[k][f].max() for k in SPLITS)) + 1

        # ---- history (SeqReader._append_his_info) ----
        # all splits with their origin, stably sorted by (time, user),
        # counted within user, positions scattered back by origin — exact
        # even with duplicated (user, item, time) rows
        cols = ["user_id", "item_id", "time"] + list(
            self.situation_feature_names)
        cat = concat([
            {**{c: self.data_df[k][c] for c in cols},
             "phase": np.full(len(self.data_df[k]["user_id"]), i),
             "row": np.arange(len(self.data_df[k]["user_id"]))}
            for i, k in enumerate(SPLITS)])
        cat = _sort(cat, ["time", "user_id"])
        position = np.zeros(len(cat["user_id"]), np.int64)
        self.user_his_items: Dict[int, np.ndarray] = {}
        self.user_his_times: Dict[int, np.ndarray] = {}
        # per-position situation values for add_historical_situations
        # (ContextSeqReader.py:18-42)
        self.user_his_situs: Dict[str, Dict[int, np.ndarray]] = {
            f: {} for f in self.situation_feature_names}
        for uid, rows in groups(cat["user_id"]):
            position[rows] = np.arange(len(rows))
            self.user_his_items[int(uid)] = cat["item_id"][rows]
            self.user_his_times[int(uid)] = cat["time"][rows]
            for f in self.situation_feature_names:
                self.user_his_situs[f][int(uid)] = cat[f][rows]
        for i, key in enumerate(SPLITS):
            sel = cat["phase"] == i
            pos = np.zeros(len(self.data_df[key]["user_id"]), np.int64)
            pos[cat["row"][sel]] = position[sel]
            self.data_df[key]["position"] = pos

    def history_slice(self, uid: int, position: int, history_max: int):
        items = self.user_his_items.get(int(uid))
        if items is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        lo = max(0, int(position) - history_max) if history_max > 0 else 0
        return (items[lo:int(position)],
                self.user_his_times[int(uid)][lo:int(position)])
