"""Build SegRec (Task-2) datasets from raw segment-interaction csvs (port of
``segmminterest_tpu/tasks/build_segrec_data.py`` without pandas: every file
it writes is byte for byte the JAX builder's).

Behavioral spec: reference data_process/KuaiRand.py:36-60+ (bucket CTR
labels: per duration-bucket median view-ratio threshold) and the ReChorus
dataset layout consumed by reference SegRec/helpers/BaseReader.py
({train,dev,test}.csv with user_id, item_id, time[, label][, neg_items] +
item_meta.csv with i_* features).

Produces:
  <out>/<name>_CTR/{train,dev,test}.csv + item_meta.csv   (CTR task)
  <out>/<name>/{train,dev,test}.csv + item_meta.csv       (ranking task,
        dev/test rows carry sampled neg_items)

  python -m segmminterest_tpu_torch.tasks.build_segrec_data \
      --inter_csv inter.csv --out data --name SegMM \
      --min_interactions 30 --num_warmup 10
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np

from ..data.reader import (Frame, concat, frame_len, groups,
                           normalize_columns, read_csv, split_interactions,
                           take, write_csv)


def qcut_codes(x: np.ndarray, q: int) -> np.ndarray:
    """``pd.qcut(x, q, duplicates="drop")``'s bucket of each value, -1 for
    none: edges at ``np.quantile`` of q + 1 levels (rounded up where not
    representable), duplicates dropped, buckets right-closed with the
    lowest edge included."""
    levels = np.linspace(0, 1, q + 1)
    np.putmask(levels, q * levels != np.arange(q + 1),
               np.nextafter(levels, 1))
    edges = np.unique(np.quantile(x[~np.isnan(x.astype(np.float64))],
                                  levels))
    ids = np.searchsorted(edges, x, side="left")
    ids[x == edges[0]] = 1
    ids = ids - 1
    ids[(ids < 0) | (ids >= len(edges) - 1)] = -1
    return ids


def bucket_ctr_labels(df: Frame, n_buckets: int = 10) -> np.ndarray:
    """label = view_ratio > median(view_ratio of same duration bucket)
    (data_process/KuaiRand.py bucket_label); the median of an even-sized
    bucket is the mean of its two middle values, NaN ratios skipped."""
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.minimum(df["playing_time"] / df["duration_ms"], 1.0)
    codes = qcut_codes(df["duration_ms"], n_buckets)
    medians = np.full(len(ratio), np.nan)
    for code, rows in groups(codes):
        vals = ratio[rows]
        vals = vals[~np.isnan(vals)]
        if code >= 0 and len(vals):
            medians[rows] = np.median(vals)
    with np.errstate(invalid="ignore"):
        return (ratio > medians).astype(np.int64)


def _next_watch(train: Frame, iids, max_tails: int):
    """Items that directly followed each item in some user's train
    sequence (time order, first max_tails distinct)."""
    succ = {}
    tr = take(train, np.lexsort((train["time_ms"], train["user_id"])))
    for _, rows in groups(tr["user_id"]):
        vids = [iids[int(v)] for v in tr["video_id"][rows]]
        for a, b in zip(vids[:-1], vids[1:]):
            if a != b:
                tails = succ.setdefault(a, [])
                if b not in tails and len(tails) < max_tails:
                    tails.append(b)
    return succ


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--inter_csv", type=str, required=True)
    p.add_argument("--sep", type=str, default=",")
    p.add_argument("--out", type=str, default="data")
    p.add_argument("--name", type=str, default="SegMM")
    p.add_argument("--min_interactions", type=int, default=100)
    p.add_argument("--num_warmup", type=int, default=80)
    p.add_argument("--n_eval_neg", type=int, default=99)
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--kg_meta", type=int, default=0,
                   help="derive KG relation columns for the knowledge-aware "
                        "family (KGReader.py item_meta contract): "
                        "r_next_watch = train-sequence successor items, "
                        "i_category = 30s duration buckets")
    p.add_argument("--kg_max_tails", type=int, default=10)
    args = p.parse_args(argv)

    df = normalize_columns(read_csv(args.inter_csv, sep=args.sep))
    parts = split_interactions(df, seed=args.seed,
                               num_warmup=args.num_warmup,
                               min_interactions=args.min_interactions)
    combined = concat([parts[k] for k in ("train", "dev", "test")])
    # dense 1-based ids like the reference second maps
    uids = {int(u): i for i, u in
            enumerate(np.unique(combined["user_id"]), 1)}
    vids, first = np.unique(combined["video_id"], return_index=True)
    iids = {int(v): i for i, v in enumerate(vids, 1)}
    n_items = len(iids) + 1

    rng = np.random.default_rng(args.seed)
    # dense -> raw id maps for the Task-1 logit bridge
    # (SegRec/models/BaseModel.py:132-136 id2user/id2item)
    id2user = {str(v): str(k) for k, v in uids.items()}
    id2item = {str(v): str(k) for k, v in iids.items()}

    # one row per video (its first row), in item-id order
    item_meta = {"item_id": np.arange(1, len(vids) + 1),
                 "i_duration": combined["duration_ms"][first]}
    item_meta_kg = item_meta
    if args.kg_meta:
        # r_next_watch: items that directly followed this item in some
        # user's TRAIN sequence (KGReader.py:37-46 consumes r_* columns)
        succ = _next_watch(parts["train"], iids, args.kg_max_tails)
        item_meta_kg = dict(item_meta)
        item_meta_kg["r_next_watch"] = np.asarray(
            [str(succ.get(int(i), [])) for i in item_meta["item_id"]],
            dtype=object)
        item_meta_kg["i_category"] = np.clip(
            item_meta["i_duration"] // 30000, 0, 9).astype(np.int64) + 1

    for task in ("CTR", "ranking"):
        name = f"{args.name}_CTR" if task == "CTR" else args.name
        base = osp.join(args.out, name)
        os.makedirs(base, exist_ok=True)
        for key in ("train", "dev", "test"):
            part = parts[key]
            out = {"user_id": np.asarray([uids[int(u)]
                                          for u in part["user_id"]]),
                   "item_id": np.asarray([iids[int(v)]
                                          for v in part["video_id"]]),
                   "time": part["time_ms"]}
            if task == "CTR":
                out["label"] = bucket_ctr_labels(part)
            elif key in ("dev", "test"):
                negs = rng.integers(1, n_items,
                                    size=(frame_len(part), args.n_eval_neg))
                out["neg_items"] = np.asarray(
                    [str(list(map(int, row))) for row in negs], dtype=object)
            write_csv(out, osp.join(base, key + ".csv"))
        # KG relation columns only in the ranking export (the KG family's
        # home); CTR context models keep the original feature set
        write_csv(item_meta if task == "CTR" else item_meta_kg,
                  osp.join(base, "item_meta.csv"))
        with open(osp.join(base, "id2user.json"), "w") as f:
            json.dump(id2user, f)
        with open(osp.join(base, "id2item.json"), "w") as f:
            json.dump(id2item, f)
        print(f"wrote {base} "
              f"({ {k: frame_len(parts[k]) for k in ('train', 'dev', 'test')} })")


if __name__ == "__main__":
    main()
