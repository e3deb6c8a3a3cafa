"""Build the SegMM/KuaiRand interaction dataset directory from raw logs
(port of ``segmminterest_tpu/tasks/build_interactions.py`` without pandas:
every file it writes is byte for byte the JAX builder's).

Behavioral spec: reference data_process/get_data_SegMM_public.py (D3)
and KuaiRand_data_preparation.py (D4):
 * filter play > 0, 0 < duration < 200 s; construct label_1D per interaction;
 * per-user split: first ``num_warmup`` interactions -> the warm-up
   ``user_input_dict`` (user-representation source), remainder 81/9/10
   train/dev/test via seeded train_test_split; users with fewer than
   ``min_interactions`` dropped;
 * dense 1-based ``second_map_{user,item}2id.json`` (+ reverse maps);
 * ``SegMM_ExposureProb.json``: P(exposed at segment i) from the play-time
   histogram (analysis_inter_playtime :214-231).

Writes the directory layout consumed by SeqReader.from_dir:
  <out>/{train,dev,test}.csv (tab-separated, with label_1D)
  <out>/user_input_dict.json, second_map_{user,item}2id.json,
        second_map_id2{user,item}.json, SegMM_ExposureProb.json

  python -m segmminterest_tpu_torch.tasks.build_interactions \
      --inter_csv raw.csv --out SegMM/
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np

from ..data.labels import construct_label_1d
from ..data.reader import (Frame, concat, frame_len, normalize_columns,
                           read_csv, split_interactions, take, warmup_dict,
                           write_csv)


def exposure_prob_table(play_ms: np.ndarray) -> dict:
    """P(exposed at segment i): fraction of interactions whose play time
    reaches past segment i (analysis_inter_playtime :214-231 — each play-time
    bucket [t, t+5s) counts toward every threshold <= t)."""
    thresholds = np.arange(0, 200, 5)
    play_s = play_ms / 1000.0
    bucket = np.clip((np.ceil(play_s / 5.0) - 1).astype(int), 0, 39)
    bucket_counts = np.bincount(bucket, minlength=40)
    # threshold t is credited by every bucket >= t
    cum_from_right = np.cumsum(bucket_counts[::-1])[::-1]
    return {str(int(thresholds[i])): float(cum_from_right[i] / len(play_ms))
            for i in range(40)}


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--inter_csv", type=str, required=True)
    p.add_argument("--sep", type=str, default=",")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--min_interactions", type=int, default=100)
    p.add_argument("--num_warmup", type=int, default=80)
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--dataset", type=str, default="SegMM",
                   choices=["SegMM", "KuaiRand"],
                   help="KuaiRand adds the is_click>0 filter and defaults to "
                        "min_interactions=20, num_warmup=0 "
                        "(KuaiRand_data_preparation.py)")
    args = p.parse_args(argv)
    if args.dataset == "KuaiRand":
        if args.min_interactions == 100:
            args.min_interactions = 20
        if args.num_warmup == 80:
            args.num_warmup = 0

    df: Frame = normalize_columns(read_csv(args.inter_csv, sep=args.sep))
    # filters (get_data_SegMM_public.py:51-55; KuaiRand adds is_click>0,
    # KuaiRand_data_preparation.py:21-64)
    if args.dataset == "KuaiRand" and "is_click" in df:
        df = take(df, np.flatnonzero(df["is_click"] > 0))
    df = take(df, np.flatnonzero((df["playing_time"] > 0)
                                 & (df["duration_ms"] > 0)
                                 & (df["duration_ms"] < 200000)))
    if "label_1D" not in df:
        df["label_1D"] = np.asarray(
            [np.array2string(construct_label_1d(d, t))
             for d, t in zip(df["duration_ms"], df["playing_time"])],
            dtype=object)

    parts = split_interactions(df, seed=args.seed,
                               num_warmup=args.num_warmup,
                               min_interactions=args.min_interactions)
    os.makedirs(args.out, exist_ok=True)
    for key in ("train", "dev", "test"):
        write_csv(parts[key], osp.join(args.out, key + ".csv"))

    _dump(warmup_dict(parts["input"]),
          osp.join(args.out, "user_input_dict.json"))

    # dense id maps over the COMBINED frame incl. warm-up (:151-162)
    combined = concat([parts[k] for k in ("input", "train", "dev", "test")])
    uids = np.unique(combined["user_id"])
    iids = np.unique(combined["video_id"])
    user2id = {str(int(u)): i for i, u in enumerate(uids, 1)}
    item2id = {str(int(v)): i for i, v in enumerate(iids, 1)}
    for name, table in (("second_map_user2id", user2id),
                        ("second_map_item2id", item2id),
                        ("second_map_id2user",
                         {str(v): k for k, v in user2id.items()}),
                        ("second_map_id2item",
                         {str(v): k for k, v in item2id.items()})):
        _dump(table, osp.join(args.out, name + ".json"))

    played = concat([parts[k] for k in ("train", "dev", "test")])
    _dump(exposure_prob_table(played["playing_time"]),
          osp.join(args.out, "SegMM_ExposureProb.json"))
    print(f"wrote {args.out}: " +
          ", ".join(f"{k}={frame_len(parts[k])}" for k in
                    ("input", "train", "dev", "test")) +
          f", users={len(uids)}, items={len(iids)}")


if __name__ == "__main__":
    main()
