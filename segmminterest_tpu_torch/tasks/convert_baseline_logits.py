"""Convert baseline per-frame prediction csvs into canonical interest logits
(port of ``segmminterest_tpu/tasks/convert_baseline_logits.py`` without
pandas).

Behavioral spec: reference data_process/get_frameid2photoid_SegMM.py
(:16-61): join a leave-rank model's per-(user, time, frame) predictions back
onto videos — for each interaction, gather the prediction for every frame of
the video (falling back to the user's default-item score for missing frames),
pad to 40 with the default score, and key the result
``"{user_id}-{photo_id}-{time_ms}"`` for SegRec consumption.

  python -m segmminterest_tpu_torch.tasks.convert_baseline_logits \
      --predictions_csv inference_scores.csv \
      --frame_map data/photo_id2frame_id_leave.json \
      --inter_csv inter.csv --default_item 12345
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.reader import (Frame, concat, normalize_columns, read_csv,
                           split_interactions)
from ..utils.io import dump_logits


def predictions_csv_to_logits(predictions: Frame, frame_map, inter: Frame,
                              user2dense, default_item):
    keys = zip(predictions["user_id"].astype(int).tolist(),
               predictions["time"].astype(int).tolist(),
               predictions["item_id"].astype(int).tolist())
    predictions_map = dict(zip(keys, predictions["predictions"]))
    is_default = predictions["item_id"] == default_item
    default_map = dict(zip(predictions["user_id"][is_default].astype(int)
                           .tolist(), predictions["predictions"][is_default]))

    logits = {}
    for user_raw, vid, t in zip(inter["user_id"], inter["video_id"],
                                inter["time_ms"]):
        user_raw, t = int(user_raw), int(t)
        user_dense = user2dense[user_raw]
        pid = str(int(vid))
        frames = frame_map.get(pid, [])
        default_pred = default_map.get(user_dense)
        if default_pred is None:
            default_pred = float(np.mean(list(default_map.values()))
                                 if default_map else 0.0)
        preds = [predictions_map.get((user_dense, t, f), default_pred)
                 for f in frames]
        logits[f"{user_raw}-{pid}-{t}"] = \
            [float(x) for x in preds] + [float(default_pred)] * (40 - len(preds))
    return logits


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--predictions_csv", type=str, required=True)
    p.add_argument("--frame_map", type=str, required=True)
    p.add_argument("--inter_csv", type=str, required=True)
    p.add_argument("--sep", type=str, default=",")
    p.add_argument("--default_item", type=int, required=True)
    p.add_argument("--min_interactions", type=int, default=100)
    p.add_argument("--num_warmup", type=int, default=80)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--pth", type=int, default=0,
                   help="also torch.save the dict as a .pth twin "
                        "(PARITY S11)")
    args = p.parse_args(argv)

    with open(args.frame_map) as f:
        frame_map = json.load(f)
    df = normalize_columns(read_csv(args.inter_csv, sep=args.sep))
    parts = split_interactions(df, num_warmup=args.num_warmup,
                               min_interactions=args.min_interactions)
    inter = concat([parts[k] for k in ("train", "dev", "test")])
    user2dense = {int(u): i for i, u in
                  enumerate(np.unique(inter["user_id"]), 1)}
    preds = read_csv(args.predictions_csv, sep="\t")
    logits = predictions_csv_to_logits(preds, frame_map, inter, user2dense,
                                       args.default_item)
    out = args.out or args.predictions_csv.replace(".csv", "_logits.json")
    dump_logits(logits, out, pth=bool(args.pth))
    print(f"wrote {len(logits)} logit rows to {out}")


if __name__ == "__main__":
    main()
