"""Build frame-as-item leave-ranking datasets (the SkipPredBaseline data;
port of ``segmminterest_tpu/tasks/build_leave_rank_data.py`` without
pandas: every file it writes is byte for byte the JAX builder's).

Behavioral spec: reference data_process/get_SegMM_data.py (D5):
 * every video segment becomes an item ("frame"); a global
   photo_id2frame_id map assigns each photo's segments consecutive frame ids;
 * train.csv = watched frames as positive interactions
   (user_id, item_id=frame, time, c_frame_length, photo_id);
 * dev/test.csv = the LEAVE frame as the target item plus the video's other
   frames as neg_items, padded to 39 with id 1 (plain) or a dedicated
   default item (Default variant, which also appends one default-item row);
 * item_meta.csv with i_pos_f = position/40 (get_item_pos).
Also writes the MMRec-style .inter export (get_data_MMRec.py, D6) and the
photo_id2frame_id_leave json consumed by the baseline-logits converter (D7).

The ``time`` columns carry the raw ``time_ms`` values as the JAX builder's
``iterrows`` hands them over: as floats when every column of the input is
numeric and one of them is a float column.

  python -m segmminterest_tpu_torch.tasks.build_leave_rank_data \
      --inter_csv inter.csv --out data --min_interactions 30 --num_warmup 10
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np

from ..data.labels import frame_count
from ..data.reader import (Frame, concat, frame_len, normalize_columns,
                           read_csv, split_interactions, take, write_csv)


def row_times(df: Frame) -> list:
    """``row["time_ms"]`` of ``df.iterrows()``: a row of all-numeric
    columns with a float among them is upcast to float."""
    kinds = {v.dtype.kind for v in df.values()}
    t = df["time_ms"]
    if kinds <= set("iuf") and "f" in kinds:
        t = t.astype(np.float64)
    return list(t)


def records(rows: list, columns) -> Frame:
    """``pd.DataFrame(rows)`` of dicts with these keys (list values as
    their ``str``)."""
    if not rows:
        return {}
    out = {}
    for c in columns:
        vals = [r[c] for r in rows]
        out[c] = (np.asarray([str(v) for v in vals], dtype=object)
                  if isinstance(vals[0], list) else np.asarray(vals))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--inter_csv", type=str, required=True)
    p.add_argument("--sep", type=str, default=",")
    p.add_argument("--out", type=str, default="data")
    p.add_argument("--name", type=str, default="SegMMstep1Ranking")
    p.add_argument("--min_interactions", type=int, default=100)
    p.add_argument("--num_warmup", type=int, default=80)
    p.add_argument("--seed", type=int, default=2024)
    args = p.parse_args(argv)

    df = normalize_columns(read_csv(args.inter_csv, sep=args.sep))
    parts = split_interactions(df, seed=args.seed,
                               num_warmup=args.num_warmup,
                               min_interactions=args.min_interactions)
    combined = concat([parts[k] for k in ("train", "dev", "test")])
    uids = {int(u): i for i, u in
            enumerate(np.unique(combined["user_id"]), 1)}

    # global frame-id assignment: consecutive ids per photo's segments,
    # starting at 2 (0 = padding, 1 = the plain variant's filler id)
    photo2frames = {}
    next_id = 2
    vids, first = np.unique(combined["video_id"], return_index=True)
    for pid, dur in zip(vids, combined["duration_ms"][first]):
        n = min(frame_count(dur), 40)
        photo2frames[int(pid)] = list(range(next_id, next_id + n))
        next_id += n
    default_id = next_id

    def rows_of(part):
        for i, t in enumerate(row_times(part)):
            pid = int(part["video_id"][i])
            watched = frame_count(min(part["playing_time"][i],
                                      part["duration_ms"][i]))
            yield uids[int(part["user_id"][i])], pid, t, watched, \
                photo2frames[pid]

    def rows_for_split(part, default_variant):
        """dev/test leave-frame target + same-video negatives
        (get_test_valid_data, :84-133)."""
        out = []
        pad = default_id if default_variant else 1
        for uid, pid, t, watched, frames in rows_of(part):
            playing_length = max(1, watched)
            if playing_length > len(frames):  # completed view: no leave slot
                continue
            leave = frames[playing_length - 1]
            negs = [f for f in frames if f != leave]
            if len(negs) < 39:
                negs = negs + [pad] * (39 - len(negs))
            out.append({"user_id": uid, "item_id": leave, "time": t,
                        "neg_items": negs[:39],
                        "c_frame_length": len(frames), "photo_id": pid})
        if default_variant and out:
            # the Default variant appends one default-item row that the
            # leave-rank evaluator trims (get_test_valid_data_default
            # :180-182, evaluate_method 'Default' branch)
            out.append({**out[-1], "item_id": default_id,
                        "neg_items": [default_id] * 39})
        return records(out, ("user_id", "item_id", "time", "neg_items",
                             "c_frame_length", "photo_id"))

    def train_rows(part):
        """watched frames as positives (load_train_data :42-66)."""
        out = []
        for uid, pid, t, watched, frames in rows_of(part):
            for i in range(min(max(0, watched - 1), len(frames))):
                out.append({"user_id": uid, "item_id": frames[i], "time": t,
                            "c_frame_length": len(frames), "photo_id": pid})
        return records(out, ("user_id", "item_id", "time", "c_frame_length",
                             "photo_id"))

    train_df = train_rows(parts["train"])
    # item_meta with positional feature (get_item_pos :190-204)
    meta_ids = [f for frames in photo2frames.values() for f in frames]
    meta_pos = [pos / 40.0 for frames in photo2frames.values()
                for pos in range(len(frames))]
    meta_ids += [default_id, 1]
    meta_pos += [0.5, 0.5]
    order = np.argsort(np.asarray(meta_ids), kind="stable")
    meta = {"item_id": np.asarray(meta_ids)[order],
            "i_pos_f": np.asarray(meta_pos, np.float64)[order]}
    for variant, default_variant in ((args.name, False),
                                     (args.name + "Default", True)):
        base = osp.join(args.out, variant)
        os.makedirs(base, exist_ok=True)
        write_csv(train_df, osp.join(base, "train.csv"))
        for phase in ("dev", "test"):
            write_csv(rows_for_split(parts[phase], default_variant),
                      osp.join(base, phase + ".csv"))
        write_csv(meta, osp.join(base, "item_meta.csv"))

    # the frame map for the D7 converter + MMRec eval
    map_path = osp.join(args.out, "photo_id2frame_id_leave.json")
    with open(map_path, "w") as f:
        json.dump({str(k): v for k, v in photo2frames.items()}, f)

    # MMRec-style .inter (get_data_MMRec.py): watched frames with x_label
    # split markers + default rows per user for dev/test
    inter_rows = []
    for x_label, phase in ((0, "train"), (1, "dev"), (2, "test")):
        for uid, pid, t, watched, frames in rows_of(parts[phase]):
            for i in range(min(max(1, watched), len(frames))):
                inter_rows.append((uid, frames[i], pid, t, x_label))
    cols = ("userID", "frame_id", "itemID", "time_ms", "x_label")
    inter = {c: np.asarray([r[j] for r in inter_rows])
             for j, c in enumerate(cols)}
    _, firsts = np.unique(inter["userID"], return_index=True)
    first = take(inter, np.sort(firsts))
    adds = []
    for x_label in (1, 2):
        add = dict(first)
        add["frame_id"] = np.full(frame_len(first), default_id)
        add["x_label"] = np.full(frame_len(first), x_label)
        adds.append(add)
    inter = concat([inter] + adds)
    write_csv(inter, osp.join(args.out, "SegMMdefault.inter"))
    print(f"wrote {args.name}[Default] (train {frame_len(train_df)} rows, "
          f"{len(photo2frames)} photos, default_id={default_id}), "
          f"{map_path}, SegMMdefault.inter ({frame_len(inter)})")


if __name__ == "__main__":
    main()
