"""Export statistics-baseline "logits" for Task-2 (SegRec) consumption
(port of ``segmminterest_tpu/tasks/export_statistics_logits.py``; host only,
as in the JAX package).

Behavioral spec: reference MMinterest/inference/save_logits_for_statistics_SegMM.py
(:127-200,253-259): compute the corpus statistics over train+dev, then for each
null predictor synthesize per-segment scores over ALL of train/dev/test
(bernoulli-sampled where the reference samples), multiply by the exposure
probability, and dump one canonical dict ``"{uid}-{pid}-{time_ms}" -> [40]``
per test type to ``saved_logits/<name>/statistics_<type>.json`` — the same
format SegRec loads as ``clip_weight_path`` (SegRec/models/BaseModel.py:129-131).

The reference hard-codes the 4 exported types at :253; ``--test_types`` here
defaults to the same list but accepts any of engine.statistics.TEST_TYPES.

Usage:
  python -m segmminterest_tpu_torch.tasks.export_statistics_logits \
      --sample_csv inter.csv \
      --min_interactions 30 --num_warmup 10 --out_dir saved_logits/SegMM
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp

import numpy as np

from ..data.dataset import BatchIterator
from ..data.reader import SeqReader
from ..engine.statistics import TEST_TYPES, compute_statistics, \
    synthesize_scores
from ..utils.io import dump_logits

logger = logging.getLogger(__name__)

# reference :253 exports exactly these four
DEFAULT_EXPORT_TYPES = ["all_same", "prob_view_pos", "prob_user_view_pos",
                        "num_item_view_duration_pos"]


def export_test_type(test_type, stats, reader, batch_size, exposure_prob,
                     rng, debug=False):
    out = {}
    for split in ("train", "dev", "test"):
        it = BatchIterator(reader, reader.tables[split], batch_size,
                           shuffle=False)
        for step, batch in enumerate(it):
            if debug and step > 2:
                break
            rm = batch["row_mask"]
            gt = batch["label"][rm]
            uids = batch["user_raw"][rm]
            pids = batch["video_raw"][rm]
            tms = batch["time_ms"][rm]
            durations = (gt != -2).sum(axis=1)
            scores = synthesize_scores(test_type, stats, uids, pids,
                                       durations, rng)
            logits = scores * exposure_prob[None, :]
            for uid, pid, t, row in zip(uids, pids, tms, logits):
                out[f"{uid}-{pid}-{t}"] = [float(x) for x in row]
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser()
    p.add_argument("--path", type=str, default="SegMM/")
    p.add_argument("--sep", type=str, default="\t")
    p.add_argument("--sample_csv", type=str, default=None)
    p.add_argument("--min_interactions", type=int, default=100)
    p.add_argument("--num_warmup", type=int, default=80)
    p.add_argument("--batch_size", type=int, default=512)  # reference :206
    p.add_argument("--seed", type=int, default=42)         # reference :19
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--pth", type=int, default=0,
                   help="also torch.save each dict as a .pth twin "
                        "(reference save_logits_for_statistics quirk, "
                        "PARITY S11)")
    p.add_argument("--test_exposure_prob_type", type=str, default="ones",
                   choices=["ones", "statistics"])
    p.add_argument("--exposure_prob_path", type=str,
                   default="SegMM_ExposureProb.json")
    p.add_argument("--test_types", type=str,
                   default=",".join(DEFAULT_EXPORT_TYPES))
    p.add_argument("--out_dir", type=str, default="saved_logits/SegMM")
    args = p.parse_args(argv)

    test_types = [t.strip() for t in args.test_types.split(",")]
    for test_type in test_types:
        if test_type not in TEST_TYPES:
            raise SystemExit(f"unknown test_type {test_type!r}; "
                             f"choose from {TEST_TYPES}")

    if args.test_exposure_prob_type == "statistics":
        with open(args.exposure_prob_path) as f:
            probs = json.load(f)
        exposure_prob = np.asarray([probs[k] for k in probs], np.float64)
    else:
        exposure_prob = np.ones(40, np.float64)

    if args.sample_csv:
        reader = SeqReader.from_single_csv(
            args.sample_csv, min_interactions=args.min_interactions,
            num_warmup=args.num_warmup)
    else:
        reader = SeqReader.from_dir(args.path, sep=args.sep)

    # statistics over train+dev (reference statistics_dataset :34-36)
    stats = compute_statistics([reader.tables["train"],
                                reader.tables["dev"]])
    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    paths = []
    for test_type in test_types:
        logits = export_test_type(test_type, stats, reader, args.batch_size,
                                  exposure_prob, rng, debug=bool(args.debug))
        path = osp.join(args.out_dir, f"statistics_{test_type}.json")
        dump_logits(logits, path, pth=bool(args.pth))
        logger.info("%s: wrote %d rows to %s", test_type, len(logits), path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
