"""Multi-seed repeat experiments (port of
``segmminterest_tpu/tasks/exp.py``).

Behavioral spec: reference SegRec/exp.py (:13-140): re-run a command
line across seeds, scrape the test metrics, and write a csv with per-seed
rows plus the mean. The swept entry points are the port's in-process
python mains (skip_train / segrec.main / mmrec.main / watchtime), so
results come back as dicts instead of regex-scraped logs. Arguments after
``--`` go to the entry as they are (``--device cpu`` among them).

  python -m segmminterest_tpu_torch.tasks.exp --entry segrec \\
      --seeds 0,1,2 --out sweep.csv -- \\
      --model_name WideDeep --model_mode CTR --path data --dataset SegMM_CTR
"""

from __future__ import annotations

import argparse
import csv
import importlib
import json
import logging
from typing import Dict, List

logger = logging.getLogger(__name__)

ENTRIES = {
    "skip_train": ("segmminterest_tpu_torch.tasks.skip_train", "--seed"),
    "segrec": ("segmminterest_tpu_torch.segrec.main", "--random_seed"),
    "mmrec": ("segmminterest_tpu_torch.mmrec.main", "--seed"),
    "watchtime": ("segmminterest_tpu_torch.tasks.watchtime", "--seed"),
}


def _flatten(prefix: str, obj, out: Dict[str, float]):
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}{k}." if prefix else f"{k}.", v, out) \
                if isinstance(v, dict) else _flatten(prefix + str(k), v, out)
    elif isinstance(obj, (int, float)):
        out[prefix] = float(obj)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser()
    p.add_argument("--entry", type=str, default="segrec",
                   choices=sorted(ENTRIES))
    p.add_argument("--seeds", type=str, default="0,1,2,3,4")
    p.add_argument("--out", type=str, default="exp_results.csv")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="arguments forwarded to the entry point (after --)")
    args = p.parse_args(argv)
    rest = [a for a in args.rest if a != "--"]

    module_name, seed_flag = ENTRIES[args.entry]
    entry_main = importlib.import_module(module_name).main

    rows: List[Dict[str, float]] = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        logger.info("=== seed %d ===", seed)
        result = entry_main(rest + [seed_flag, str(seed)])
        flat: Dict[str, float] = {}
        _flatten("", result if isinstance(result, dict) else {}, flat)
        flat = {k: v for k, v in flat.items()
                if any(t in k.lower() for t in
                       ("hr", "ndcg", "auc", "loss", "mse", "mae", "acc",
                        "f1", "jaccard", "ctr"))}
        flat["seed"] = seed
        rows.append(flat)

    keys = sorted({k for r in rows for k in r} - {"seed"})
    mean_row = {"seed": "mean"}
    for k in keys:
        vals = [r[k] for r in rows if k in r]
        if vals:
            mean_row[k] = sum(vals) / len(vals)
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["seed"] + keys)
        w.writeheader()
        for r in rows + [mean_row]:
            w.writerow(r)
    logger.info("wrote %s", args.out)
    print(json.dumps(mean_row, indent=2, default=str))
    return rows


if __name__ == "__main__":
    main()
