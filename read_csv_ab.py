"""Host time of ``SeqReader.from_single_csv`` on an interaction CSV with one
float column, under three float parsers in one process:

  float         Python's parser (what the reader used before it matched
                pandas' bits)
  xstrtod       pandas' digit loop (``data/reader.py:xstrtod``) for every
                float cell
  pandas_float  the reader's parser: ``float`` where it gives pandas' bits
                (at most 15 digits, no exponent), the digit loop elsewhere

Two CSVs: ``repr`` holds the column as ``repr`` writes it (up to 17
significant digits, the digit loop's case), ``6dp`` rounded to six places
(the fast path's case). 1,903 users (SegMM's count) of 200-300 rows each by
default. Prints one JSON line: for each CSV and parser, the seconds of each
read and of the float column's parse alone.

  python read_csv_ab.py [--users 1903] [--repeats 2]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time

import numpy as np

from segmminterest_tpu_torch.data import reader as R
from segmminterest_tpu_torch.data.synthetic import write_synthetic_csv

PARSERS = {"float": float, "xstrtod": R.xstrtod,
           "pandas_float": R.pandas_float}


def _with_ratio(src: str, dst: str, fmt) -> list:
    """``src`` with a column ``watch_ratio`` (play / duration) written by
    ``fmt``; returns that column's cells."""
    with open(src, newline="") as f:
        rows = list(csv.reader(f))
    cells = [fmt(int(r[4]) / int(r[3])) for r in rows[1:]]
    with open(dst, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(rows[0] + ["watch_ratio"])
        w.writerows(r + [c] for r, c in zip(rows[1:], cells))
    return cells


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--users", type=int, default=1903)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--work", default=os.path.join("build", "read_csv_ab"))
    args = p.parse_args(argv)
    os.makedirs(args.work, exist_ok=True)
    base = write_synthetic_csv(os.path.join(args.work, "inter.csv"),
                               n_users=args.users, per_user=(200, 300),
                               n_videos=20_000, seed=3)
    out = {}
    for name, fmt in (("repr", repr), ("6dp", lambda x: f"{x:.6f}")):
        path = os.path.join(args.work, f"inter_{name}.csv")
        cells = _with_ratio(base, path, fmt)
        res = {"rows": len(cells)}
        for pname, parse in PARSERS.items():
            R.pandas_float = parse  # the name _column calls
            reads, parses = [], []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                reader = R.SeqReader.from_single_csv(
                    path, min_interactions=100, num_warmup=80)
                reads.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                R._column(cells)
                parses.append(time.perf_counter() - t0)
            res[pname] = {"read_s": reads, "column_s": parses}
        R.pandas_float = PARSERS["pandas_float"]
        out[name] = res
    out["train_rows"] = len(reader.tables["train"])
    print(json.dumps({"read_csv_ab": out}))


if __name__ == "__main__":
    main()
