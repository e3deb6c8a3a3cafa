"""The port's dataset builders against the JAX package's, without pandas on
the port's side: each builder's files must be byte for byte the JAX
builder's, on the synthetic SegMM-shaped CSV and on a small CSV of the
filters' edge cases (play 0, duration 0 and at or past 200 s, ties in
time, a video seen with two durations, a float column); the port's reader
must read a built directory as the JAX reader does."""

import csv
import filecmp
import json
import os

import numpy as np
import pytest

from segmminterest_tpu.data.reader import SeqReader as JaxReader
from segmminterest_tpu.tasks import build_interactions as j_inter
from segmminterest_tpu.tasks import build_leave_rank_data as j_leave
from segmminterest_tpu.tasks import build_segrec_data as j_segrec
from segmminterest_tpu.tasks import convert_baseline_logits as j_convert
from segmminterest_tpu_torch.data.reader import (SeqReader, pandas_float,
                                                 write_csv, xstrtod)
from segmminterest_tpu_torch.data.synthetic import write_synthetic_csv
from segmminterest_tpu_torch.tasks import build_interactions as t_inter
from segmminterest_tpu_torch.tasks import build_leave_rank_data as t_leave
from segmminterest_tpu_torch.tasks import build_segrec_data as t_segrec
from segmminterest_tpu_torch.tasks import convert_baseline_logits as t_convert

SPLIT = ["--min_interactions", "30", "--num_warmup", "10"]


def _edge_csv(path):
    """Four users of 60-80 rows: plays of 0, durations of 0, 200,000 ms and
    past it, several rows of a user at one time, one video with two
    durations, and a float column."""
    rng = np.random.default_rng(5)
    rows = []
    for u in (7, 3, 11, 5):
        t0 = 1_700_000_000_000 + 1000 * u
        for i in range(int(rng.integers(60, 81))):
            dur = int(rng.choice([0, 4_000, 12_345, 60_000, 199_999,
                                  200_000, 250_000],
                                 p=[.05, .25, .2, .25, .15, .05, .05]))
            play = int(rng.choice([0, 1, 2_500, 5_000, 30_000, 300_000],
                                  p=[.1, .1, .2, .2, .3, .1]))
            vid = int(rng.integers(900, 930))
            if vid == 901:
                dur = 17_000 if u == 7 else 33_000
            rows.append((u, vid, t0 + 1000 * (i // 3), dur, play,
                         round(float(rng.random()), 3)))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["user_id", "photo_id", "time_ms", "duration_ms",
                    "playing_time", "ratio_x"])
        w.writerows(rows[i] for i in rng.permutation(len(rows)))
    return path


@pytest.fixture(scope="module", params=["synthetic", "edge"])
def csv_path(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    if request.param == "synthetic":
        return write_synthetic_csv(str(d / "inter.csv"), n_users=14,
                                   per_user=(20, 70), n_videos=250, seed=3)
    return _edge_csv(str(d / "inter.csv"))


def _same_tree(a, b):
    files_a = sorted(os.path.relpath(os.path.join(r, f), a)
                     for r, _, fs in os.walk(a) for f in fs)
    files_b = sorted(os.path.relpath(os.path.join(r, f), b)
                     for r, _, fs in os.walk(b) for f in fs)
    assert files_a == files_b and files_a
    for f in files_a:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f
    return files_a


def _both(jax_main, port_main, args, tmp_path, out_flag="--out"):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_main(args + [out_flag, jd])
    port_main(args + [out_flag, td])
    return jd, td, _same_tree(jd, td)


def test_build_interactions_byte_equal(csv_path, tmp_path):
    jd, td, files = _both(j_inter.main, t_inter.main,
                          ["--inter_csv", csv_path] + SPLIT, tmp_path)
    assert {"train.csv", "dev.csv", "test.csv", "user_input_dict.json",
            "SegMM_ExposureProb.json"} <= set(files)
    # a built directory reads the same through either reader
    a, b = JaxReader.from_dir(jd), SeqReader.from_dir(td)
    assert (a.user2id, a.item2id, a.user_input_dict) == \
        (b.user2id, b.item2id, b.user_input_dict)
    for split in ("train", "dev", "test"):
        for field in ("user_raw", "video_raw", "time_ms", "duration_ms",
                      "playing_time", "labels", "user_idx", "item_idx",
                      "position"):
            np.testing.assert_array_equal(
                getattr(b.tables[split], field),
                getattr(a.tables[split], field), err_msg=field)


def test_build_interactions_kuairand_byte_equal(csv_path, tmp_path):
    _both(j_inter.main, t_inter.main,
          ["--inter_csv", csv_path, "--dataset", "KuaiRand", "--num_warmup",
           "5", "--min_interactions", "30"], tmp_path)


def test_build_segrec_data_byte_equal(csv_path, tmp_path):
    _, td, files = _both(j_segrec.main, t_segrec.main,
                         ["--inter_csv", csv_path, "--name", "SegMM",
                          "--n_eval_neg", "9", "--kg_meta", "1"] + SPLIT,
                         tmp_path)
    assert "SegMM_CTR/train.csv" in files and "SegMM/item_meta.csv" in files
    with open(os.path.join(td, "SegMM_CTR", "train.csv")) as f:
        labels = [r["label"] for r in csv.DictReader(f, delimiter="\t")]
    assert {"0", "1"} <= set(labels)


def test_build_leave_rank_data_byte_equal(csv_path, tmp_path):
    _, _, files = _both(j_leave.main, t_leave.main,
                        ["--inter_csv", csv_path] + SPLIT, tmp_path)
    assert {"SegMMstep1Ranking/test.csv",
            "SegMMstep1RankingDefault/item_meta.csv",
            "photo_id2frame_id_leave.json", "SegMMdefault.inter"} <= set(files)


def test_convert_baseline_logits_equal(csv_path, tmp_path):
    """Scores for every leave-rank test row's target and negatives, and a
    default-item score for every other user, through both converters."""
    built = str(tmp_path / "built")
    t_leave.main(["--inter_csv", csv_path, "--out", built] + SPLIT)
    with open(os.path.join(built, "SegMMstep1RankingDefault",
                           "item_meta.csv")) as f:
        default = max(int(r["item_id"]) for r in
                      csv.DictReader(f, delimiter="\t"))
    rng = np.random.default_rng(0)
    rows = []
    with open(os.path.join(built, "SegMMstep1Ranking", "test.csv")) as f:
        for r in csv.DictReader(f, delimiter="\t"):
            for item in [int(r["item_id"])] + json.loads(r["neg_items"])[:5]:
                rows.append((r["user_id"], r["time"], item, rng.random()))
            if int(r["user_id"]) % 2:
                rows.append((r["user_id"], r["time"], default, rng.random()))
    preds = str(tmp_path / "preds.csv")
    with open(preds, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["user_id", "time", "item_id", "predictions"])
        w.writerows(rows)
    args = ["--predictions_csv", preds, "--inter_csv", csv_path,
            "--frame_map", os.path.join(built, "photo_id2frame_id_leave.json"),
            "--default_item", str(default)] + SPLIT
    j_convert.main(args + ["--out", str(tmp_path / "jax.json")])
    t_convert.main(args + ["--out", str(tmp_path / "port.json")])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    assert got == want and len(got) > 10


def test_pandas_float_matches_read_csv(tmp_path):
    """Floats read as pandas' default parser reads them (17-digit reprs,
    where Python's float() differs from it in the last bit, exponents,
    subnormals), and written back as DataFrame.to_csv writes them."""
    import pandas as pd
    rng = np.random.default_rng(2)
    texts = [repr(float(x)) for x in rng.random(2000)] + [
        repr(float(x)) for x in rng.normal(size=500)
        * 10.0 ** rng.integers(-30, 30, 500)] + [
        "1e5", "-0.0", "5.", ".5", "+3.25", "123456789012345678901",
        "0.000000000000000000000000123456789123456789", "1E-310",
        "4.9e-324", "1.7976931348623157e308", "nan", "inf"]
    # up to 15 digits without exponent: pandas_float's float() fast path
    digits = [str(v) for v in rng.integers(0, 10 ** 15, 500)]
    cut = rng.integers(0, 16, 500)
    texts += [("-" if i % 3 == 0 else "") + d[:c] + "." + d[c:]
              for i, (d, c) in enumerate(zip(digits, cut))]
    path = tmp_path / "x.csv"
    path.write_text("x\n" + "\n".join(texts) + "\n")
    want = pd.read_csv(path)["x"].to_numpy()
    got = np.asarray([pandas_float(t) for t in texts])
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    slow = np.asarray([xstrtod(t) for t in texts])
    np.testing.assert_array_equal(got.view(np.int64), slow.view(np.int64))
    assert sum(pandas_float(t) != float(t) for t in texts[:2000]) > 100
    frame = {"x": got, "i": np.arange(len(got)),
             "s": np.asarray([f"[{t}, 1]" for t in texts], dtype=object)}
    write_csv(frame, str(tmp_path / "out.csv"))
    assert (tmp_path / "out.csv").read_text() == \
        pd.DataFrame(frame).to_csv(sep="\t", index=False)
