"""The port's statistics baselines against the JAX package's, on a synthetic
SegMM-shaped CSV made from a seed: the corpus statistics and every test
type's scores bit for bit (one ``np.random.Generator`` seed on each side),
the exported statistics logits byte for byte, and ``stats_eval``'s metrics
(cold and hot splits too) equal."""

import json

import numpy as np
import pytest

from segmminterest_tpu.data.reader import SeqReader as JaxReader
from segmminterest_tpu.engine import statistics as j_stats
from segmminterest_tpu.tasks import export_statistics_logits as j_export
from segmminterest_tpu.tasks import stats_eval as j_eval
from segmminterest_tpu_torch.data.reader import SeqReader
from segmminterest_tpu_torch.data.synthetic import write_synthetic_csv
from segmminterest_tpu_torch.engine import statistics as t_stats
from segmminterest_tpu_torch.tasks import export_statistics_logits as t_export
from segmminterest_tpu_torch.tasks import stats_eval as t_eval

SPLIT = ["--min_interactions", "30", "--num_warmup", "10"]


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    return write_synthetic_csv(
        str(tmp_path_factory.mktemp("stats") / "inter.csv"), n_users=12,
        per_user=(35, 60), n_videos=80, seed=9)


@pytest.fixture(scope="module")
def stats(csv_path):
    jr = JaxReader.from_single_csv(csv_path, min_interactions=30,
                                   num_warmup=10)
    tr = SeqReader.from_single_csv(csv_path, min_interactions=30,
                                   num_warmup=10)
    return (j_stats.compute_statistics([jr.tables["train"],
                                        jr.tables["dev"]]),
            t_stats.compute_statistics([tr.tables["train"],
                                        tr.tables["dev"]]), tr)


def _assert_same(a, b, path="stats"):
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path


def test_compute_statistics_bit_equal(stats):
    want, got, _ = stats
    assert list(t_stats.TEST_TYPES) == list(j_stats.TEST_TYPES)
    _assert_same(want, got)


@pytest.mark.parametrize("test_type", j_stats.TEST_TYPES)
def test_synthesize_scores_bit_equal(stats, test_type):
    """Two batches in a row from one generator (the draws carry over), and
    ids the statistics never saw (their fall-backs)."""
    want_stats, got_stats, reader = stats
    t = reader.tables["test"]
    users = np.concatenate([t.user_raw, [1, 2]])
    photos = np.concatenate([t.video_raw, [3, 4]])
    durs = np.concatenate([(t.labels != -2).sum(1), [40, 1]])
    j_rng, t_rng = np.random.default_rng(5), np.random.default_rng(5)
    for half in (slice(None, len(users) // 2), slice(len(users) // 2, None)):
        want = j_stats.synthesize_scores(test_type, want_stats, users[half],
                                         photos[half], durs[half], j_rng)
        got = t_stats.synthesize_scores(test_type, got_stats, users[half],
                                        photos[half], durs[half], t_rng)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_export_statistics_logits_byte_equal(csv_path, tmp_path):
    args = ["--sample_csv", csv_path, "--test_types",
            ",".join(j_stats.TEST_TYPES)] + SPLIT
    want = j_export.main(args + ["--out_dir", str(tmp_path / "jax")])
    got = t_export.main(args + ["--out_dir", str(tmp_path / "port")])
    assert len(got) == len(want) == len(j_stats.TEST_TYPES)
    for a, b in zip(want, got):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), b


def test_stats_eval_metrics_equal(csv_path, tmp_path):
    args = ["--sample_csv", csv_path, "--eval_cold", "test",
            "--batch_size", "64"] + SPLIT
    j_eval.main(args + ["--out", str(tmp_path / "jax.json")])
    t_eval.main(args + ["--out", str(tmp_path / "port.json")])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    assert list(got) == list(j_stats.TEST_TYPES)
    assert got == want
