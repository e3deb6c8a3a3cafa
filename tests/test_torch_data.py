"""The port's host data path (reader without pandas/scikit-learn, feature
store, batch iterator) against the JAX package's, on a synthetic
SegMM-shaped CSV made from a seed: splits, row order, id maps, histories
and every batch key must be identical."""

import numpy as np
import pytest

from segmminterest_tpu.data.dataset import BatchIterator as JaxIterator
from segmminterest_tpu.data.feature_store import FeatureStore as JaxStore
from segmminterest_tpu.data.reader import SeqReader as JaxReader
from segmminterest_tpu_torch.data.dataset import BatchIterator
from segmminterest_tpu_torch.data.feature_store import FeatureStore
from segmminterest_tpu_torch.data.reader import (SeqReader,
                                                 train_test_split_indices)
from segmminterest_tpu_torch.data.synthetic import (synthetic_lineid_map,
                                                    write_synthetic_csv)

KW = dict(min_interactions=30, num_warmup=10)


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    return write_synthetic_csv(
        str(tmp_path_factory.mktemp("segmm") / "inter.csv"), n_users=14,
        per_user=(20, 70), n_videos=250, seed=3)


@pytest.fixture(scope="module")
def readers(csv_path):
    return JaxReader.from_single_csv(csv_path, **KW), \
        SeqReader.from_single_csv(csv_path, **KW)


@pytest.mark.parametrize("n", [1, 2, 3, 9, 10, 11, 29, 30, 31, 97, 200])
def test_train_test_split_matches_sklearn(n):
    from sklearn.model_selection import train_test_split
    if n < 2:
        with pytest.raises(ValueError):
            train_test_split_indices(n, 2024)
        return
    tr, te = train_test_split(np.arange(n), test_size=0.1, random_state=2024)
    got_tr, got_te = train_test_split_indices(n, 2024)
    np.testing.assert_array_equal(got_tr, tr)
    np.testing.assert_array_equal(got_te, te)


def test_reader_matches_jax(readers):
    jr, tr = readers
    assert tr.user2id == jr.user2id and tr.item2id == jr.item2id
    assert (tr.n_users, tr.n_items) == (jr.n_users, jr.n_items)
    assert tr.user_input_dict == jr.user_input_dict
    for split in ("train", "dev", "test"):
        a, b = jr.tables[split], tr.tables[split]
        assert len(a) > 0
        for field in ("user_raw", "video_raw", "time_ms", "duration_ms",
                      "playing_time", "labels", "user_idx", "item_idx",
                      "position"):
            np.testing.assert_array_equal(getattr(b, field),
                                          getattr(a, field), err_msg=field)
    assert tr.user_his_items.keys() == jr.user_his_items.keys()
    for uid in jr.user_his_items:
        np.testing.assert_array_equal(tr.user_his_items[uid],
                                      jr.user_his_items[uid])
        np.testing.assert_array_equal(tr.user_his_playing[uid],
                                      jr.user_his_playing[uid])


def test_from_dir_matches_jax(readers, tmp_path):
    """Pre-split tab-separated files (the reference layout)."""
    import pandas as pd
    jr, _ = readers
    for split in ("train", "dev", "test"):
        t = jr.tables[split]
        pd.DataFrame({"user_id": t.user_raw, "video_id": t.video_raw,
                      "time_ms": t.time_ms, "duration_ms": t.duration_ms,
                      "playing_time": t.playing_time}).to_csv(
            tmp_path / f"{split}.csv", sep="\t", index=False)
    a = JaxReader.from_dir(str(tmp_path))
    b = SeqReader.from_dir(str(tmp_path))
    assert a.user2id == b.user2id and a.item2id == b.item2id
    for split in ("train", "dev", "test"):
        np.testing.assert_array_equal(b.tables[split].position,
                                      a.tables[split].position)
        np.testing.assert_array_equal(b.tables[split].labels,
                                      a.tables[split].labels)


def _assert_batches_equal(jax_it, torch_it):
    jb, tb = list(jax_it), list(torch_it)
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_iterator_ids_matches_jax(readers, shuffle):
    jr, tr = readers
    _assert_batches_equal(
        JaxIterator(jr, jr.tables["train"], 64, shuffle=shuffle, seed=5),
        BatchIterator(tr, tr.tables["train"], 64, shuffle=shuffle, seed=5))


@pytest.mark.parametrize("split", ["train", "test"])
def test_batch_iterator_features_matches_jax(readers, split):
    """With a small feature store: photo lines, exact user pools and the
    seeded subsampling of oversized pools agree batch for batch."""
    jr, tr = readers
    lineid_map = synthetic_lineid_map(tr, 5000)
    feat = np.zeros((5000, 8), np.float32)
    js, ts = JaxStore(feat, lineid_map), FeatureStore(feat, lineid_map)
    it = BatchIterator(tr, tr.tables[split], 32, shuffle=True,
                       feature_store=ts, seed=9, user_max=20)
    _assert_batches_equal(
        JaxIterator(jr, jr.tables[split], 32, shuffle=True,
                    feature_store=js, seed=9, user_max=20), it)
    # the pool draws ran: some pools exceed user_max
    assert any(len(it.row_pool(r)) > 20 for r in range(len(tr.tables[split])))
