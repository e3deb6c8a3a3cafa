"""The serving slice end to end on the CPU: random JAX params, converted and
saved with the port's CheckPointer, served by the port's
``export_logits.main`` from a synthetic CSV; the logits must match the JAX
package's ``export_split_logits`` over the same split and params, key for
key, within 1e-4 (fp32; the same math summed in another order)."""

import json

import jax
import numpy as np
import pytest

from segmminterest_tpu.data.dataset import BatchIterator as JaxIterator
from segmminterest_tpu.data.feature_store import FeatureStore as JaxStore
from segmminterest_tpu.data.reader import SeqReader as JaxReader
from segmminterest_tpu.engine.train import InterestEngine as JaxEngine
from segmminterest_tpu.tasks.export_logits import \
    export_split_logits as jax_export
from segmminterest_tpu.utils.config import InterestConfig as JaxConfig
from segmminterest_tpu_torch.data.synthetic import (synthetic_lineid_map,
                                                    write_synthetic_csv)
from segmminterest_tpu_torch.data.reader import SeqReader
from segmminterest_tpu_torch.engine.checkpoint import CheckPointer
from segmminterest_tpu_torch.engine.train import InterestEngine
from segmminterest_tpu_torch.models.convert import flax_to_state_dict
from segmminterest_tpu_torch.tasks import export_logits
from segmminterest_tpu_torch.utils.config import InterestConfig

ATOL = 1e-4
MODEL = dict(d_model=32, nhead=4, num_layers_enc=3, fusion_heads=2,
             exposure_prob=[1.0] * 40, seed=11)
READER = dict(min_interactions=30, num_warmup=10)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    csv = write_synthetic_csv(str(d / "inter.csv"), n_users=10,
                              per_user=(35, 60), n_videos=200, seed=4)
    reader = SeqReader.from_single_csv(csv, **READER)
    lineid_map = synthetic_lineid_map(reader)  # one memmap row per segment
    memmap = str(d / "feat.dat")
    mm = np.memmap(memmap, dtype="float32", mode="w+",
                   shape=(len(lineid_map), 1024))
    mm[:] = np.random.default_rng(0).normal(size=mm.shape)
    mm.flush()
    lineid = str(d / "lineid.json")
    with open(lineid, "w") as f:
        json.dump(lineid_map, f)
    return dict(dir=d, csv=csv, memmap=memmap, lineid=lineid)


def _jax_logits(cfg_kw, data, batch_size, store):
    reader = JaxReader.from_single_csv(data["csv"], **READER)
    cfg = JaxConfig(**cfg_kw)
    engine = JaxEngine(cfg, reader.n_users, reader.n_items,
                       feature_table=np.asarray(store.feat) if store else None)
    def it():  # a fresh iterator: its pool draws advance its rng
        return JaxIterator(reader, reader.tables["test"], batch_size,
                           feature_store=store, seed=cfg.seed)
    # the params engine.init_state makes, with the init compiled once
    # instead of op by op; eval_step reads only state["params"]
    key = jax.random.PRNGKey(3)
    init = jax.jit(lambda *a: engine.model.init(
        {"params": key, "dropout": key, "permute": key}, *a,
        deterministic=True)["params"])
    state = {"params": init(*engine._model_inputs(
        engine.put_batch(next(iter(it()))), engine.feat_table))}
    params = jax.tree.map(np.asarray, state["params"])
    return jax_export(engine, state, it()), params, reader


def _save_port_checkpoint(params, cfg, reader, table, work_dir):
    engine = InterestEngine(cfg, reader.n_users, reader.n_items,
                            feature_table=table, device="cpu")
    sd = flax_to_state_dict(params, engine.model)
    CheckPointer("main_metric", work_dir, mode="max").save_checkpoint(
        {"params": sd}, 1, {"main_metric": 0.25})


def _compare(got_path, want):
    with open(got_path) as f:
        got = json.load(f)
    assert set(got) == set(want) and len(got) > 10
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=ATOL, rtol=0, err_msg=k)


def _cli(data, work_dir, out_dir, extra):
    return ["--sample_csv", data["csv"], "--min_interactions", "30",
            "--num_warmup", "10", "--d_model", "32", "--nhead", "4",
            "--num_layers_enc", "3", "--seed", "11", "--splits", "test",
            "--work_dir", str(work_dir), "--out_dir", str(out_dir),
            "--parse_work_dir", "0", "--device", "cpu"] + extra


def test_serving_preset_picks_batch_from_latency_table():
    table = export_logits.SERVING_LATENCY_TABLE
    cfg = export_logits.apply_serving_preset(InterestConfig())
    assert (cfg.test_batch_size, cfg.compute_dtype, cfg.table_quant,
            cfg.fuse_qkv, cfg.remat) == (table[0][0], "bfloat16", "int8",
                                         True, False)
    for batch, ms in table:  # the largest batch whose latency fits
        assert export_logits.apply_serving_preset(
            InterestConfig(), ms).test_batch_size == batch
    fastest = min(ms for _, ms in table)
    assert export_logits.apply_serving_preset(
        InterestConfig(), fastest / 2).test_batch_size == table[-1][0]


def test_export_ids_matches_jax(data):
    """id/id, default config (the K1 route), fp32."""
    kw = dict(MODEL, user_input_type="id", photo_input_type="id",
              test_batch_size=64)
    want, params, jreader = _jax_logits(kw, data, 64, None)
    reader = SeqReader.from_single_csv(data["csv"], **READER)
    work = data["dir"] / "ckpt_ids"
    _save_port_checkpoint(params, InterestConfig(**kw), reader, None, work)
    out = export_logits.main(_cli(data, work, data["dir"] / "out_ids", [
        "--user_input_type", "id", "--photo_input_type", "id",
        "--test_batch_size", "64"]))
    _compare(out, want)
    assert len(want) == len(jreader.tables["test"])


def test_export_serving_features_matches_jax(data, monkeypatch):
    """both/both over a small memmap with the --serving preset (int8 table,
    the K2 route), at fp32 compute so the comparison is exact to 1e-4."""
    preset = export_logits.apply_serving_preset

    def fp32_preset(cfg, latency_target_ms=0.0):
        return preset(cfg, latency_target_ms).replace(
            compute_dtype="float32")

    monkeypatch.setattr(export_logits, "apply_serving_preset", fp32_preset)
    kw = dict(MODEL, table_quant="int8", fuse_qkv=True, remat=False,
              test_batch_size=1024)
    store = JaxStore.open(data["memmap"], data["lineid"])
    want, params, _ = _jax_logits(kw, data, 1024, store)
    reader = SeqReader.from_single_csv(data["csv"], **READER)
    work = data["dir"] / "ckpt_feat"
    _save_port_checkpoint(params, InterestConfig(**kw), reader,
                          np.asarray(store.feat), work)
    out = export_logits.main(_cli(data, work, data["dir"] / "out_feat", [
        "--memmap", data["memmap"], "--lineid_map", data["lineid"],
        "--serving", "1"]))
    _compare(out, want)
