"""The JAX package's ``.msgpack`` checkpoints read by the port, on the CPU:

* the JAX ``CheckPointer`` writes the state (params and optax state) of a
  d_model 32, 4-head, 2-layer model, in fp32 and under bf16 compute (its PE
  tables then bf16 leaves); the port's ``export_logits --work_dir`` serves
  them: fp32 within PARITY's 1.4e-6 of the JAX package's logits; bf16 bit
  for bit as from a ``.pt`` checkpoint of the same weights, and within
  3e-2 of the JAX package's logits (the gap reads 0.0234, 1.5 bf16 ulps
  at logits up to 2.23 here: the two frameworks round at the same points
  and sum in other orders);
* a tree of every leaf kind flax's writer emits (ints, floats, str, None,
  bools, bytes, nested lists, numpy scalars, complex, bf16 arrays and
  scalars, empty arrays) decodes as ``flax.serialization.msgpack_restore``
  decodes it; leaves past ``MAX_CHUNK_SIZE`` (lowered here) come back
  whole;
* a directory with both kinds of checkpoint raises, naming both, unless
  its ckpt-latest.pt continues its ckpt-latest.msgpack; an optimizer state
  that is not optax's chain(clip, adamw) raises;
* resuming training: a JAX engine takes 3 steps and its CheckPointer
  writes ckpt-latest.msgpack; the port's engine resumes from it (params
  and AdamW state) and takes 3 more steps in lock-step with the JAX
  engine's own next 3, losses within 3e-4 relative, in fp32 and under
  bf16 compute (the bf16 PE tables and their moments widened to fp32);
  ``run_training(load=True)`` resumes from such a directory and writes
  ``.pt`` checkpoints beside it, resumes a second time from those, and
  ``export_logits --work_dir`` serves the directory as the ``.pt`` alone.
"""

import json
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.data.dataset import BatchIterator as JaxIterator
from segmminterest_tpu.data.reader import SeqReader as JaxReader
from segmminterest_tpu.engine.checkpoint import CheckPointer as JaxCheckPointer
from segmminterest_tpu.engine.train import InterestEngine as JaxEngine
from segmminterest_tpu.tasks.export_logits import \
    export_split_logits as jax_export
from segmminterest_tpu.utils.config import InterestConfig as JaxConfig
from segmminterest_tpu_torch.data.reader import SeqReader
from segmminterest_tpu_torch.data.synthetic import write_synthetic_csv
from segmminterest_tpu_torch.engine.checkpoint import (CheckPointer,
                                                       msgpack_restore)
from segmminterest_tpu_torch.engine.train import InterestEngine
from segmminterest_tpu_torch.models.convert import flax_to_state_dict
from segmminterest_tpu_torch.tasks import export_logits
from segmminterest_tpu_torch.utils.config import InterestConfig

PARITY_ATOL = 1.4e-6
BF16_ATOL = 3e-2     # just above the 0.0234 this model's bf16 gap reads
MODEL = dict(d_model=32, nhead=4, num_layers_enc=2, fusion_heads=2,
             exposure_prob=[1.0] * 40, seed=11, user_input_type="id",
             photo_input_type="id", test_batch_size=64)
READER = dict(min_interactions=30, num_warmup=10)


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    return write_synthetic_csv(
        str(tmp_path_factory.mktemp("msgpack") / "inter.csv"), n_users=10,
        per_user=(35, 60), n_videos=200, seed=4)


def _jax_checkpoint(csv_path, work_dir, **cfg_kw):
    """JAX params from a seed and their optax state, written by the JAX
    CheckPointer (latest and best); the JAX logits of the test split."""
    reader = JaxReader.from_single_csv(csv_path, **READER)
    cfg = JaxConfig(**MODEL, **cfg_kw)
    engine = JaxEngine(cfg, reader.n_users, reader.n_items)

    def it():
        return JaxIterator(reader, reader.tables["test"], 64, seed=cfg.seed)
    key = jax.random.PRNGKey(3)
    init = jax.jit(lambda *a: engine.model.init(
        {"params": key, "dropout": key, "permute": key}, *a,
        deterministic=True)["params"])
    params = init(*engine._model_inputs(engine.put_batch(next(iter(it()))),
                                        engine.feat_table))
    state = {"params": params, "opt_state": engine.optimizer.init(params)}
    JaxCheckPointer("main_metric", str(work_dir), mode="max") \
        .save_checkpoint(state, 1, {"main_metric": 0.25})
    return jax_export(engine, state, it())


def _port_params(csv_path):
    """The port's model at MODEL's widths, its tensors by name."""
    reader = SeqReader.from_single_csv(csv_path, **READER)
    return InterestEngine(InterestConfig(**MODEL), reader.n_users,
                          reader.n_items, device="cpu").params


def _served(csv_path, work_dir, out_dir, extra):
    out = export_logits.main([
        "--sample_csv", csv_path, "--min_interactions", "30",
        "--num_warmup", "10", "--d_model", "32", "--nhead", "4",
        "--num_layers_enc", "2", "--seed", "11", "--splits", "test",
        "--user_input_type", "id", "--photo_input_type", "id",
        "--test_batch_size", "64", "--work_dir", str(work_dir),
        "--out_dir", str(out_dir), "--parse_work_dir", "0",
        "--device", "cpu"] + extra)
    with open(out) as f:
        return json.load(f)


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def _max_err(got, want):
    assert set(got) == set(want) and len(want) > 10
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(v)).max())
               for k, v in want.items())


@pytest.mark.parametrize("mode", ["latest", "best"])
def test_serves_jax_fp32_checkpoint(csv_path, tmp_path, mode):
    work = tmp_path / "ckpt"
    want = _jax_checkpoint(csv_path, work)
    assert {"ckpt-latest.msgpack", "ckpt-best-ep1-0.25.msgpack"} == \
        set(os.listdir(work))
    got = _served(csv_path, work, tmp_path / "out", ["--ckpt_mode", mode])
    assert _max_err(got, want) <= PARITY_ATOL


def test_serves_jax_bf16_checkpoint(csv_path, tmp_path):
    work = tmp_path / "ckpt"
    want = _jax_checkpoint(csv_path, work, compute_dtype="bfloat16")
    with open(work / "ckpt-latest.msgpack", "rb") as f:
        tree = msgpack_restore(f.read())
    bf16 = [k for k, v in _leaves(tree["state"]["params"])
            if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16]
    assert bf16, "the bf16 engine wrote no bf16 leaf"
    extra = ["--ckpt_mode", "best", "--compute_dtype", "bfloat16"]
    got = _served(csv_path, work, tmp_path / "out", extra)
    # the same weights from a .pt checkpoint: the reader adds nothing
    pt = tmp_path / "pt"
    CheckPointer("main_metric", str(pt), mode="max").save_checkpoint(
        {"params": flax_to_state_dict(tree["state"]["params"],
                                      _port_params(csv_path))},
        1, {"main_metric": 0.25})
    assert _served(csv_path, pt, tmp_path / "out_pt", extra) == got
    assert _max_err(got, want) <= BF16_ATOL


def _assert_same(want, got, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(got, torch.Tensor):  # bf16, which numpy lacks
        assert got.dtype == torch.bfloat16, path
        want = np.asarray(want)
        assert want.dtype == jnp.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(), want.view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert np.shape(got) == np.shape(want), path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def _every_leaf_kind(rng):
    return {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "ints": {"small": 3, "neg": -7, "i16": -40_000, "u32": 3_000_000_000,
                 "big": 2 ** 40, "neg_big": -2 ** 40, "u64": 2 ** 63 + 5},
        "floats": [1.5, -0.0, 1e300, float("inf")],
        "flags": [True, False, None],
        "text": ["", "s" * 40, "é" * 200, "x" * 70_000],
        "blob": b"\x00\x01" * 200,
        "nested": [1, [2.5, "x", [None]], {"m": np.int8(-3)}],
        "complex": 1.5 - 2j,
        "scalars": [np.float32(2.5), np.int64(-9), np.bool_(True),
                    np.float16(0.5), jnp.bfloat16(1.25)],
        "bf16": jnp.asarray(rng.normal(size=(5, 3)), jnp.bfloat16),
        "empty": np.zeros((0, 3), np.int64),
        "dtypes": [np.arange(5).astype(t) for t in
                   (np.uint8, np.int16, np.uint16, np.int32, np.uint64,
                    np.float64, np.bool_, np.complex64)],
        "wide_list": list(range(20)),
        "wide_map": {f"k{i}": i for i in range(20)},
    }


def test_decoder_matches_flax_on_every_leaf_kind():
    data = fser.msgpack_serialize(_every_leaf_kind(np.random.default_rng(0)))
    _assert_same(fser.msgpack_restore(data), msgpack_restore(data))


def test_chunked_leaves(monkeypatch, tmp_path):
    """Arrays past MAX_CHUNK_SIZE bytes are written as chunked dicts (here
    past 64 bytes): fp32, bf16, nested, and a whole chunked tree."""
    rng = np.random.default_rng(1)
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    tree = {"a": {"w": rng.normal(size=(7, 5)).astype(np.float32),
                  "small": np.arange(3, dtype=np.float32)},
            "pe": jnp.asarray(rng.normal(size=(40, 3)), jnp.bfloat16)}
    data = fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = msgpack_restore(data)
    _assert_same(fser.msgpack_restore(data), got)
    assert got["a"]["w"].shape == (7, 5)
    lone = fser.msgpack_serialize(np.arange(40, dtype=np.float32))
    _assert_same(fser.msgpack_restore(lone), msgpack_restore(lone))


def test_chunked_checkpoint_serves(csv_path, tmp_path, monkeypatch):
    """A JAX checkpoint whose larger leaves were chunked serves the same
    logits."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 1024)
    work = tmp_path / "ckpt"
    want = _jax_checkpoint(csv_path, work)
    with open(work / "ckpt-latest.msgpack", "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    got = _served(csv_path, work, tmp_path / "out", ["--ckpt_mode", "latest"])
    assert _max_err(got, want) <= PARITY_ATOL


def test_both_kinds_raise(tmp_path):
    ckpt = CheckPointer("main_metric", str(tmp_path), mode="max")
    params = {"w": torch.zeros(2)}
    ckpt.save_checkpoint({"params": params}, 1, {"main_metric": 0.5})
    (tmp_path / "ckpt-latest.msgpack").write_bytes(
        fser.msgpack_serialize({"state": {"params": {}}}))
    with pytest.raises(ValueError, match="ckpt-latest.pt.*ckpt-latest.msgpack"):
        ckpt.load_checkpoint({"params": params}, "latest")


def test_resuming_training_from_msgpack_raises(tmp_path):
    """A checkpoint without optax's chain(clip, adamw) state cannot resume
    training."""
    (tmp_path / "ckpt-latest.msgpack").write_bytes(fser.msgpack_serialize(
        {"state": {"params": {}}, "num_epochs": 1, "metrics": {}}))
    ckpt = CheckPointer("main_metric", str(tmp_path), mode="max")
    with pytest.raises(ValueError, match="optax"):
        ckpt.load_checkpoint({"params": {}, "opt_state": {}}, "latest")


RESUME = dict(MODEL, dropout=0.0, remat=False, train_batch_size=16,
              loss_type="interestBPR,focal,interestCE,hazard",
              fused_attention=True, fuse_qkv=True)
RESUME_RTOL = 3e-4   # test_torch_train.py's lock-step tolerance


def _resume_batches(csv_path, n):
    reader = JaxReader.from_single_csv(csv_path, **READER)
    it = JaxIterator(reader, reader.tables["train"], 16, shuffle=True,
                     seed=3, prefetch_size=0)
    return reader, [b for _, b in zip(range(n), it)]


def _port_resume(tmp_path, cfg, reader):
    """The port's engine resumed from tmp_path's ckpt-latest.msgpack."""
    peng = InterestEngine(InterestConfig(**cfg), reader.n_users,
                          reader.n_items, device="cpu")
    ckpt = CheckPointer("main_metric", str(tmp_path), mode="max")
    assert ckpt.has_latest()
    loaded = ckpt.load_checkpoint(peng.init_state(), "latest")
    assert loaded["num_epochs"] == 2 and loaded["metrics"] == \
        {"main_metric": 0.5}
    opt = loaded["state"]["opt_state"]["state"]
    assert len(opt) == len(peng.params) and all(
        float(s["step"]) == 3 and s["exp_avg"].dtype == torch.float32
        for s in opt.values())
    return peng, loaded["state"]


def _next_losses(jeng, jstate, peng, pstate, batches):
    key = jax.random.PRNGKey(0)
    jl, pl = [], []
    for b in batches:
        jstate, jld = jeng.train_step(jstate, key, b)
        pstate, pld = peng.train_step(pstate, b)
        jl.append(float(jld["loss"]))
        pl.append(float(pld["loss"]))
    return jl, pl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resume_jax_run_lockstep(csv_path, tmp_path, dtype):
    """bfloat16: the JAX run in bf16 writes bf16 PE tables and moments.
    Both sides go on from it in fp32, the JAX side from its state widened
    as the port widens it (within 3e-4); and both in bf16 (within 1e-2:
    the frameworks round bf16 at other points, 1.8e-3 measured)."""
    reader, batches = _resume_batches(csv_path, 6)
    cfg = dict(RESUME, compute_dtype=dtype)
    jeng = JaxEngine(JaxConfig(**cfg), reader.n_users, reader.n_items)
    jstate = jeng.init_state(jax.random.PRNGKey(3), batches[0])
    for b in batches[:3]:
        jstate, _ = jeng.train_step(jstate, jax.random.PRNGKey(0), b)
    JaxCheckPointer("main_metric", str(tmp_path), mode="max") \
        .save_checkpoint(jstate, 2, {"main_metric": 0.5})
    saved = jax.tree.map(np.asarray, jstate)  # train_step donates jstate
    peng, pstate = _port_resume(tmp_path, cfg, reader)
    jl, pl = _next_losses(jeng, jstate, peng, pstate, batches[3:])
    np.testing.assert_allclose(
        pl, jl, rtol=RESUME_RTOL if dtype == "float32" else 1e-2)
    cfg32 = dict(cfg, compute_dtype="float32")
    if dtype == "bfloat16":
        with open(tmp_path / "ckpt-latest.msgpack", "rb") as f:
            tree = msgpack_restore(f.read())["state"]
        pe = [k for k, v in _leaves(tree["opt_state"])
              if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16]
        assert pe and all(k.endswith("_pe") for k in pe), pe
        jeng = JaxEngine(JaxConfig(**cfg32), reader.n_users, reader.n_items)
        wide = jax.tree.map(lambda x: jnp.asarray(
            x, jnp.float32 if x.dtype == jnp.bfloat16 else x.dtype), saved)
        peng, pstate = _port_resume(tmp_path, cfg32, reader)
        jl, pl = _next_losses(jeng, wide, peng, pstate, batches[3:])
        np.testing.assert_allclose(pl, jl, rtol=RESUME_RTOL)
    # the restored moments matter: a fresh AdamW state drifts off
    fresh = InterestEngine(InterestConfig(**cfg32), reader.n_users,
                           reader.n_items, device="cpu")
    fstate = {"params": CheckPointer("main_metric", str(tmp_path))
              .load_checkpoint({"params": fresh.params})["state"]["params"],
              "opt_state": fresh.init_state()["opt_state"]}
    fl = [float(fresh.train_step(fstate, b)[1]["loss"])
          for b in batches[3:]]
    assert max(abs(a / b - 1) for a, b in zip(fl[1:], jl[1:])) > \
        10 * RESUME_RTOL


def test_run_training_resumes_from_msgpack(csv_path, tmp_path):
    """skip_train --load 1 over the JAX run's work dir: run_training
    resumes at its epoch and writes the port's checkpoints beside it."""
    from segmminterest_tpu_torch.engine.train import run_training
    reader, batches = _resume_batches(csv_path, 1)
    cfg = dict(RESUME, epochs=2, debug=True, early_stop=0, valid_step=2)
    jeng = JaxEngine(JaxConfig(**cfg), reader.n_users, reader.n_items)
    jstate = jeng.init_state(jax.random.PRNGKey(3), batches[0])
    jstate, _ = jeng.train_step(jstate, jax.random.PRNGKey(0), batches[0])
    JaxCheckPointer("main_metric", str(tmp_path), mode="max") \
        .save_checkpoint(jstate, 1, {"main_metric": 0.5})
    res = run_training(InterestConfig(**cfg, load=True),
                       SeqReader.from_single_csv(csv_path, **READER),
                       work_dir=str(tmp_path), device="cpu")
    assert res["steps"] == 4  # one epoch of --debug's 4 steps, not two
    names = set(os.listdir(tmp_path))
    assert {"ckpt-latest.msgpack", "ckpt-latest.pt"} <= names
    # preempted again: the second resume reads the .pt, which continues
    # the .msgpack, at the epoch of its save (1, as the JAX engine counts)
    # and runs epochs 1 and 2
    cfg["epochs"] = 3
    res = run_training(InterestConfig(**cfg, load=True),
                       SeqReader.from_single_csv(csv_path, **READER),
                       work_dir=str(tmp_path), device="cpu")
    assert res["steps"] == 8
    assert torch.load(tmp_path / "ckpt-latest.pt",
                      weights_only=True)["num_epochs"] == 2
    # served as the port's own checkpoints, which it is
    serve = ["--loss_type", cfg["loss_type"], "--ckpt_mode", "latest"]
    got = _served(csv_path, tmp_path, tmp_path / "out", serve)
    alone = tmp_path / "pt_only"
    alone.mkdir()
    for n in os.listdir(tmp_path):
        if n.endswith(".pt"):
            os.link(tmp_path / n, alone / n)
    assert got == _served(csv_path, alone, tmp_path / "out2", serve)
    # a .msgpack that is not the one the run continued: two runs' files
    JaxCheckPointer("main_metric", str(tmp_path), mode="max") \
        .save_checkpoint(jstate, 2, {"main_metric": 0.5})
    with pytest.raises(ValueError, match="does not continue"):
        _served(csv_path, tmp_path, tmp_path / "out3", serve)
