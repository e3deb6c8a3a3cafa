"""The port's SegRec context models FM through FinalMLP
(segmminterest_tpu_torch/segrec/models/{fm,deepfm,sam,dcn,autoint,
finalmlp}.py) against the JAX package's on the CPU:

* each model's forward, and each option the CLI exposes (DCNv2's mixed
  and structure, FinalMLP's use_fs and its context gates, SAM's
  interaction types, xDeepFM's direct CIN), from the JAX model's weights
  converted, at test_segrec.py's synthetic_feed shapes (emb 8, B=4, I=3,
  history 20): within 1e-6 relative in evaluation, 1e-5 in training mode
  with dropout 0; the sown losses (DCNv2's reg_loss) and AFM's and
  xDeepFM's reg_loss beside them;
* each model's state loaded from the JAX runner's .msgpack (flax
  to_bytes of its params) by the runner's load_state;
* five lock-step steps (dropout 0) of one model a family, CTR on Adam
  under test_torch_segrec.py's bounds: xDeepFM (its reg_loss in the
  loss), DCNv2 mixed, AutoInt, FinalMLP;
* MultiHeadTargetAttention (SDIM's and ETA's) with and without masks;
* segrec.main --device cpu for each model in CTR and ranking mode.

The helpers here serve tests/test_torch_segrec_seq.py too.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.segrec import layers as jlayers
from segmminterest_tpu.segrec import runner as jrunner
from segmminterest_tpu.segrec.models import MODEL_REGISTRY as JAX_MODELS
from segmminterest_tpu_torch.models.convert import (_module_key,
                                                    segrec_state_dict)
from segmminterest_tpu_torch.segrec import layers, main, runner
from segmminterest_tpu_torch.segrec.corpus import Corpus
from segmminterest_tpu_torch.segrec.models import MODEL_REGISTRY
import test_torch_segrec
from test_segrec import FEATURE_MAX, FEATURES, synthetic_feed
from test_torch_segrec import (ADAM_BOUND, FWD_RTOL, LOSS_RTOL, STEPS,
                               TRAIN_FWD_RTOL, _args, _frame_equal, _rel,
                               _setups, data)  # noqa: F401 (fixture)

@pytest.fixture
def one_torch_thread():
    """Torch on one thread: the CLI runs' ops are small, and the test
    command runs six files at a time, where every worker's thread pool
    would share the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEQ = dict(user_features=["user_id"], item_features=["item_id", "i_duration"],
           situation_features=[], feature_max=FEATURE_MAX, emb_size=8)
HISTORY = 20


def models(name, use_frames=False, **kw):
    """(JAX model, port model) of one registry name at emb 8, dropout 0,
    with the options ``kw``."""
    jcls, tcls = JAX_MODELS[name], MODEL_REGISTRY[name]
    if name in ("DIEN", "CAN", "SDIM", "ETA"):
        kw = dict(SEQ, **kw)
        return jcls(**kw), tcls(**kw)
    if name.startswith("Clip"):
        kw = dict(feature_max=FEATURE_MAX, emb_size=8, use_frames=use_frames,
                  **kw)
        return jcls(**kw), tcls(**kw)
    return (jcls(FEATURES, FEATURE_MAX, emb_size=8, **kw),
            tcls(FEATURES, FEATURE_MAX, emb_size=8, **kw))


def small_feed(seed, B=4, I=3, frames=False, neg_history=False):
    """synthetic_feed at history 20, DIEN's history negatives if asked."""
    rng = np.random.default_rng(seed)
    feed = synthetic_feed(rng, B=B, I=I, L=HISTORY, with_frames=frames)
    if neg_history:
        feed["history_neg_item_id"] = rng.integers(1, FEATURE_MAX["item_id"],
                                                   size=(B, HISTORY))
        feed["history_neg_i_duration"] = rng.integers(
            1, 41, size=(B, HISTORY)).astype(np.float64)
    return feed


def flax_params(jm, tm, jfeed, jkw):
    """The flax params tree of the JAX model ``jm`` (its names and shapes,
    from ``jax.eval_shape`` of its init: nothing compiled) holding the
    port model ``tm``'s weights, each leaf found by convert.py's rules:
    a flax name without a port key fails here, and a leaf put in the
    wrong place shows in the forwards."""
    keys = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "dropout", "gumbel"))}
    shapes = jax.eval_shape(lambda f, kw: jm.init(
        keys, f, deterministic=True, **kw), jfeed, jkw)["params"]
    state = {k: v.detach().numpy() for k, v in tm.state_dict().items()}

    def leaf(path, shape):
        *mods, name = [p.key for p in path]
        base = ".".join(_module_key(m) for m in mods)
        if name == "kernel":
            arr = state[f"{base}.weight"].T
        elif name in ("embedding", "scale"):
            arr = state[f"{base}.weight"]
        else:
            arr = state[f"{base}.{name}" if base else name]
        assert arr.shape == shape.shape, (path, arr.shape, shape.shape)
        return np.array(arr, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


# A forward is held in fp32 within FWD_RTOL (1e-6) in evaluation and
# TRAIN_FWD_RTOL (1e-5) in training mode. With dropout 0 and no BatchNorm
# in these models, the JAX model's evaluation forward is its training one
# (the same Gumbel key for AdaGIN), so one JAX run, in training mode, gives
# both its scores and its sown losses. Where the JAX model's own fp32
# forward sits further from its fp64 one than the bound (FP64_CASES),
# both sides run in fp64 too, held within the bound there, and fp32 is
# held within COND times the JAX model's own fp32 rounding: DCNv2's six
# crosses on N(0, 1) weights put its fp32 scores 7.9e-6 (mixed, parallel)
# and 1.9e-5 (mixed, stacked) from its fp64 ones at these shapes, the
# port's 6.5e-6 and 8.9e-6 from JAX's fp32 (5e-14 in fp64).
COND = 4
FP64_CASES = {"DCNv2", "ClipDCNv2Rec"}


@functools.lru_cache(maxsize=None)
def jax_params(name, use_frames, kw):
    """The JAX model of ``models`` and fp32 params for it: the port's
    initial weights (init_weights from seed 0) in the flax tree
    (flax_params)."""
    jm, tm = models(name, use_frames, **dict(kw))
    layers.init_weights(tm, torch.Generator().manual_seed(0))
    feed = small_feed(7, frames=use_frames,
                      neg_history=bool(dict(kw).get("alpha_aux")))
    jkw = ({"feat_table": jnp.zeros((50, 1024), jnp.float32)}
           if use_frames else {})
    return jm, flax_params(jm, tm, {k: jnp.asarray(v)
                                    for k, v in feed.items()}, jkw)


def forward_pair(name, use_frames=False, kw=None, seed=7, feed=None,
                 noise=None):
    """The JAX (training mode) and the port's (evaluation, training mode)
    forwards on the same feed and weights, dropout 0: per (mode, dtype),
    (JAX scores, port scores, JAX's sown losses, the port's losses), fp64
    too for FP64_CASES. ``noise`` (a GumbelTap) feeds AdaGIN the JAX
    model's Gumbel draws."""
    kw = tuple(sorted((kw or {}).items()))
    jm, params = jax_params(name, use_frames, kw)
    _, tm = models(name, use_frames, **dict(kw))
    feed = feed if feed is not None else small_feed(seed, frames=use_frames)
    table = np.random.default_rng(seed + 1).normal(
        size=(50, 1024)).astype(np.float32)
    jfeed = {k: jnp.asarray(v) for k, v in feed.items()}
    tm.load_state_dict(segrec_state_dict(tm, params))
    tfeed = {k: torch.from_numpy(v) for k, v in feed.items()}
    out = {"params": params, "jax_model": jm, "model": tm}
    dtypes = ((torch.float32, jnp.float32),) + (
        ((torch.float64, jnp.float64),) if name in FP64_CASES else ())
    for dt, jdt in dtypes:
        jmd, tmd = jm.clone(dtype=jdt), copy.deepcopy(tm).to(dt)
        jkw = {"feat_table": jnp.asarray(table, jdt)} if use_frames else {}
        tkw = ({"feat_table": torch.from_numpy(table).to(dt)}
               if use_frames else {})
        if noise is not None:
            noise.reset()
        want, sown = jax.jit(lambda p, f, k, r: jmd.apply(
            p, f, deterministic=False, rngs=r, mutable=["losses"], **k))(
            {"params": params}, jfeed, jkw,
            {"gumbel": jax.random.PRNGKey(11),
             "dropout": jax.random.PRNGKey(12)})
        if noise is not None:
            tkw = dict(tkw, gumbel_noise=noise.drawn())
        jl = {k: float(v[0]) for k, v in sown.get("losses", {}).items()}
        for mode in ("eval", "train"):
            tmd.train(mode == "train")
            got, losses = tmd(tfeed, **tkw)
            out[mode, dt] = (np.asarray(want), got.detach().numpy(),
                             jl if mode == "train" else {},
                             {k: float(v.detach()) for k, v in
                              losses.items()})
    tm.eval()
    return out


def assert_forward(res, name):
    for mode, tol in (("eval", FWD_RTOL), ("train", TRAIN_FWD_RTOL)):
        want, got, jl, tl = res[mode, torch.float32]
        assert got.shape == want.shape, (name, mode)
        assert np.isfinite(got).all(), (name, mode)
        bound = tol
        if (mode, torch.float64) in res:
            want64, got64, jl64, tl64 = res[mode, torch.float64]
            assert _rel(got64, want64) <= tol, (name, mode,
                                                _rel(got64, want64))
            bound = max(tol, COND * _rel(want, want64))
            for k in jl:
                assert abs(tl64[k] - jl64[k]) <= tol * abs(jl64[k]), (name,
                                                                      k)
        assert _rel(got, want) <= bound, (name, mode, _rel(got, want), bound)
        if mode == "train":
            assert set(jl) == set(tl), (name, jl, tl)
        for k in jl:
            assert abs(tl[k] - jl[k]) <= bound * abs(jl[k]), (name, k, jl, tl)


FORWARD_CASES = {
    "FM": ("FM", {}),
    "DeepFM": ("DeepFM", {}),
    "AFM": ("AFM", dict(attention_size=8)),
    "xDeepFM": ("xDeepFM", dict(cin_layers=(4, 4))),
    "xDeepFM-direct": ("xDeepFM", dict(cin_layers=(3, 5), direct=True)),
    "SAM-SAM2E": ("SAM", {}),
    "SAM-SAM1": ("SAM", dict(interaction_type="SAM1")),
    "SAM-SAM2A": ("SAM", dict(interaction_type="SAM2A")),
    "SAM-SAM3A-residual": ("SAM", dict(interaction_type="SAM3A",
                                       num_layers=2, use_residual=True)),
    "SAM-SAM3E-mean": ("SAM", dict(interaction_type="SAM3E",
                                   aggregation="mean_pooling")),
    "DCN": ("DCN", {}),
    "DCNv2-mixed-parallel": ("DCNv2", {}),
    "DCNv2-mixed-stacked": ("DCNv2", dict(structure="stacked")),
    "DCNv2-full-parallel": ("DCNv2", dict(mixed=False)),
    "DCNv2-full-stacked": ("DCNv2", dict(mixed=False, structure="stacked")),
    "AutoInt": ("AutoInt", dict(num_heads=2, num_layers=2)),
    "FinalMLP": ("FinalMLP", {}),
    "FinalMLP-no_fs": ("FinalMLP", dict(use_fs=False)),
    "FinalMLP-fs_context": ("FinalMLP", dict(fs1_context=("i_duration",),
                                             fs2_context=("user_id",))),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_jax(case):
    name, kw = FORWARD_CASES[case]
    res = forward_pair(name, kw=kw)
    assert_forward(res, case)
    if hasattr(res["model"], "reg_loss"):
        want = float(res["jax_model"].reg_loss(res["params"]))
        got = float(res["model"].reg_loss().detach())
        assert abs(got / want - 1) <= FWD_RTOL


@pytest.mark.parametrize("masked", [False, True])
def test_target_attention_matches_jax(masked):
    rng = np.random.default_rng(3)
    tgt = rng.normal(size=(6, 16)).astype(np.float32)
    his = rng.normal(size=(6, 20, 16)).astype(np.float32)
    mask = rng.random((6, 20)) < 0.4 if masked else None
    if masked:
        mask[0] = False   # a row with nothing to attend to
    jm = jlayers.MultiHeadTargetAttention(16, 32, num_heads=2)
    args = [jnp.asarray(tgt), jnp.asarray(his)] + \
        ([jnp.asarray(mask)] if masked else [])
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              *args)["params"])
    want = np.asarray(jm.apply({"params": params}, *args))
    tm = layers.MultiHeadTargetAttention(16, 32, num_heads=2)
    tm.load_state_dict(segrec_state_dict(tm, params))
    got = tm(torch.from_numpy(tgt), torch.from_numpy(his),
             torch.from_numpy(mask) if masked else None).detach().numpy()
    assert _rel(got, want) <= FWD_RTOL


def check_load_state(name, tmp_path, kw=None, use_frames=False):
    """The JAX runner's .msgpack of ``name``'s params loads into the port's
    model through the runner's load_state, every leaf."""
    from flax import serialization
    kw = tuple(sorted((kw or {}).items()))
    _, params = jax_params(name, use_frames, kw)
    _, tm = models(name, use_frames, **dict(kw))
    path = tmp_path / f"{name}.msgpack"
    path.write_bytes(serialization.to_bytes(params))
    r = runner.CTRRunner(tm, runner.RunnerConfig(metrics=("AUC",)),
                         device="cpu")
    r.load_state(str(path))
    want = segrec_state_dict(tm, params)
    assert set(want) == set(tm.state_dict())
    for k, v in want.items():
        torch.testing.assert_close(tm.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["FM", "DeepFM", "AFM", "xDeepFM", "SAM",
                                  "DCN", "DCNv2", "AutoInt", "FinalMLP"])
def test_load_state_msgpack(name, tmp_path):
    check_load_state(name, tmp_path)


# ---------------------------------------------------------------------------
# lock-step training

def lockstep(data, case, monkeypatch, extra=(), tap=None):
    """Five CTR steps (dropout 0, Adam) of the two runners in lock step
    from the same weights and batches (test_torch_segrec.py's bounds):
    the losses within LOSS_RTOL; every weight within Adam's bound; the
    trained models' training-mode scores on a dev batch within
    LOSS_RTOL. Both start from the port's initial weights (flax_params).
    ``tap`` hands AdaGIN the JAX step's Gumbel draws."""
    dataset, model = case
    argv = _args(data, dataset, model, "Adam", 0.0, model.startswith("Clip"),
                 extra)
    args = main.build_parser().parse_args(argv)
    start = main.build_model(args, Corpus(args.path, args.dataset),
                             bool(args.clip_feature_memmap))

    def init(r, example):
        kw = {"feat_table": r.feat_table} if r.feat_table is not None \
            else {}
        p32 = flax_params(r.model, start, jrunner._device_feed(example), kw)
        return {"params": p32, "opt_state": r.optimizer.init(p32)}
    monkeypatch.setattr(test_torch_segrec, "_jax_init", init)
    s = _setups(data, argv)
    jr, jstate, jb = s["jax"]
    pr, _, pb = s["torch"]
    if tap is not None:
        def forward(batch, generator=None):
            return pr.model(batch, feat_table=pr.feat_table,
                            generator=generator,
                            gumbel_noise=tap.drawn())
        pr._forward = forward
    jb, pb, jb_dev = jb["train"], pb["train"], jb["dev"]
    jb.actions_before_epoch()
    pb.actions_before_epoch()
    jl, pl = [], []
    for step, (jf, pf) in enumerate(zip(jb.batches(48, True),
                                        pb.batches(48, True))):
        if step == STEPS:
            break
        if jr.task == "ranking":
            jf, _ = jr._shuffled_batch(jf)
            pf = pr._shuffled_batch(pf)
        _frame_equal(pf, jf, f"step {step}")
        jseed = int(jr.rng.integers(0, 2 ** 31 - 1))
        assert jseed == int(pr.rng.integers(0, 2 ** 31 - 1))
        if tap is not None:
            tap.reset()
        jstate, loss = jr._jit_train(jstate, jrunner._device_feed(jf),
                                     jax.random.PRNGKey(jseed))
        jl.append(float(loss))
        pl.append(float(pr.train_step(pf, jseed)))
    assert len(jl) == STEPS and len(set(jl)) == STEPS
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    want = segrec_state_dict(pr.model,
                             jax.tree.map(np.asarray, jstate["params"]))
    got = pr.model.state_dict()
    for k, v in want.items():
        d = np.abs(got[k].numpy() - v.numpy()).max()
        assert d <= ADAM_BOUND, (k, d)
    feed = next(jb_dev.batches(64, shuffle=False))
    if tap is not None:
        tap.reset()
    want, _ = jax.jit(lambda v, f: jr._apply(
        v, f, False, {"dropout": jax.random.PRNGKey(0),
                      "gumbel": jax.random.PRNGKey(1)},
        mutable=["losses"]))({"params": jstate["params"]},
                             jrunner._device_feed(feed))
    pr.model.train()
    with torch.no_grad():
        got = pr._forward(pr.put(feed))[0].numpy()
    pr.model.eval()
    assert _rel(got, np.asarray(want)) <= LOSS_RTOL
    return jl


LOCKSTEP = {
    "xDeepFM": ("SegMM_CTR", "xDeepFM"),
    "DCNv2-mixed": ("SegMM_CTR", "DCNv2"),
    "AutoInt": ("SegMM_CTR", "AutoInt"),
    "FinalMLP": ("SegMM_CTR", "FinalMLP"),
}


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_lockstep_matches_jax(data, case, monkeypatch):
    extra = ("--cross_layer_num", "2", "--low_rank", "8") \
        if case.startswith("DCNv2") else ()
    lockstep(data, LOCKSTEP[case], monkeypatch, extra)


# ---------------------------------------------------------------------------
# the CLI, on the CPU

def run_main(data, name, mode, tmp_path, extra=()):
    """segrec.main --device cpu for one epoch in CTR or ranking mode,
    without a segment table (the lock-step cases read one): finite metrics
    on dev and test. DCNv2's crosses cut to 2 layers of rank 8."""
    dataset = "SegMM_CTR" if mode == "CTR" else "SegMM"
    if "DCNv2" in name:
        extra = ("--cross_layer_num", "2", "--low_rank", "8") + tuple(extra)
    argv = _args(data, dataset, name, "Adam", 0.0, False,
                 ("--epoch", "1", "--device", "cpu", "--topk", "1,3",
                  "--batch_size", "256", "--eval_batch_size", "256")
                 + tuple(extra))
    res = main.main(argv)
    for split in ("dev", "test"):
        assert res[split] and all(np.isfinite(v)
                                  for v in res[split].values()), res
    if mode != "CTR":
        assert 0.0 <= res["test"]["HR@1"] <= res["test"]["HR@3"] <= 1.0
    return res


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("mode", ["CTR", "Ranking"])
@pytest.mark.parametrize("name", ["FM", "DeepFM", "AFM", "xDeepFM", "SAM",
                                  "DCN", "DCNv2", "AutoInt", "FinalMLP"])
def test_main_cpu_runs(data, name, mode, tmp_path):
    run_main(data, name, mode, tmp_path)
