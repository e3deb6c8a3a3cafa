"""The port's SegRec (segmminterest_tpu_torch/segrec) against the JAX
package's on the CPU:

* each ported model's forward (ClipWDRec with frames off and on and both
  contrastive terms, ClipDINRec under each norm_interest_type, with
  duration_mask and adjust_interest_weight, WideDeep, DIN) from the JAX
  model's weights converted, at test_segrec.py's synthetic_feed shapes:
  within 1e-6 relative in evaluation and in a training forward (BatchNorm
  on batch statistics), the updated BatchNorm statistics too;
* the losses and metrics on the same arrays;
* Corpus and FeedBuilder on data built from data/synthetic.py's CSV by the
  port's build_segrec_data: every column and batch equal key by key and
  dtype by dtype (negatives and shuffles the same bits);
* five lock-step steps (dropout 0) of CTR ClipWDRec over frames, CTR
  ClipDINRec and ranking ClipWDRec on Adam, CTR WideDeep on Adagrad with
  l2, on SGD and on Adadelta: losses within 3e-4 relative (test_torch_train.py's), the trained
  models' scores and BatchNorm variances within 3e-4; each weight's change
  within 3e-4 of JAX's change (relative to the leaf's largest change, plus
  the rounding of the weights) on Adagrad, SGD and Adadelta, within Adam's
  bound on Adam (see ADAM_BOUND);
* chip_smoke.py's 32-row steps (phase segrec, card against CPU) in fp32
  against fp64 on the CPU, within the chip check's tolerances;
* segrec.main --device cpu against the JAX main on the same directory from
  the same .msgpack weights: the metrics within 1e-5 and the
  save_final_results file; the guard (no card without --device cpu); the
  Impression, KG and leave-rank routes run; the sequential models' feed
  flags build their feeds.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.segrec import feeds as jfeeds
from segmminterest_tpu.segrec import main as jmain
from segmminterest_tpu.segrec import runner as jrunner
from segmminterest_tpu.segrec.corpus import Corpus as JaxCorpus
from segmminterest_tpu.segrec.models import MODEL_REGISTRY as JAX_MODELS
from segmminterest_tpu_torch.data.feature_store import FeatureStore
from segmminterest_tpu_torch.data.synthetic import write_synthetic_csv
from segmminterest_tpu_torch.models.convert import segrec_state_dict
from segmminterest_tpu_torch.segrec import feeds, main, runner
from segmminterest_tpu_torch.segrec.corpus import Corpus
from segmminterest_tpu_torch.segrec.models import MODEL_REGISTRY
from segmminterest_tpu_torch.tasks import (build_leave_rank_data,
                                           build_segrec_data)
from test_segrec import FEATURE_MAX, FEATURES, synthetic_feed

FWD_RTOL = 1e-6
# a training forward normalises by the batch's variance, E[x^2] - E[x]^2 in
# fp32 (flax's fast variance), which cancels the leading digits the two
# frameworks' sums round differently: 3.4e-6 measured
TRAIN_FWD_RTOL = 1e-5
LOSS_RTOL = 3e-4
# Adam moves each weight by at most about lr a step whatever its gradient;
# where the gradient (nearly) cancels — a bias under BPR, which sees score
# differences only, a Dense bias before a training BatchNorm — its rounding
# picks the sign, so under Adam a weight can only be held to that bound. The
# trained weights are held to the function the loss sees instead: their
# training forward's scores within LOSS_RTOL; and the BatchNorm statistics
# (the running mean after such a bias drifts with it, the variances and
# Dice's statistics do not). Adagrad, SGD and Adadelta move a weight in
# proportion to its gradient, by 1e-8 to 1e-3 here: each leaf's change is
# held to JAX's change, LOSS_RTOL of the leaf's largest change plus
# ROUND_ULPS of the weights' rounding (one half-ulp a step on each side).
LR, STEPS = 1e-3, 5
ADAM_BOUND = 2 * STEPS * LR
ROUND_ULPS = STEPS * np.finfo(np.float32).eps
METRIC_ATOL = 1e-5


# ---------------------------------------------------------------------------
# models at synthetic_feed's shapes

def _models(name, use_frames=False, **kw):
    """(JAX model, port model) of one registry name at emb 8, dropout 0."""
    jcls, tcls = JAX_MODELS[name], MODEL_REGISTRY[name]
    if name == "WideDeep":
        return (jcls(FEATURES, FEATURE_MAX, emb_size=8),
                tcls(FEATURES, FEATURE_MAX, emb_size=8))
    if name == "DIN":
        args = (["user_id"], ["item_id", "i_duration"], [], FEATURE_MAX)
        return jcls(*args, emb_size=8), tcls(*args, emb_size=8)
    if name == "ClipWDRec":
        kw = dict(feature_max=FEATURE_MAX, emb_dim=8, use_frames=use_frames,
                  **kw)
    else:
        kw = dict(feature_max=FEATURE_MAX, emb_size=8, has_duration=True,
                  use_frames=use_frames, **kw)
    return jcls(**kw), tcls(**kw)


FORWARD_CASES = {
    "ClipWDRec": ("ClipWDRec", False, {}),
    "ClipWDRec-frames": ("ClipWDRec", True, {}),
    "ClipWDRec-ContrastiveLoss": ("ClipWDRec", True,
                                  dict(contrastive="ContrastiveLoss")),
    "ClipWDRec-infoNCELoss": ("ClipWDRec", True,
                              dict(contrastive="infoNCELoss")),
    "ClipWDRec-duration_mask-adjust": ("ClipWDRec", True, dict(
        duration_mask=True, adjust_interest_weight=True)),
    "ClipDINRec-none": ("ClipDINRec", False, {}),
    "ClipDINRec-frames-softmax": ("ClipDINRec", True, dict(
        norm_interest_type="softmax", duration_mask=True)),
    "ClipDINRec-sigmoid": ("ClipDINRec", False, dict(
        norm_interest_type="sigmoid")),
    "ClipDINRec-frames-sigmoid-duration_mask": ("ClipDINRec", True, dict(
        norm_interest_type="sigmoid", duration_mask=True)),
    "ClipDINRec-adjust": ("ClipDINRec", True, dict(
        adjust_interest_weight=True)),
    "WideDeep": ("WideDeep", False, {}),
    "DIN": ("DIN", False, {}),
}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_jax(case):
    name, use_frames, kw = FORWARD_CASES[case]
    rng = np.random.default_rng(7)
    jm, tm = _models(name, use_frames, **kw)
    feed = synthetic_feed(rng, with_frames=use_frames)
    table = rng.normal(size=(50, 1024)).astype(np.float32)
    jfeed = {k: jnp.asarray(v) for k, v in feed.items()}
    jkw = {"feat_table": jnp.asarray(table)} if use_frames else {}
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jfeed,
                        deterministic=True, **jkw)
    params = jax.tree.map(np.asarray, variables["params"])
    # trainable interest weights and BatchNorm statistics away from their
    # initial ones and zeros, so that they take part
    if "trainable_interest_weight" in params:
        params["trainable_interest_weight"] = (
            1 + 0.25 * rng.normal(size=40)).astype(np.float32)
    stats = jax.tree.map(
        lambda x: (x + rng.random(x.shape)).astype(np.float32),
        variables.get("batch_stats", {}))
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    tm.load_state_dict(segrec_state_dict(tm, params, stats or None))
    tfeed = {k: torch.from_numpy(v) for k, v in feed.items()}
    tkw = {"feat_table": torch.from_numpy(table)} if use_frames else {}

    want, jsown = jm.apply(variables, jfeed, deterministic=True,
                           mutable=["losses"], **jkw)
    tm.eval()
    got, losses = tm(tfeed, **tkw)
    assert got.shape == want.shape == (4, 3)
    assert _rel(got.detach().numpy(), want) <= FWD_RTOL
    jaux = jax.tree_util.tree_leaves(jsown.get("losses", {}))
    assert len(jaux) == len(losses) == (1 if kw.get("contrastive") else 0)
    if jaux:
        assert _rel(losses["contrastive_loss"].item(), jaux[0]) <= FWD_RTOL

    # a training forward: BatchNorm on the batch's statistics, which move
    # the running ones by flax's rule
    mutable = ["losses"] + (["batch_stats"] if stats else [])
    want, mutated = jm.apply(variables, jfeed, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(1)},
                             mutable=mutable, **jkw)
    tm.train()
    got, _ = tm(tfeed, **tkw)
    assert _rel(got.detach().numpy(), want) <= TRAIN_FWD_RTOL
    if stats:
        new = segrec_state_dict(tm, params, mutated["batch_stats"])
        for k, v in tm.state_dict().items():
            if k.endswith((".mean", ".var")):
                assert _rel(v.numpy(), new[k].numpy()) <= FWD_RTOL, k


def test_losses_and_metrics_match_jax():
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(16, 5)).astype(np.float32)
    mask = np.arange(16) < 13
    for jf, tf in ((jrunner.bpr_loss, runner.bpr_loss),
                   (jrunner.bce_ranking_loss, runner.bce_ranking_loss)):
        want = float(jf(jnp.asarray(pred), jnp.asarray(mask)))
        got = float(tf(torch.from_numpy(pred), torch.from_numpy(mask)))
        assert abs(got / want - 1) <= FWD_RTOL
    probs = rng.random(16).astype(np.float32)
    labels = (rng.random(16) < 0.5).astype(np.float32)
    want = float(jrunner.bce_ctr_loss(jnp.asarray(probs), jnp.asarray(labels),
                                      jnp.asarray(mask)))
    got = float(runner.bce_ctr_loss(torch.from_numpy(probs),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(mask)))
    assert abs(got / want - 1) <= FWD_RTOL

    scores = rng.normal(size=(64, 20))
    scores[:5] = 0.0  # ties
    assert runner.evaluate_ranking(scores, [1, 5, 10], ["HR", "NDCG"]) == \
        jrunner.evaluate_ranking(scores, [1, 5, 10], ["HR", "NDCG"])
    tied = np.zeros((8, 4))  # every row tied: the seeded fallback
    assert runner.evaluate_ranking(tied, [1, 2], ["HR"],
                                   np.random.default_rng(5)) == \
        jrunner.evaluate_ranking(tied, [1, 2], ["HR"],
                                 np.random.default_rng(5))
    p = rng.random(300)
    y = (rng.random(300) < 0.4).astype(float)
    users = rng.integers(0, 7, size=300)
    users[users == 6] = 5
    y[users == 5] = 1.0  # a user with one class only: skipped
    metrics = ["AUC", "F1_SCORE", "LOG_LOSS", "ACC"]
    assert runner.evaluate_ctr(p, y, metrics) == \
        jrunner.evaluate_ctr(p, y, metrics)
    assert runner.evaluate_wuauc(p, y, users) == \
        jrunner.evaluate_wuauc(p, y, users)


def test_clip_weights_keys_and_neg_table(tmp_path):
    """FREEDOM files use {uid}-{iid} keys; a missing target key gives ones,
    a missing negative raises (BaseModel.py:129-145)."""
    fp = tmp_path / "FREEDOM_logits.json"
    fp.write_text(json.dumps({"7-99": [0.5] * 40}))
    neg = tmp_path / "neg.json"
    neg.write_text(json.dumps({"7-99": [0.25] * 40}))
    cw = feeds.ClipWeights(str(fp), neg_weight_path=str(neg))
    assert cw.freedom_keys
    np.testing.assert_array_equal(cw.target_slice(7, 99, 12345),
                                  np.full(40, 0.5, np.float32))
    np.testing.assert_array_equal(cw.target_slice(8, 99, 1),
                                  np.ones(40, np.float32))
    np.testing.assert_array_equal(cw.neg_slice(7, 99, 1),
                                  np.full(40, 0.25, np.float32))
    with pytest.raises(KeyError, match="8-99"):
        cw.neg_slice(8, 99, 1)
    fp2 = tmp_path / "interest_logits.json"
    fp2.write_text(json.dumps({"70-990-5": [0.1] * 40}))
    cw2 = feeds.ClipWeights(str(fp2), id2user={"7": "70"},
                            id2item={"99": "990"})
    np.testing.assert_array_equal(cw2.target_slice(7, 99, 5),
                                  np.full(40, 0.1, np.float32))


# ---------------------------------------------------------------------------
# data built from data/synthetic.py's CSV

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The CTR and ranking datasets of a synthetic CSV, Task-1 logits for
    most CTR rows (keys of raw ids, as export_logits writes them), and a
    segment table over part of the items (keys of dense item ids)."""
    d = tmp_path_factory.mktemp("segrec")
    csv = write_synthetic_csv(str(d / "inter.csv"), n_users=12,
                              per_user=(40, 60), n_videos=150, seed=5)
    build_segrec_data.main(["--inter_csv", csv, "--out", str(d),
                            "--name", "SegMM", "--min_interactions", "30",
                            "--num_warmup", "10", "--n_eval_neg", "9"])
    rng = np.random.default_rng(0)
    base = d / "SegMM_CTR"
    id2user = json.loads((base / "id2user.json").read_text())
    id2item = json.loads((base / "id2item.json").read_text())
    logits = {}
    for split in ("train", "dev", "test"):
        rows = (base / f"{split}.csv").read_text().splitlines()[1:]
        for row in rows[::4] + rows[1::4] + rows[2::4]:
            u, i, t = row.split("\t")[:3]
            logits[f"{id2user[u]}-{id2item[i]}-{t}"] = \
                rng.normal(size=40).round(6).tolist()
    (d / "logits.json").write_text(json.dumps(logits))
    n_items = len(id2item) + 1
    lineid, line = {}, 0
    for iid in range(1, n_items, 2):
        for f in range(int(rng.integers(0, 12))):
            if rng.random() < 0.9:
                lineid[f"{iid}-{f}"] = line
                line += 1
    (d / "lineid.json").write_text(json.dumps(lineid))
    mm = np.memmap(str(d / "feat.dat"), dtype="float32", mode="w+",
                   shape=(line, 1024))
    mm[:] = rng.normal(size=mm.shape)
    mm.flush()
    return dict(dir=str(d), logits=str(d / "logits.json"),
                memmap=str(d / "feat.dat"), lineid=str(d / "lineid.json"))


def _frame_equal(got, want, what):
    assert list(got) == list(want), what
    for k in want:
        w = np.asarray(want[k])
        g = np.asarray(got[k])
        assert g.dtype == w.dtype, f"{what}/{k}: {g.dtype} vs {w.dtype}"
        if w.dtype == object:
            assert g.tolist() == w.tolist(), f"{what}/{k}"
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}/{k}")


@pytest.mark.parametrize("dataset", ["SegMM_CTR", "SegMM"])
def test_corpus_matches_jax(data, dataset):
    want = JaxCorpus(data["dir"], dataset)
    got = Corpus(data["dir"], dataset)
    for split in ("train", "dev", "test"):
        df = want.data_df[split]
        _frame_equal(got.data_df[split],
                     {c: df[c].to_numpy() for c in df.columns}, split)
        if want.neg_items[split] is None:
            assert got.neg_items[split] is None
        else:
            _frame_equal({"n": got.neg_items[split]},
                         {"n": want.neg_items[split]}, split)
    for attr in ("n_users", "n_items", "feature_max", "item_feature_names",
                 "user_feature_names", "situation_feature_names",
                 "train_clicked_set", "residual_clicked_set", "has_label"):
        assert getattr(got, attr) == getattr(want, attr), attr
    _frame_equal(got.item_features_arr, want.item_features_arr, "items")
    for attr in ("user_his_items", "user_his_times"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert list(g) == list(w)
        _frame_equal({str(k): v for k, v in g.items()},
                     {str(k): v for k, v in w.items()}, attr)


FEED_CASES = {
    "ctr-train-clip-frames": ("SegMM_CTR", "ctr", "train", False, True),
    "ctr-test-history": ("SegMM_CTR", "ctr", "test", True, False),
    "ranking-train-history-clip": ("SegMM", "ranking", "train", True, True),
    "ranking-dev": ("SegMM", "ranking", "dev", False, False),
}


@pytest.mark.parametrize("case", list(FEED_CASES))
def test_feeds_match_jax(data, case):
    dataset, task, phase, history, extras = FEED_CASES[case]
    out = []
    for corpus_cls, mod, store_cls in (
            (JaxCorpus, jfeeds, None), (Corpus, feeds, FeatureStore)):
        corpus = corpus_cls(data["dir"], dataset)
        id2 = [json.loads(open(os.path.join(data["dir"], dataset, f)).read())
               for f in ("id2user.json", "id2item.json")]
        kw = {}
        if extras:
            kw["clip_weights"] = mod.ClipWeights(data["logits"], *id2)
            if store_cls is None:
                from segmminterest_tpu.data.feature_store import \
                    FeatureStore as store_cls
            kw["feature_store"] = store_cls.open(data["memmap"],
                                                 data["lineid"])
        b = mod.FeedBuilder(corpus, phase, task=task, num_neg=3,
                            history_max=5, include_history=history, seed=9,
                            **kw)
        batches = []
        for _ in range(2):  # two epochs: negatives and order drawn anew
            b.actions_before_epoch()
            batches += list(b.batches(32, shuffle=phase == "train"))
        out.append(batches)
    want, got = out
    assert len(got) == len(want) > 2
    for i, (g, w) in enumerate(zip(got, want)):
        _frame_equal(g, w, f"batch {i}")
    keys = set(want[0])
    assert ("c_interest_weight" in keys) == extras
    assert ("item_frame_lines" in keys) == extras
    assert ("history_item_id" in keys) == history
    if extras:  # the table serves some segments, not all
        lines = np.concatenate([b["item_frame_lines"].ravel()
                                for b in want])
        assert (lines >= 0).any() and (lines < 0).any()


# ---------------------------------------------------------------------------
# lock-step training

LOCKSTEP = {
    "ctr-ClipWDRec-frames": ("SegMM_CTR", "ClipWDRec", "Adam", 0.0, True),
    "ctr-ClipDINRec": ("SegMM_CTR", "ClipDINRec", "Adam", 0.0, True),
    "ranking-ClipWDRec": ("SegMM", "ClipWDRec", "Adam", 0.0, False),
    "ctr-WideDeep-adagrad-l2": ("SegMM_CTR", "WideDeep", "Adagrad", 1e-3,
                                False),
    "ctr-WideDeep-sgd": ("SegMM_CTR", "WideDeep", "SGD", 0.0, False),
    "ctr-WideDeep-adadelta": ("SegMM_CTR", "WideDeep", "Adadelta", 0.0,
                              False),
}


def _args(data, dataset, model, optimizer, l2, frames, extra=()):
    argv = ["--model_name", model, "--path", data["dir"],
            "--dataset", dataset, "--emb_size", "16", "--dnn_layers", "[32]",
            "--att_layers", "[16]", "--layers", "[32]", "--history_max", "6",
            "--batch_size", "48", "--eval_batch_size", "64",
            "--optimizer", optimizer, "--l2", str(l2), "--lr", str(LR),
            "--clip_weight_path", data["logits"],
            "--model_mode", "CTR" if dataset.endswith("CTR") else "Ranking",
            "--num_neg", "3", "--use_mesh", "0"]
    if frames:
        argv += ["--clip_feature_memmap", data["memmap"],
                 "--lineid_map", data["lineid"]]
    return argv + list(extra)


def _setups(data, argv):
    """The JAX runner and state, the port's runner from the same weights,
    and each side's train builder, as the two mains make them."""
    from segmminterest_tpu.data.feature_store import FeatureStore as JStore
    out = {}
    for side in ("jax", "torch"):
        m = jmain if side == "jax" else main
        args = m.build_parser().parse_args(argv)
        task = "ctr" if args.model_mode == "CTR" else "ranking"
        corpus = (JaxCorpus if side == "jax" else Corpus)(args.path,
                                                          args.dataset)
        base = os.path.join(args.path, args.dataset)
        id2 = [json.loads(open(os.path.join(base, f)).read())
               for f in ("id2user.json", "id2item.json")]
        fm = jfeeds if side == "jax" else feeds
        cw = fm.ClipWeights(args.clip_weight_path, *id2)
        store = None
        if args.clip_feature_memmap:
            store = (JStore if side == "jax" else FeatureStore).open(
                args.clip_feature_memmap, args.lineid_map)
        hist = args.model_name in m.SEQ_MODELS
        builders = {p: fm.FeedBuilder(corpus, p, task=task,
                                      num_neg=args.num_neg,
                                      history_max=args.history_max,
                                      include_history=hist,
                                      neg_history=(args.alpha_aux > 0
                                                   and hist),
                                      clip_weights=cw,
                                      feature_store=store, seed=0)
                    for p in ("train", "dev", "test")}
        table = np.asarray(store.feat) if store else None
        cfg_kw = dict(lr=args.lr, l2=args.l2, batch_size=args.batch_size,
                      eval_batch_size=args.eval_batch_size,
                      optimizer=args.optimizer, epoch=1, seed=0,
                      metrics=("AUC", "LOG_LOSS") if task == "ctr"
                      else ("NDCG", "HR"), topk=(1, 3),
                      loss_n="BCE" if task == "ctr" else "BPR")
        if side == "jax":
            model = jmain.build_model(args, corpus, store is not None)
            cls = jrunner.CTRRunner if task == "ctr" else \
                jrunner.RankingRunner
            r = cls(model, jrunner.RunnerConfig(**cfg_kw), feat_table=table)
            if task == "ranking":
                builders["train"].actions_before_epoch()
                example = next(builders["train"].batches(args.batch_size,
                                                         shuffle=False))
            else:
                example = next(builders["dev"].batches(
                    args.eval_batch_size, shuffle=False))
            state = _jax_init(r, example)
            out[side] = (r, state, builders)
        else:
            model = main.build_model(args, corpus, store is not None)
            cls = runner.CTRRunner if task == "ctr" else runner.RankingRunner
            r = cls(model, runner.RunnerConfig(**cfg_kw), feat_table=table,
                    device="cpu")
            if task == "ranking":
                builders["train"].actions_before_epoch()
            jstate = out["jax"][1]
            model.load_state_dict(segrec_state_dict(
                model, jax.tree.map(np.asarray, jstate["params"]),
                jax.tree.map(np.asarray, jstate.get("batch_stats"))
                if "batch_stats" in jstate else None))
            out[side] = (r, None, builders)
    return out


def _jax_init(r, example):
    """The JAX runner's init_state, its model.init under one jit (the same
    values; the runner's eager init compiles op by op)."""
    kw = {"feat_table": r.feat_table} if r.feat_table is not None else {}
    key = jax.random.PRNGKey(r.cfg.seed)
    variables = jax.jit(lambda f: r.model.init(
        {"params": key, "dropout": key, "gumbel": key}, f,
        deterministic=True, **kw))(jrunner._device_feed(example))
    state = {"params": variables["params"],
             "opt_state": r.optimizer.init(variables["params"])}
    if "batch_stats" in variables:
        state["batch_stats"] = variables["batch_stats"]
    return state


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_lockstep_matches_jax(data, case):
    dataset, model, opt, l2, frames = LOCKSTEP[case]
    s = _setups(data, _args(data, dataset, model, opt, l2, frames))
    jr, jstate, jb = s["jax"]
    pr, _, pb = s["torch"]
    jb, pb, jb_dev = jb["train"], pb["train"], jb["dev"]
    jb.actions_before_epoch()
    pb.actions_before_epoch()
    init = {k: v.numpy().astype(np.float64)
            for k, v in pr.model.state_dict().items()}
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
        pseed = int(pr.rng.integers(0, 2 ** 31 - 1))
        assert jseed == pseed
        jstate, loss = jr._jit_train(jstate, jrunner._device_feed(jf),
                                     jax.random.PRNGKey(jseed))
        jl.append(float(loss))
        pl.append(float(pr.train_step(pf, pseed)))
    assert len(jl) == STEPS and len(set(jl)) == STEPS
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    want = segrec_state_dict(
        pr.model, jax.tree.map(np.asarray, jstate["params"]),
        jax.tree.map(np.asarray, jstate["batch_stats"])
        if "batch_stats" in jstate else None)
    got = pr.model.state_dict()
    assert ("batch_stats" in jstate) == (model == "ClipDINRec")
    for k, v in want.items():
        v = v.numpy()
        d = np.abs(got[k].numpy() - v).max()
        if k.endswith(".var"):
            assert d <= LOSS_RTOL * np.abs(v).max(), (k, d)
        elif k.endswith("BatchNorm_0.mean"):  # in units of its deviation
            std = np.sqrt(want[k[:-len("mean")] + "var"].numpy()).max()
            assert d <= LOSS_RTOL * std, (k, d)
        elif opt == "Adam":
            assert d <= ADAM_BOUND, (k, d)
        else:
            moved = v - init[k]
            assert np.abs(moved).max() > 0, k
            bound = (LOSS_RTOL * np.abs(moved).max()
                     + ROUND_ULPS * np.abs(v).max())
            assert d <= bound, (k, d, bound)
    # the function the trained weights compute as the loss sees it: in
    # training (BatchNorm on the batch's statistics, which the drift of a
    # bias before it leaves unchanged), BPR's candidates' differences from
    # the target
    feed = next(jb_dev.batches(64, shuffle=False))
    variables = {k: v for k, v in jstate.items() if k != "opt_state"}
    want, _ = jax.jit(lambda v, f: jr._apply(
        v, f, False, {"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats", "losses"]))(variables,
                                            jrunner._device_feed(feed))
    want = np.asarray(want)
    pr.model.train()
    with torch.no_grad():
        got = pr._forward(pr.put(feed))[0].numpy()
    if jr.task == "ranking":
        want, got = want - want[:, :1], got - got[:, :1]
    assert _rel(got, want) <= LOSS_RTOL


def test_load_state_msgpack_full_and_partial(data, tmp_path):
    """The JAX runner's saved params (flax to_bytes of the params tree)
    load in full and in part; a .pt state_dict round-trips."""
    from flax import serialization
    s = _setups(data, _args(data, "SegMM_CTR", "WideDeep", "Adam", 0.0,
                            False))
    jr, jstate, _ = s["jax"]
    pr = s["torch"][0]
    params = jax.tree.map(np.asarray, jstate["params"])
    path = tmp_path / "wd.msgpack"
    path.write_bytes(serialization.to_bytes(params))
    want = segrec_state_dict(pr.model, params)
    for partial in (False, True):
        with torch.no_grad():
            for p in pr.model.parameters():
                p.zero_()
        pr.load_state(str(path), partial=partial)
        for k, v in want.items():
            torch.testing.assert_close(pr.model.state_dict()[k], v,
                                       rtol=0, atol=0)
    pt = str(tmp_path / "wd.pt")
    pr.save_state(pr.state(), pt)
    pr.load_state(pt)
    with pytest.raises(KeyError, match="keys differ"):
        torch.save({"x": torch.zeros(1)}, pt)
        pr.load_state(pt)


def test_read_csv_dtypes_match_pandas(tmp_path):
    """The reader types a column as pandas does where it reaches a feed: an
    integer column with an empty cell becomes float64 with NaN."""
    import pandas as pd
    from segmminterest_tpu_torch.data.reader import read_csv
    path = tmp_path / "t.csv"
    path.write_text("user_id\titem_id\tc_hour_c\ti_x\tneg_items\n"
                    "1\t2\t\t1.5\t[1, 2]\n3\t4\t7\t\t[3, 4]\n")
    got, want = read_csv(str(path), sep="\t"), pd.read_csv(path, sep="\t")
    assert list(got) == list(want.columns)
    for c in want.columns:
        if want[c].dtype.kind in "if":
            assert got[c].dtype == want[c].dtype, c
            np.testing.assert_array_equal(got[c], want[c].to_numpy())
        else:
            assert got[c].tolist() == want[c].tolist()


# ---------------------------------------------------------------------------
# the chip script's 32-row steps, in fp32 and fp64 on the CPU

@pytest.fixture(scope="module")
def chip_steps(tmp_path_factory):
    """chip_smoke.py's phase segrec (c) on the CPU: its corpus (train_cli's
    synthetic CSV), its weights and batches; random Task-1 logits for every
    train row stand in for export_logits'."""
    import chip_smoke as CS
    d = tmp_path_factory.mktemp("chip_segrec")
    csv = write_synthetic_csv(str(d / "inter.csv"), n_users=150,
                              per_user=(250, 300), n_videos=10_000, seed=1)
    build_segrec_data.main(["--inter_csv", csv, "--out", str(d), "--name",
                            "SegMM", "--min_interactions", "100",
                            "--num_warmup", "80"])
    base = d / "SegMM_CTR"
    id2 = [json.loads((base / f).read_text())
           for f in ("id2user.json", "id2item.json")]
    rng = np.random.default_rng(0)
    logits = {}
    for row in (base / "train.csv").read_text().splitlines()[1:]:
        u, i, t = row.split("\t")[:3]
        logits[f"{id2[0][u]}-{id2[1][i]}-{t}"] = \
            rng.normal(size=40).round(6).tolist()
    (d / "logits.json").write_text(json.dumps(logits))
    clip = feeds.ClipWeights(str(d / "logits.json"), *id2)
    return CS, CS._segrec_steps(Corpus(str(d), "SegMM_CTR"), clip, "cpu")


@pytest.mark.parametrize("i", range(7))
def test_chip_step_fp32_against_fp64(chip_steps, i):
    """Each 32-row step the chip script holds card against CPU, here the
    CPU's fp32 step against fp64 (loss, gradient norm, evaluation scores),
    within the chip check's tolerance: what rounding alone moves.
    ClipDINRec's gradient norm reads 2.4e-6 on the weights-of-ones batch,
    the reason its check is held to 1e-5."""
    CS, steps = chip_steps
    assert len(steps) == 7
    name, what, tried, again, cpu, fp64 = steps[i]
    # the CPU's step is deterministic; these random logits leave gradients
    assert again[:2] == cpu[:2] and cpu[1] > 0
    np.testing.assert_array_equal(again[2], cpu[2])
    rounding = CS._rel_errs(cpu, fp64)
    print(f"{name} ({what}, batch {tried}): loss {rounding[0]:.2e}, "
          f"gradient norm {rounding[1]:.2e}, scores {rounding[2]:.2e} "
          "relative against fp64")
    assert max(rounding) <= (CS.SEGREC_RTOL_CLIPDIN if name == "ClipDINRec"
                             else CS.SEGREC_RTOL), (name, what, rounding)


# ---------------------------------------------------------------------------
# the CLI

def _read_results(path):
    files = [f for f in os.listdir(path) if f.startswith("rec-")]
    assert len(files) == 1, files
    with open(os.path.join(path, files[0])) as f:
        return files[0], [line.split("\t") for line in f.read().splitlines()]


def test_main_cpu_matches_jax(data, tmp_path):
    """The JAX main trains one epoch and saves its params (.msgpack); both
    mains evaluate them (--train 0) and write save_final_results; then
    both go on training from them for an epoch (--load 1)."""
    ckpt = str(tmp_path / "clipwd.msgpack")
    argv = _args(data, "SegMM_CTR", "ClipWDRec", "Adam", 0.0, True)
    jmain.main(argv + ["--epoch", "1", "--model_path", ckpt])
    results = {}
    for side, m in (("jax", jmain), ("torch", main)):
        rdir = str(tmp_path / side)
        extra = ["--train", "0", "--model_path", ckpt,
                 "--save_final_results", "1", "--result_dir", rdir]
        if side == "torch":
            extra += ["--device", "cpu"]
        results[side] = m.main(argv + extra)
    for split in ("dev", "test"):
        want, got = results["jax"][split], results["torch"][split]
        assert list(got) == list(want) and "WUAUC" in got
        for k in want:
            assert abs(got[k] - want[k]) <= METRIC_ATOL, (split, k)
    jname, jrows = _read_results(str(tmp_path / "jax"))
    pname, prows = _read_results(str(tmp_path / "torch"))
    assert pname == jname and prows[0] == jrows[0] == \
        ["user_id", "pCTR", "label"]
    assert len(prows) == len(jrows) > 10
    for p, j in zip(prows[1:], jrows[1:]):
        assert p[0] == j[0] and p[2] == j[2]
        assert abs(float(p[1]) - float(j[1])) <= 1e-6

    trained = {}
    for side, m in (("jax", jmain), ("torch", main)):
        path = str(tmp_path / f"{side}_start.msgpack")
        shutil.copy(ckpt, path)
        extra = ["--epoch", "1", "--load", "1", "--model_path", path]
        if side == "torch":
            extra += ["--device", "cpu"]
        trained[side] = m.main(argv + extra)
    # the port writes the state it trained from a .msgpack beside it
    assert os.path.exists(tmp_path / "torch_start.pt")
    for split in ("dev", "test"):
        for k in ("LOG_LOSS", "AUC", "WUAUC"):
            assert np.isfinite(trained["torch"][split][k])
        assert abs(trained["torch"][split]["LOG_LOSS"]
                   - trained["jax"][split]["LOG_LOSS"]) <= METRIC_ATOL


def test_main_ranking_and_din_cpu(data, tmp_path):
    """Ranking ClipWDRec and CTR ClipDINRec through the CLI, all_inference
    and .pt save / load."""
    argv = _args(data, "SegMM", "ClipWDRec", "Adam", 0.0, False)
    res = main.main(argv + ["--epoch", "1", "--device", "cpu", "--topk",
                            "1,3", "--all_inference", "1", "--result_dir",
                            str(tmp_path)])
    assert 0.0 <= res["test"]["HR@1"] <= res["test"]["HR@3"] <= 1.0
    with open(tmp_path / "inference_scores-ClipWDRecRanking.csv") as f:
        rows = f.read().splitlines()
    assert rows[0] == "user_id\ttime\titem_id\tpredictions"
    pt = str(tmp_path / "din.pt")
    argv = _args(data, "SegMM_CTR", "ClipDINRec", "Adam", 0.0, True)
    res = main.main(argv + ["--epoch", "1", "--device", "cpu",
                            "--model_path", pt])
    again = main.main(argv + ["--train", "0", "--device", "cpu",
                              "--model_path", pt])
    for k in ("AUC", "LOG_LOSS", "WUAUC"):
        assert np.isfinite(res["test"][k])
        assert again["test"][k] == res["test"][k]


def test_main_needs_the_card_or_cpu(data):
    """Without --device cpu the CLI asks for the card and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = _args(data, "SegMM_CTR", "ClipWDRec", "Adam", 0.0, False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main.main(argv + ["--epoch", "1"])


@pytest.fixture(scope="module")
def other_routes_data(data):
    """The KG metadata (build_segrec_data --kg_meta 1, as SegKG) and the
    leave-rank datasets of ``data``'s CSV, beside its splits."""
    csv = os.path.join(data["dir"], "inter.csv")
    split = ["--min_interactions", "30", "--num_warmup", "10"]
    build_segrec_data.main(["--inter_csv", csv, "--out", data["dir"],
                            "--name", "SegKG", "--kg_meta", "1",
                            "--n_eval_neg", "9"] + split)
    build_leave_rank_data.main(["--inter_csv", csv, "--out", data["dir"]]
                               + split)
    return data["dir"]


OTHER_ROUTES = {  # id: flags
    "extra0-Impression": ["--model_mode", "Impression", "--model_name",
                          "BPRMF", "--dataset", "SegMM_CTR"],
    "extra1-CFKG": ["--model_name", "CFKG", "--model_mode", "TopK",
                    "--dataset", "SegKG", "--margin", "1"],
    "extra5-leave_rank": ["--leave_rank", "1", "--model_name", "BPRMF",
                          "--model_mode", "TopK", "--dataset",
                          "SegMMstep1RankingDefault"],
}


@pytest.mark.parametrize("extra", list(OTHER_ROUTES.values()),
                         ids=list(OTHER_ROUTES))
def test_other_routes_run(other_routes_data, extra):
    """The routes the port once lacked (--model_mode Impression, the KG
    family, --leave_rank 1) through segrec.main --device cpu for one
    epoch: finite metrics (their checks against the JAX package:
    test_torch_segrec_rerank.py and test_torch_segrec_kg.py)."""
    res = main.main(["--path", other_routes_data, "--device", "cpu",
                     "--epoch", "1", "--emb_size", "16", "--batch_size",
                     "64", "--topk", "1,3", "--use_mesh", "0"] + extra)
    for split in ("dev", "test"):
        assert res[split] and all(np.isfinite(v) and 0 <= v <= 1
                                  for v in res[split].values()), res


def test_feedbuilder_sequential_flags_build_feeds(data):
    """The sequential models' feed flags build their feeds (the feeds
    against the JAX builder's: test_torch_segrec_sequential.py and
    test_torch_segrec_general.py)."""
    corpus = Corpus(data["dir"], "SegMM")
    for kw, phase, key in (
            (dict(augment_history=True), "train", "history_item_id_a"),
            (dict(session_graph=True), "dev", "srgnn_A"),
            (dict(s3rec_pretrain=True), "train", "mask_seq"),
            (dict(test_all=True), "test", "item_id")):
        b = feeds.FeedBuilder(corpus, phase, include_history=True, **kw)
        b.actions_before_epoch()
        feed = next(b.batches(16, shuffle=False))
        assert key in feed, kw
    assert feed["item_id"].shape[1] == corpus.n_items
