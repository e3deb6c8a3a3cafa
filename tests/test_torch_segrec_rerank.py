"""The port's leave-frame ranking and Impression mode (segmminterest_tpu_torch/
segrec/runner.py's LeaveRankingRunner, segrec/impression.py, segrec/
rerank.py) against the JAX package's on the CPU:

* evaluate_leave_ranking on the same predictions (ties among them) and the
  same generator: JAX's figures bit for bit in the five dataset-name cases
  of tests/test_leave_ranking.py; segrec.main --leave_rank 1 from the same
  weights (a .msgpack) against the JAX main, BPRMF trained one epoch on
  SegMMstep1Ranking and evaluated on SegMMstep1RankingDefault: the
  metrics, whose permutations come from the runner's generator after
  training's draws; five lock-step SASRec steps under the leave-rank
  runner;
* build_impressions and ImpressionFeedBuilder (with and without histories,
  two shuffled epochs, the wrap-padded final batch) key for key;
  evaluate_impressions on the same predictions with ties, bit for bit;
* the 11 impression losses and their gradients within 1e-6 relative, on
  padded slots and a wrap-padded batch;
* the rankers' and rerankers' forwards (BPRMF, SASRec; PRM, SetRank IMSAB
  and MSAB over BPRMF, MIR over SASRec) from the port's initial weights put
  into the JAX model's params: within 1e-6 relative in evaluation and in
  training mode (dropout 0), on a batch with wrap-padded rows, a row of
  equal ranker scores and a row whose history is all padding; a frozen
  ranker gets no gradient and --tuneranker 1 one;
* five lock-step steps (Adam, dropout 0) of the BPRMF impression ranker and
  of PRM over a frozen BPRMF ranker (--l2 0 and 1e-4, which moves the
  frozen ranker) under test_torch_segrec.py's bounds;
* load_ranker from the JAX runner's .msgpack and from the port's .pt: the
  scores of JAX's load; a ranker's and each reranker's .msgpack whole
  through load_state;
* segrec.main --model_mode Impression --device cpu over every ranker and
  reranker, --tuneranker 0 and 1.

Data: the port's build_segrec_data --kg_meta 1 and build_leave_rank_data
over data/synthetic.py's CSV (``runners_data``, shared with
tests/test_torch_segrec_kg.py).
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.segrec import impression as jimp
from segmminterest_tpu.segrec import main as jmain
from segmminterest_tpu.segrec import rerank as jrerank
from segmminterest_tpu.segrec import runner as jrunner
from segmminterest_tpu.segrec.corpus import Corpus as JaxCorpus
from segmminterest_tpu_torch.data.synthetic import write_synthetic_csv
from segmminterest_tpu_torch.models.convert import segrec_state_dict
from segmminterest_tpu_torch.segrec import impression, layers, main, rerank
from segmminterest_tpu_torch.segrec import runner
from segmminterest_tpu_torch.segrec.corpus import Corpus
from segmminterest_tpu_torch.tasks import (build_leave_rank_data,
                                           build_segrec_data)
from test_torch_segrec import (ADAM_BOUND, FWD_RTOL, LOSS_RTOL, LR,
                               METRIC_ATOL, STEPS, _frame_equal, _rel)
from test_torch_segrec_context import (flax_params,
                                       one_torch_thread)  # noqa: F401

N_USERS, N_ITEMS = 10, 60
P, N, HIST = 3, 4, 5        # the forwards' impression shape
EMB, HID = 8, 16


@pytest.fixture(scope="module")
def runners_data(tmp_path_factory):
    """SegMM (ranking, KG metadata: r_next_watch, i_category), SegMM_CTR
    (labels: the impressions) and the leave-rank datasets
    SegMMstep1Ranking[Default] of one synthetic CSV."""
    d = tmp_path_factory.mktemp("segrec_runners")
    csv = write_synthetic_csv(str(d / "inter.csv"), n_users=40,
                              per_user=(40, 60), n_videos=150, seed=5)
    split = ["--min_interactions", "30", "--num_warmup", "10"]
    build_segrec_data.main(["--inter_csv", csv, "--out", str(d), "--name",
                            "SegMM", "--n_eval_neg", "9", "--kg_meta", "1"]
                           + split)
    # the leave-rank datasets (every segment an item) of a smaller CSV
    small = write_synthetic_csv(str(d / "small.csv"), n_users=12,
                                per_user=(40, 60), n_videos=150, seed=5)
    build_leave_rank_data.main(["--inter_csv", small, "--out", str(d)]
                               + split)
    return str(d)


# ---------------------------------------------------------------------------
# leave-frame ranking

LEAVE_CASES = [("SegMMstep1Ranking", 0), ("KuaiMMstep1Ranking", 0),
               ("SegMMstep1RankingDefault", 1),
               ("KuaiMMstep1RankingFill", 23),
               ("KuaiRand_step1_Ranking_Fill", 36)]


@pytest.mark.parametrize("data_name,n_extra", LEAVE_CASES)
def test_leave_ranking_matches_jax(data_name, n_extra):
    """The same predictions, ties among them (a padded candidate repeated
    across a row, rows all tied, rounded scores), the same generator and
    durations: JAX's figures bit for bit, and the generator left where
    JAX's is."""
    rng = np.random.default_rng(11)
    bsz, seq_len = 50 + n_extra, 40
    pred = np.round(rng.normal(size=(bsz, seq_len)), 1)
    pred[:, 30:] = pred[:, 30:31]       # the padding id's repeated score
    pred[:3] = 0.25                      # rows all tied
    durations = rng.integers(1, seq_len + 1, size=bsz)
    args = (pred, [1, 3, 5, 10], ["HR", "NDCG"])
    kw = dict(durations=durations, data_name=data_name)
    gens = [np.random.default_rng(7), np.random.default_rng(7)]
    want = jrunner.evaluate_leave_ranking(*args, rng=gens[0], **kw)
    got = runner.evaluate_leave_ranking(*args, rng=gens[1], **kw)
    assert got == want
    assert gens[0].random() == gens[1].random()


def _leave_argv(d, model, dataset, extra=()):
    return ["--model_name", model, "--path", d, "--dataset", dataset,
            "--model_mode", "TopK", "--leave_rank", "1", "--emb_size", "16",
            "--history_max", "6", "--batch_size", "1024",
            "--eval_batch_size", "64", "--topk", "1,3,10", "--num_heads",
            "2", "--use_mesh", "0", *extra]


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("model,dataset,epochs", [
    ("BPRMF", "SegMMstep1Ranking", 1),
    ("BPRMF", "SegMMstep1RankingDefault", 0)])
def test_main_leave_rank_matches_jax(runners_data, tmp_path, model, dataset,
                                     epochs):
    """Both mains from the port's initial weights as a JAX .msgpack
    (--load 1):
    ``epochs`` epochs of training (the candidate shuffles and step seeds
    drawn from the runner's generator), then the dev and test evaluations,
    whose tie-breaking permutations come after them: the same metrics."""
    from flax import serialization
    argv = _leave_argv(runners_data, model, dataset)
    pargs = main.build_parser().parse_args(argv)
    jargs = jmain.build_parser().parse_args(argv)
    jcorpus = JaxCorpus(runners_data, dataset)
    example = next(jmain.FeedBuilder(
        jcorpus, "dev", task="ranking", history_max=6,
        include_history=model in jmain.SEQ_MODELS).batches(64, False))
    params = flax_params(jmain.build_model(jargs, jcorpus, False),
                         main.build_model(pargs, Corpus(runners_data,
                                                        dataset), False),
                         jrunner._device_feed(example), {})
    ckpt = tmp_path / "init.msgpack"
    ckpt.write_bytes(serialization.to_bytes(params))
    results = {}
    for side, m in (("jax", jmain), ("torch", main)):
        path = str(tmp_path / f"{side}.msgpack")
        shutil.copy(ckpt, path)
        extra = ["--load", "1", "--model_path", path, "--epoch",
                 str(max(epochs, 1)), "--train", str(int(epochs > 0))]
        if side == "torch":
            extra += ["--device", "cpu"]
        results[side] = m.main(_leave_argv(runners_data, model, dataset,
                                           extra))
    for split in ("dev", "test"):
        want, got = results["jax"][split], results["torch"][split]
        assert list(got) == list(want)
        for k, v in want.items():
            assert np.isfinite(got[k]) and abs(got[k] - v) <= METRIC_ATOL, \
                (split, k, got[k], v)


def _lockstep(jr, jstate, jb, pr, pb, feeds_of, jfeed_eval, steps=STEPS):
    """``steps`` steps of the JAX and the port's runner in lock step from
    the same weights over the same host batches (``feeds_of(builder)``
    yields them, a side's own draws made there): the losses within
    LOSS_RTOL, every weight within Adam's bound, the trained models'
    training-mode scores on ``jfeed_eval`` (their differences from column
    0) within LOSS_RTOL. Returns the JAX state."""
    jl, pl = [], []
    for step, (jf, pf) in enumerate(zip(feeds_of(jr, jb), feeds_of(pr, pb))):
        if step == steps:
            break
        _frame_equal(pf, jf, f"step {step}")
        seed = int(jr.rng.integers(0, 2 ** 31 - 1))
        assert seed == int(pr.rng.integers(0, 2 ** 31 - 1))
        jstate, loss = jr._jit_train(
            jstate, {k: v for k, v in jf.items() if k != "time"},
            jax.random.PRNGKey(seed))
        jl.append(float(loss))
        pl.append(float(pr.train_step(pf, seed)))
    assert len(jl) == steps and len(set(jl)) == steps, jl
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    want = segrec_state_dict(pr.model,
                             jax.tree.map(np.asarray, jstate["params"]))
    got = pr.model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        d = np.abs(got[k].numpy() - v.numpy()).max()
        assert d <= ADAM_BOUND, (k, d)
    feed = {k: v for k, v in jfeed_eval.items() if k != "time"}
    want = jax.jit(lambda p, f: jr._apply({"params": p}, f, False,
                                          {"dropout": jax.random.PRNGKey(0)}))(
        jstate["params"], feed)
    if isinstance(want, tuple):
        want = want[0]
    want = np.asarray(want)
    pr.model.train()
    with torch.no_grad():
        got = pr._forward(pr.put(jfeed_eval))[0].numpy()
    pr.model.eval()
    # the BPR losses see score differences only: a bias before the last
    # layer's output drifts as its rounding picks (Adam's bound)
    want, got = want - want[:, :1], got - got[:, :1]
    assert _rel(got, want) <= LOSS_RTOL
    return jstate


@pytest.mark.usefixtures("one_torch_thread")
def test_lockstep_sasrec_leave_rank(runners_data):
    """Five SASRec steps under --leave_rank 1's runners (the candidate
    shuffle and step seeds from the runners' generators)."""
    argv = _leave_argv(runners_data, "SASRec", "SegMMstep1Ranking",
                       ("--batch_size", "64", "--lr", str(LR)))
    pargs = main.build_parser().parse_args(argv)
    pcorpus = Corpus(pargs.path, pargs.dataset)
    model = main.build_model(pargs, pcorpus, False)
    cfg = dict(lr=LR, batch_size=64, eval_batch_size=64, epoch=1, seed=0,
               metrics=("NDCG", "HR"), topk=(1, 3), loss_n="BPR")
    jargs = jmain.build_parser().parse_args(argv)
    jcorpus = JaxCorpus(pargs.path, pargs.dataset)
    jb = jmain.FeedBuilder(jcorpus, "train", task="ranking", history_max=6,
                           include_history=True, seed=0)
    pb = main.feed_builders(pargs, pcorpus, "ranking",
                            phases=("train",))["train"]
    jm = jmain.build_model(jargs, jcorpus, False)
    jr = jrunner.LeaveRankingRunner(jm, jrunner.RunnerConfig(**cfg),
                                    data_name=pargs.dataset)
    pr = runner.LeaveRankingRunner(model, runner.RunnerConfig(**cfg),
                                   data_name=pargs.dataset, device="cpu")
    dev = next(jmain.FeedBuilder(jcorpus, "dev", task="ranking",
                                 history_max=6, include_history=True,
                                 seed=0).batches(64, shuffle=False))
    params = flax_params(jm, model, jrunner._device_feed(dev), {})
    jstate = {"params": params, "opt_state": jr.optimizer.init(params)}

    def feeds_of(r, b):
        while True:
            b.actions_before_epoch()
            for f in b.batches(64, shuffle=True):
                f = r._shuffled_batch(f)
                yield f[0] if isinstance(f, tuple) else f
    _lockstep(jr, jstate, jb, pr, pb, feeds_of, dev)


# ---------------------------------------------------------------------------
# impression data and metrics

@pytest.mark.parametrize("history_max", [0, 4])
def test_impression_feeds_match_jax(runners_data, history_max):
    """build_impressions and the builder's batches (two shuffled epochs,
    the wrap-padded final batch, an evaluation pass) key for key."""
    out = []
    for corpus_cls, mod in ((JaxCorpus, jrerank), (Corpus, rerank)):
        corpus = corpus_cls(runners_data, "SegMM_CTR")
        batches = []
        for phase in ("train", "dev"):
            b = mod.ImpressionFeedBuilder(corpus, phase, pos_len=6,
                                          neg_len=5, history_max=history_max,
                                          seed=3)
            for _ in range(2 if phase == "train" else 1):
                batches += list(b.batches(64, shuffle=phase == "train"))
        out.append((b.data, batches))
    (jdata, want), (pdata, got) = out
    _frame_equal(pdata, jdata, "dev impressions")
    assert len(got) == len(want) > 4
    for i, (g, w) in enumerate(zip(got, want)):
        _frame_equal(g, w, f"batch {i}")
    assert not want[3]["row_mask"].all()     # the final train batch wraps
    if history_max:
        assert (want[0]["lengths"] > 0).any() and \
            (want[0]["neg_lengths"] > 0).any()


def test_evaluate_impressions_matches_jax():
    rng = np.random.default_rng(4)
    R, Pn, Nn = 60, 5, 6
    pos_num = rng.integers(1, Pn + 1, size=R)
    neg_num = rng.integers(1, Nn + 1, size=R)
    preds = np.round(rng.normal(size=(R, Pn + Nn)), 1)
    preds[:8, 0] = preds[:8, Pn]        # ties across the pos/neg boundary
    preds[8:12] = 0.5                   # whole rows tied
    ar = np.arange(Pn + Nn)[None, :]
    valid = np.where(ar < Pn, ar < pos_num[:, None],
                     (ar - Pn) < neg_num[:, None])
    preds = np.where(valid, preds, -np.inf)
    args = (preds, pos_num, neg_num, Pn, (1, 3, 5, 10),
            ("NDCG", "MAP", "HR"))
    assert rerank.evaluate_impressions(*args) == \
        jrerank.evaluate_impressions(*args)


# ---------------------------------------------------------------------------
# the impression losses

def _loss_batch(seed=0, B=8):
    """Predictions with padded slots; the last 3 rows wrap-pad copies of
    the first."""
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(B, P + N)).astype(np.float32)
    pos_num = rng.integers(1, P + 1, size=B)
    neg_num = rng.integers(1, N + 1, size=B)
    pos_num[0], neg_num[0] = P, N
    target = rerank.impression_targets(pos_num, neg_num, P, N)
    pred[B - 3:], target[B - 3:] = pred[:3], target[:3]
    return pred, target


@pytest.mark.parametrize("name", list(impression.IMPRESSION_LOSSES))
def test_impression_losses_match_jax(name):
    pred, target = _loss_batch()
    if name == "probCE":
        pred = 1 / (1 + np.exp(-pred))
    jfn = jimp.IMPRESSION_LOSSES[name]
    want, jg = jax.jit(lambda p, t: (jfn(p, t, P), jax.grad(
        lambda q: jfn(q, t, P).sum())(p)))(jnp.asarray(pred),
                                           jnp.asarray(target))
    want, jg = np.asarray(want), np.asarray(jg)
    tp = torch.from_numpy(pred).requires_grad_()
    got = impression.IMPRESSION_LOSSES[name](tp, torch.from_numpy(target), P)
    assert got.shape == want.shape      # BPRsimple's is one per row
    got.sum().backward()
    assert _rel(got.detach().numpy(), want) <= FWD_RTOL, name
    assert np.abs(jg).max() > 0
    assert _rel(tp.grad.numpy(), jg) <= FWD_RTOL, name


# ---------------------------------------------------------------------------
# rankers and rerankers

def _ranker_pair(name):
    kw = dict(user_num=N_USERS, item_num=N_ITEMS, emb_size=EMB)
    if name == "SASRec":
        kw.update(num_heads=2, history_max=HIST)
    return (jrerank.IMPRESSION_RANKERS[name](**kw),
            rerank.IMPRESSION_RANKERS[name](**kw))


def _reranker_pair(name, ranker_name="BPRMF", tune=False,
                   setrank_type="IMSAB"):
    jrk, prk = _ranker_pair(ranker_name)
    kw = dict(item_num=N_ITEMS, ranker_emb_size=EMB, pos_len=P, neg_len=N,
              emb_size=EMB, num_heads=2, num_hidden_unit=HID,
              tuneranker=tune)
    if name in ("PRM", "SetRank"):
        kw["n_blocks"] = 2
    if name == "SetRank":
        kw["setrank_type"] = setrank_type
    return (jrerank.RERANKERS[name](ranker=jrk, **kw),
            rerank.RERANKERS[name](ranker=prk, **kw))


def imp_feed(seed, B=8):
    """test_rerank.py's imp_feed with: the last 2 rows wrap-pad copies of
    the first (row_mask off), row 2's candidates one item (equal ranker
    scores), row 3's history all padding (length 0, times 0)."""
    rng = np.random.default_rng(seed)
    pos_num = rng.integers(1, P + 1, size=B).astype(np.int32)
    neg_num = rng.integers(1, N + 1, size=B).astype(np.int32)
    feed = {
        "user_id": rng.integers(1, N_USERS, size=B).astype(np.int32),
        "item_id": rng.integers(1, N_ITEMS, size=(B, P + N)).astype(
            np.int32),
        "pos_num": pos_num, "neg_num": neg_num,
        "history_items": rng.integers(1, N_ITEMS, size=(B, HIST)).astype(
            np.int32),
        "history_times": np.sort(rng.integers(1, 1000, size=(B, HIST))
                                 ).astype(np.int64),
        "lengths": rng.integers(1, HIST + 1, size=B).astype(np.int32),
    }
    feed["item_id"][2] = feed["item_id"][2, 0]
    feed["pos_num"][2], feed["neg_num"][2] = P, N
    feed["history_items"][3] = 0
    feed["history_times"][3] = 0
    feed["lengths"][3] = 0
    for k in feed:
        feed[k][B - 2:] = feed[k][:2]
    feed["target"] = rerank.impression_targets(feed["pos_num"],
                                               feed["neg_num"], P, N)
    feed["row_mask"] = np.arange(B) < B - 2
    return feed


@functools.lru_cache(maxsize=None)
def _start(spec):
    """(JAX model, port model from init_weights(seed 0), the JAX params
    holding its weights) of a ranker or reranker spec."""
    kind, *rest = spec
    jm, tm = (_ranker_pair(*rest) if kind == "ranker"
              else _reranker_pair(*rest))
    layers.init_weights(tm, torch.Generator().manual_seed(0))
    params = flax_params(jm, tm, {k: jnp.asarray(v) for k, v in
                                  imp_feed(0).items()}, {})
    return jm, tm, params


FORWARD_SPECS = {
    "BPRMF": ("ranker", "BPRMF"),
    "SASRec": ("ranker", "SASRec"),
    "PRM": ("reranker", "PRM", "BPRMF"),
    "SetRank-IMSAB": ("reranker", "SetRank", "BPRMF", False, "IMSAB"),
    "SetRank-MSAB": ("reranker", "SetRank", "BPRMF", False, "MSAB"),
    "MIR-SASRec": ("reranker", "MIR", "SASRec"),
}


@pytest.mark.parametrize("case", list(FORWARD_SPECS))
def test_forward_matches_jax(case):
    """Evaluation and training mode (dropout 0) on imp_feed: every output
    (a ranker's scores, u_v, i_v and his_v) within 1e-6 relative of the
    JAX model's (whose training forward at rate 0 is its evaluation
    one: flax's Dropout returns its input)."""
    jm, tm, params = _start(FORWARD_SPECS[case])
    feed = imp_feed(5)
    jfeed = {k: jnp.asarray(v) for k, v in feed.items()}
    tfeed = {k: torch.from_numpy(v) for k, v in feed.items()}
    want = jax.jit(lambda p, f: jm.apply({"params": p}, f))(params, jfeed)
    for mode in ("eval", "train"):
        tm.train(mode == "train")
        with torch.no_grad():
            got = tm(tfeed, generator=torch.Generator().manual_seed(1))
        tm.eval()
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.isfinite(g.numpy()).all()
            assert _rel(g.numpy(), np.asarray(w)) <= FWD_RTOL, (case, mode)


def test_rank_positions_ties():
    """Equal scores, -inf padding among them, keep their slot order, as
    jnp.argsort's stable sort does."""
    s = np.array([[0.5, 0.5, -np.inf, 0.5, 1.0, -np.inf],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    want = np.asarray(jrerank._rank_positions(jnp.asarray(s)))
    got = rerank._rank_positions(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [1, 2, 4, 3, 0, 5])


@pytest.mark.parametrize("tune", [False, True])
def test_frozen_ranker_gradients(tune):
    """The ranker's outputs are detached unless --tuneranker 1: its
    parameters get no gradient, or one."""
    _, tm = _reranker_pair("PRM", tune=tune)
    layers.init_weights(tm, torch.Generator().manual_seed(0))
    feed = {k: torch.from_numpy(v) for k, v in imp_feed(5).items()}
    loss = impression.IMPRESSION_LOSSES["BPRsession"](tm(feed),
                                                      feed["target"], P)
    loss.backward()
    grads = [p.grad for p in tm.ranker.parameters()]
    if tune:
        assert all(g is not None and g.abs().sum() > 0 for g in grads)
    else:
        assert all(g is None for g in grads)
    assert all(p.grad is not None for n, p in tm.named_parameters()
               if not n.startswith("ranker."))


# ---------------------------------------------------------------------------
# lock-step training of the impression runners

def _impression_runners(d, spec, l2=0.0):
    """The JAX and the port's impression runners on SegMM_CTR's
    impressions (6 | 5 slots, B=48; a reranker of one block) from the
    port's initial weights, and each side's train and dev builders."""
    kind, name, *rest = spec
    corpus = {"jax": JaxCorpus(d, "SegMM_CTR"), "torch": Corpus(d,
                                                                 "SegMM_CTR")}
    Pl, Nl = 6, 5
    hist = 4 if name == "MIR" or "SASRec" in (name, *rest) else 0
    users, items = corpus["torch"].n_users, corpus["torch"].n_items
    mods = {"jax": jrerank, "torch": rerank}
    models = {}
    for side, mod in mods.items():
        rk = dict(user_num=users, item_num=items, emb_size=16)
        rname = name if kind == "ranker" else rest[0]
        if rname == "SASRec":
            rk.update(num_heads=2, history_max=hist)
        ranker = mod.IMPRESSION_RANKERS[rname](**rk)
        if kind == "ranker":
            models[side] = ranker
        else:
            blocks = {} if name == "MIR" else dict(n_blocks=1)
            models[side] = mod.RERANKERS[name](
                item_num=items, ranker=ranker, ranker_emb_size=16,
                pos_len=Pl, neg_len=Nl, emb_size=16, num_heads=2,
                num_hidden_unit=16, **blocks)
    layers.init_weights(models["torch"], torch.Generator().manual_seed(0))
    cfg = dict(lr=LR, l2=l2, batch_size=48, eval_batch_size=48, epoch=1,
               seed=0, topk=(1, 3), metrics=("NDCG", "MAP", "HR"),
               loss_n="BPRsession")
    builders = {side: {p: mods[side].ImpressionFeedBuilder(
        corpus[side], p, pos_len=Pl, neg_len=Nl, history_max=hist, seed=0)
        for p in ("train", "dev")} for side in mods}
    jr = jrerank.make_impression_runner(models["jax"],
                                        jrunner.RunnerConfig(**cfg), Pl, Nl)
    pr = rerank.ImpressionRunner(models["torch"],
                                       runner.RunnerConfig(**cfg), Pl, Nl,
                                       device="cpu")
    dev = next(builders["jax"]["dev"].batches(48))
    params = flax_params(models["jax"], models["torch"],
                         {k: jnp.asarray(v) for k, v in dev.items()
                          if k != "time"}, {})
    jstate = {"params": params, "opt_state": jr.optimizer.init(params)}
    return jr, jstate, builders["jax"], pr, builders["torch"], dev


def _impression_feeds(r, b):
    while True:
        yield from b.batches(r.cfg.batch_size, shuffle=True)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("spec,l2", [
    (("ranker", "BPRMF"), 0.0),
    (("reranker", "PRM", "BPRMF"), 0.0),
    (("reranker", "PRM", "BPRMF"), 1e-4)],
    ids=["BPRMF", "PRM-frozen-BPRMF", "PRM-frozen-BPRMF-l2"])
def test_lockstep_impression(runners_data, spec, l2):
    """Five BPRsession steps; the wrap-padded final batch in each epoch.
    Over a frozen ranker with --l2 1e-4 the ranker's tables move (decay
    through Adam) and must move as JAX's."""
    jr, jstate, jb, pr, pb, dev = _impression_runners(runners_data, spec,
                                                      l2)
    before = {k: v.clone() for k, v in pr.model.state_dict().items()}
    _lockstep(jr, jstate, jb["train"], pr, pb["train"], _impression_feeds,
              dev)
    if spec[0] == "reranker":
        moved = (pr.model.state_dict()["ranker.i_embeddings.weight"]
                 - before["ranker.i_embeddings.weight"]).abs().max()
        assert (moved > 0) == (l2 > 0)


# ---------------------------------------------------------------------------
# loads

def test_load_ranker_msgpack_and_pt(tmp_path):
    """A BPRMF ranker's params from the JAX runner's .msgpack and from the
    port's .pt land in PRM's ranker: PRM's scores those of JAX's
    load_ranker on the same reranker weights."""
    from flax import serialization
    jm, tm, params = _start(FORWARD_SPECS["PRM"])
    _, tr, rparams = _start(FORWARD_SPECS["BPRMF"])
    path = str(tmp_path / "ranker.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(rparams))
    cfg = jrunner.RunnerConfig(loss_n="BPRsession")
    jr = jrerank.make_impression_runner(jm, cfg, P, N)
    jstate = jr.load_ranker({"params": params,
                             "opt_state": jr.optimizer.init(params)}, path)
    feed = imp_feed(6)
    want = np.asarray(jax.jit(lambda p, f: jm.apply({"params": p}, f))(
        jstate["params"], {k: jnp.asarray(v) for k, v in feed.items()}))
    pt = str(tmp_path / "ranker.pt")
    torch.save(tr.state_dict(), pt)
    for src in (path, pt):
        _, pm = _reranker_pair("PRM")
        pm.load_state_dict(tm.state_dict())
        with torch.no_grad():
            for p in pm.ranker.parameters():
                p.zero_()
        pr = rerank.ImpressionRunner(
            pm, runner.RunnerConfig(loss_n="BPRsession"), P, N,
            device="cpu")
        pr.load_ranker(src)
        for k, v in tr.state_dict().items():
            torch.testing.assert_close(pm.ranker.state_dict()[k], v,
                                       rtol=0, atol=0)
        assert _rel(pr.eval_scores(feed), want) <= FWD_RTOL, src


@pytest.mark.parametrize("case", ["SASRec", "PRM", "SetRank-IMSAB",
                                  "MIR-SASRec"])
def test_load_state_msgpack(case, tmp_path):
    """A ranker's or reranker's params as the JAX runner saves them (flax
    to_bytes) load whole through the port's load_state, every leaf bit for
    bit: the nested ranker, SetRank's inducing points I_b, MIR's LSTM
    cells and SLAttention weights."""
    from flax import serialization
    _, _, params = _start(FORWARD_SPECS[case])
    path = tmp_path / f"{case}.msgpack"
    path.write_bytes(serialization.to_bytes(params))
    spec = FORWARD_SPECS[case]
    tm = (_ranker_pair(*spec[1:]) if spec[0] == "ranker"
          else _reranker_pair(*spec[1:]))[1]
    r = rerank.ImpressionRunner(tm, runner.RunnerConfig(), P, N,
                                      device="cpu")
    r.load_state(str(path))
    want = segrec_state_dict(tm, params)
    assert set(want) == set(tm.state_dict())
    for k, v in want.items():
        torch.testing.assert_close(tm.state_dict()[k], v, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the CLI

def _imp_argv(d, name, extra=()):
    return ["--model_name", name, "--path", d, "--dataset", "SegMM_CTR",
            "--model_mode", "Impression", "--emb_size", "16",
            "--ranker_emb_size", "16", "--num_hidden_unit", "16",
            "--n_blocks", "2", "--num_heads", "2", "--history_max", "4",
            "--train_max_pos_item", "6", "--train_max_neg_item", "5",
            "--batch_size", "48", "--eval_batch_size", "48", "--topk",
            "1,3,5", "--epoch", "1", *extra]


@pytest.fixture(scope="module")
def ranker_pt(runners_data, tmp_path_factory):
    """The BPRMF impression ranker trained one epoch by the port's CLI,
    its .pt."""
    path = str(tmp_path_factory.mktemp("ranker") / "bprmf.pt")
    res = main.main(_imp_argv(runners_data, "BPRMF", (
        "--model_path", path, "--device", "cpu")))
    assert os.path.exists(path) and np.isfinite(res["test"]["NDCG@3"])
    return path


IMPRESSION_ROUTES = {
    "SASRec": ("SASRec", ()),
    "PRM": ("PRM", ()),
    "PRM-tune": ("PRM", ("--tuneranker", "1")),
    "SetRank-IMSAB": ("SetRank", ()),
    "SetRank-MSAB-tune": ("SetRank", ("--setrank_type", "MSAB",
                                      "--tuneranker", "1")),
    "SetRank-MSAB": ("SetRank", ("--setrank_type", "MSAB")),
    "MIR": ("MIR", ()),
    "MIR-tune": ("MIR", ("--tuneranker", "1")),
}


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("case", list(IMPRESSION_ROUTES))
def test_main_impression_routes(runners_data, ranker_pt, case):
    """segrec.main --model_mode Impression --device cpu: the SASRec ranker,
    and each reranker over the saved BPRMF ranker (frozen and tuned): one
    epoch, finite NDCG / MAP / HR within [0, 1]."""
    name, extra = IMPRESSION_ROUTES[case]
    if name != "SASRec":
        extra = extra + ("--ranker_model_path", ranker_pt)
    res = main.main(_imp_argv(runners_data, name, extra + ("--device",
                                                            "cpu")))
    for split in ("dev", "test"):
        assert set(res[split]) == {f"{m}@{k}" for m in ("NDCG", "MAP", "HR")
                                   for k in (1, 3, 5)}
        for k, v in res[split].items():
            assert 0.0 <= v <= 1.0, (split, k, v)
