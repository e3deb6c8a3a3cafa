"""The port's KG family (segmminterest_tpu_torch/segrec/kg.py: CFKG,
SLRCPlus, Chorus, KDA) against the JAX package's on the CPU:

* KGMeta (triplets, relation rows, attribute entities, share_attr_dict)
  and kda_freq_init (freq_x bit for bit) from the same item_meta.csv and
  interactions, with and without --include_attr;
* KGFeedBuilder in all five modes (cfkg and chorus_kg quadruples, slrc's
  and chorus's relational intervals, kda's entity values, normalised
  deltas and DistMult quadruples) key for key and bit for bit over two
  epochs, the evaluation splits too;
* cfkg_margin_loss and its gradient within 1e-6 relative, padded rows
  among them;
* each model's forward from the port's initial weights put into the JAX
  model's params, within 1e-6 relative in evaluation and training mode
  (dropout 0): CFKG's quadruples and its (user, buy, item) evaluation,
  SLRCPlus, Chorus's BPR and GMF heads and its TransE branch, KDA under
  average and attention pooling with its DistMult term, on a batch with
  padded rows, a row whose history is all padding and rows of another
  scale (KDA's attention shift is one max over the whole batch);
* five lock-step steps (Adam, dropout 0) of CFKG (margin loss), Chorus's
  stage 2 on its own runner (three parameter groups, --l2 1e-4) and KDA
  (its DistMult term in the loss) under test_torch_segrec.py's bounds;
* KDA's .msgpack whole through load_state;
* segrec.main --device cpu: CFKG --include_attr 1, SLRCPlus, Chorus
  --stage 1 then --stage 2 --load 1, KDA --include_attr 1 and KDA
  --freq_rand 1: finite metrics.

Data: tests/test_torch_segrec_rerank.py's ``runners_data`` (SegMM with
r_next_watch and i_category in its item_meta.csv).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.segrec import kg as jkg
from segmminterest_tpu.segrec import main as jmain
from segmminterest_tpu.segrec import runner as jrunner
from segmminterest_tpu.segrec.corpus import Corpus as JaxCorpus
from segmminterest_tpu_torch.models.convert import segrec_state_dict
from segmminterest_tpu_torch.segrec import kg, layers, main, runner
from segmminterest_tpu_torch.segrec.corpus import Corpus
from test_torch_segrec import FWD_RTOL, LR, _frame_equal, _rel
from test_torch_segrec_context import (flax_params,
                                       one_torch_thread)  # noqa: F401
from test_torch_segrec_rerank import _lockstep, runners_data  # noqa: F401

N_USERS, N_ITEMS, HIST = 10, 30, 6


@pytest.mark.parametrize("attr", [False, True], ids=["items", "attr"])
def test_kgmeta_and_freq_init_match_jax(runners_data, attr):
    want = jkg.KGMeta(runners_data, "SegMM", include_attr=attr,
                      n_items=JaxCorpus(runners_data, "SegMM").n_items)
    corpus = Corpus(runners_data, "SegMM")
    got = kg.KGMeta(runners_data, "SegMM", include_attr=attr,
                    n_items=corpus.n_items)
    for a in ("item_relations", "attr_relations", "attr_max", "relations",
              "triplet_set", "share_attr_dict", "n_relations", "n_entities",
              "head_index"):
        assert getattr(got, a) == getattr(want, a), a
    _frame_equal(got.relation_df, {c: want.relation_df[c].to_numpy()
                                   for c in want.relation_df}, "relations")
    assert len(got.attr_relations) == (2 if attr else 0)
    fx, n = kg.kda_freq_init(corpus, got, n_dft=16, t_scalar=60)
    wfx, wn = jkg.kda_freq_init(JaxCorpus(runners_data, "SegMM"), want,
                                n_dft=16, t_scalar=60)
    assert n == wn and fx.dtype == wfx.dtype
    np.testing.assert_array_equal(fx, wfx)


FEED_CASES = {  # id: (kg_mode, phase, include_attr, history)
    "cfkg-train": ("cfkg", "train", True, False),
    "chorus_kg-train": ("chorus_kg", "train", False, True),
    "slrc-train": ("slrc", "train", False, True),
    "slrc-dev": ("slrc", "dev", False, True),
    "chorus-train": ("chorus", "train", False, True),
    "chorus-test": ("chorus", "test", False, True),
    "kda-train": ("kda", "train", True, True),
    # fewer relation rows than train rows: sampled with replacement
    "kda-train-items": ("kda", "train", False, True),
    "kda-dev": ("kda", "dev", True, True),
}


@pytest.mark.parametrize("case", list(FEED_CASES))
def test_kg_feeds_match_jax(runners_data, case):
    mode, phase, attr, hist = FEED_CASES[case]
    out = []
    for corpus_cls, mod in ((JaxCorpus, jkg), (Corpus, kg)):
        corpus = corpus_cls(runners_data, "SegMM")
        meta = mod.KGMeta(runners_data, "SegMM", include_attr=attr,
                          n_items=corpus.n_items)
        b = mod.KGFeedBuilder(corpus, phase, kg=meta, kg_mode=mode,
                              time_scalar=3600, num_neg_kg=2, task="ranking",
                              num_neg=2, history_max=HIST,
                              include_history=hist, seed=4)
        batches = []
        for _ in range(2 if phase == "train" else 1):
            b.actions_before_epoch()
            batches += list(b.batches(64, shuffle=phase == "train"))
        out.append(batches)
    want, got = out
    assert len(got) == len(want) > 2
    for i, (g, w) in enumerate(zip(got, want)):
        _frame_equal(g, w, f"batch {i}")
    if "relational_interval" in want[0]:   # relations found, and not
        ri = np.concatenate([w["relational_interval"] for w in want])
        assert (ri[..., 1] >= 0).any() and (ri[..., 1] < 0).any()


def test_cfkg_margin_loss_matches_jax():
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(8, 4)).astype(np.float32)
    rm = np.arange(8) < 6
    jf = lambda p: jkg.cfkg_margin_loss(p, jnp.asarray(rm), 0.7)  # noqa
    want, jg = jax.value_and_grad(jf)(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = kg.cfkg_margin_loss(tp, torch.from_numpy(rm), 0.7)
    got.backward()
    assert abs(got.item() / float(want) - 1) <= FWD_RTOL
    assert _rel(tp.grad.numpy(), np.asarray(jg)) <= FWD_RTOL


# ---------------------------------------------------------------------------
# forwards

def _pair(name, **kw):
    """(JAX model, port model) at test_kg.py's sizes."""
    rng = np.random.default_rng(3)
    base = {
        "CFKG": dict(user_num=N_USERS, entity_num=N_ITEMS + 5,
                     relation_num=3, emb_size=8),
        "SLRCPlus": dict(user_num=N_USERS, item_num=N_ITEMS, relation_num=3,
                         emb_size=8),
        "Chorus": dict(user_num=N_USERS, item_num=N_ITEMS,
                       relation_names=("r_complement", "r_substitute"),
                       category_num=3, emb_size=8),
        "KDA": dict(user_num=N_USERS, item_num=N_ITEMS,
                    entity_num=N_ITEMS + 5, relation_num=3, freq_dim=9,
                    freq_real_init=rng.normal(size=(3, 9)),
                    freq_imag_init=rng.normal(size=(3, 9)), emb_size=8,
                    num_heads=2, gamma=0.5),
    }[name]
    kw = dict(base, **kw)
    return (getattr(jkg, f"{name}Model")(**kw),
            kg.KG_MODELS[name](**kw))


def kg_feed(seed, B=8, I=3, R=3, n_rel=3, pad=2):
    """test_kg.py's kg_feed with the last ``pad`` rows padding (zero,
    row_mask off, as a final batch's), row 1's history all padding, row
    2's half."""
    rng = np.random.default_rng(seed)
    feed = {
        "user_id": rng.integers(1, N_USERS, size=B),
        "item_id": rng.integers(1, N_ITEMS, size=(B, I)),
        "row_mask": np.arange(B) < B - pad,
        "history_item_id": rng.integers(1, N_ITEMS, size=(B, HIST)),
        "history_delta_t": (rng.random((B, HIST)) * 3).astype(np.float32),
        "relational_interval": np.where(
            rng.random((B, I, R)) < 0.5, rng.random((B, I, R)) * 3,
            -1).astype(np.float32),
        "category_id": rng.integers(0, 3, size=(B, I)),
        "item_val": rng.integers(0, N_ITEMS + 5, size=(B, I, n_rel)),
        "head_id": rng.integers(1, N_ITEMS, size=(B, 2)),
        "tail_id": rng.integers(1, N_ITEMS, size=(B, 2)),
        "relation_id": rng.integers(0, n_rel, size=B),
        "value_id": rng.integers(0, N_ITEMS + 5, size=B),
    }
    feed["history_item_id"][1] = 0
    feed["history_item_id"][2, 3:] = 0
    for k, v in feed.items():
        if k != "row_mask":
            v[B - pad:] = 0
    return feed


def quad_feed(seed, B=8, pad=2, users=True):
    rng = np.random.default_rng(seed)
    lo = N_USERS if users else 1
    feed = {"head_id": rng.integers(1, N_USERS, size=(B, 4)),
            "tail_id": rng.integers(lo, lo + N_ITEMS - 1, size=(B, 4)),
            "relation_id": rng.integers(0, 3, size=(B, 4)),
            "row_mask": np.arange(B) < B - pad}
    for k in ("head_id", "tail_id", "relation_id"):
        feed[k][B - pad:] = 0
    return feed


@functools.lru_cache(maxsize=None)
def _start(name, kw=()):
    """The JAX model, the port's from init_weights(seed 0) (KDA: entities
    1..5 thirty times larger, rows of another scale) and the JAX params
    holding its weights."""
    jm, tm = _pair(name, **dict(kw))
    layers.init_weights(tm, torch.Generator().manual_seed(0))
    if name == "KDA":
        with torch.no_grad():
            tm.entity_embeddings.weight[1:6] *= 30
    feed = {"CFKG": quad_feed(0), "Chorus": _feeds("rec", 0)}.get(
        name, kg_feed(0))
    params = flax_params(jm, tm, {k: jnp.asarray(v) for k, v in
                                  feed.items()}, {})
    return jm, tm, params


FORWARD_CASES = {  # id: (model, constructor kw, feeds)
    "CFKG": ("CFKG", (), ("quad", "eval")),
    "SLRCPlus": ("SLRCPlus", (), ("rec",)),
    "Chorus-BPR": ("Chorus", (), ("rec", "kg")),
    "Chorus-GMF": ("Chorus", (("base_method", "GMF"),), ("rec",)),
    "KDA-average": ("KDA", (), ("train", "eval")),
    "KDA-attention": ("KDA", (("pooling", "attention"),), ("train",)),
}


def _feeds(kind, seed=5):
    if kind == "quad":
        return quad_feed(seed)
    if kind == "kg":
        return quad_feed(seed, users=False)
    feed = kg_feed(seed)
    if kind in ("eval", "rec"):
        for k in ("head_id", "tail_id", "relation_id", "value_id"):
            feed.pop(k)
    return feed


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_jax(case):
    """Scores in evaluation and training mode, and KDA's DistMult term,
    within 1e-6 relative."""
    name, kw, kinds = FORWARD_CASES[case]
    jm, tm, params = _start(name, kw)
    for kind in kinds:
        feed = _feeds(kind)
        jfeed = {k: jnp.asarray(v) for k, v in feed.items()}
        # the JAX model's training forward at rate 0 is its evaluation one
        want, sown = jax.jit(lambda p, f: jm.apply(
            {"params": p}, f, mutable=["losses"]))(params, jfeed)
        tfeed = {k: torch.from_numpy(v) for k, v in feed.items()}
        for mode in ("eval", "train"):
            tm.train(mode == "train")
            with torch.no_grad():
                got, losses = tm(tfeed)
            tm.eval()
            assert got.shape == want.shape and torch.isfinite(got).all()
            assert _rel(got.numpy(), np.asarray(want)) <= FWD_RTOL, \
                (case, kind, mode)
            jl = sown.get("losses", {})
            assert set(losses) == set(jl), (case, kind)
            for k, v in jl.items():
                assert abs(float(losses[k]) / float(v[0]) - 1) <= FWD_RTOL


def test_load_state_msgpack(tmp_path):
    """KDA's params as the JAX runner saves them load whole (freq_real and
    freq_imag among them), every leaf bit for bit."""
    from flax import serialization
    _, _, params = _start("KDA", ())
    path = tmp_path / "kda.msgpack"
    path.write_bytes(serialization.to_bytes(params))
    tm = _pair("KDA")[1]
    r = runner.RankingRunner(tm, runner.RunnerConfig(), device="cpu")
    r.load_state(str(path))
    want = segrec_state_dict(tm, params)
    assert set(want) == set(tm.state_dict())
    for k, v in want.items():
        torch.testing.assert_close(tm.state_dict()[k], v, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# lock-step training

def _kg_argv(d, name, extra=()):
    return ["--model_name", name, "--path", d, "--dataset", "SegMM",
            "--model_mode", "TopK", "--emb_size", "16", "--history_max",
            str(HIST), "--batch_size", "64", "--eval_batch_size", "64",
            "--lr", str(LR), "--topk", "1,3", "--num_heads", "2",
            "--use_mesh", "0", *extra]


def _kg_setups(d, argv):
    """The JAX and the port's runners as the two mains choose them (the
    margin loss, Chorus's runner), from the port's initial weights, and
    each side's builders."""
    pargs = main.build_parser().parse_args(argv)
    jargs = jmain.build_parser().parse_args(argv)
    out = {}
    for side, m, corpus_cls, mod in (("jax", jmain, JaxCorpus, jkg),
                                     ("torch", main, Corpus, kg)):
        args = jargs if side == "jax" else pargs
        corpus = corpus_cls(d, "SegMM")
        meta = mod.KGMeta(d, "SegMM", include_attr=bool(args.include_attr),
                          n_items=corpus.n_items)
        builders = {p: mod.KGFeedBuilder(
            corpus, p, kg=meta, kg_mode=main.kg_mode(args, p),
            time_scalar=args.time_scalar, num_neg_kg=1, task="ranking",
            num_neg=1, history_max=HIST,
            include_history=args.model_name in main.SEQ_MODELS, seed=0)
            for p in ("train", "dev")}
        cfg = dict(lr=LR, l2=args.l2, batch_size=64, eval_batch_size=64,
                   epoch=1, seed=0, metrics=("NDCG", "HR"), topk=(1, 3),
                   loss_n=main.loss_name(args, "ranking"), margin=args.margin)
        if side == "jax":
            model = jmain.build_model(args, corpus, False, kg_meta=meta)
            jcfg = jrunner.RunnerConfig(**cfg)
            r = (jkg.make_chorus_runner(model, jcfg, args.lr_scale)
                 if args.model_name == "Chorus" else
                 jrunner.RankingRunner(model, jcfg))
        else:
            model = main.build_model(args, corpus, False, kg_meta=meta)
            pcfg = runner.RunnerConfig(**cfg)
            r = (kg.make_chorus_runner(model, pcfg, args.lr_scale,
                                       device="cpu")
                 if args.model_name == "Chorus" else
                 runner.RankingRunner(model, pcfg, device="cpu"))
        out[side] = (r, model, builders)
    jr, jm, jb = out["jax"]
    pr, pm, pb = out["torch"]
    dev = next(jb["dev"].batches(64, shuffle=False))
    params = flax_params(jm, pm, jrunner._device_feed(dev), {})
    jstate = {"params": params, "opt_state": jr.optimizer.init(params)}
    return jr, jstate, jb, pr, pb, dev


def _kg_feeds(r, b):
    while True:
        b.actions_before_epoch()
        for f in b.batches(64, shuffle=True):
            if "item_id" in f:
                f = r._shuffled_batch(f)
                f = f[0] if isinstance(f, tuple) else f
            yield f


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("name,extra", [
    ("CFKG", ("--margin", "1")),
    ("Chorus", ("--l2", "1e-4")),
    ("KDA", ())], ids=["CFKG", "Chorus-stage2-l2", "KDA"])
def test_lockstep_kg(runners_data, name, extra):
    """Five steps from the same weights and batches: CFKG's margin loss
    over the quadruples; Chorus's stage 2 on its runner (user_bias and
    item_bias without decay, i_embeddings and r_embeddings at lr *
    lr_scale); KDA with its DistMult term."""
    jr, jstate, jb, pr, pb, dev = _kg_setups(
        runners_data, _kg_argv(runners_data, name, extra))
    if name == "Chorus":
        names = dict(pr.model.named_parameters())
        assert [len(g["params"]) for g in pr.optimizer.param_groups] == \
            [5, 2, 2] and pr.optimizer.param_groups[1]["lr"] == LR * 0.1
        assert not pr._decays("user_bias.weight") and \
            pr._decays("i_embeddings.weight") and len(names) == 9
    _lockstep(jr, jstate, jb["train"], pr, pb["train"], _kg_feeds, dev)


# ---------------------------------------------------------------------------
# the CLI

KG_ROUTES = {
    "CFKG-attr": ("CFKG", ("--include_attr", "1", "--margin", "1")),
    "SLRCPlus": ("SLRCPlus", ()),
    "KDA-attr": ("KDA", ("--include_attr", "1")),
    "KDA-freq_rand": ("KDA", ("--freq_rand", "1")),
}


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("case", list(KG_ROUTES))
def test_main_kg_routes(runners_data, case):
    name, extra = KG_ROUTES[case]
    res = main.main(_kg_argv(runners_data, name, extra + (
        "--epoch", "1", "--device", "cpu")))
    for split in ("dev", "test"):
        assert 0.0 <= res[split]["HR@1"] <= res[split]["HR@3"] <= 1.0


@pytest.mark.usefixtures("one_torch_thread")
def test_main_chorus_two_stages(runners_data, tmp_path):
    """Chorus's protocol (Chorus.py:9-13): stage 1's TransE pretrain saved
    (--model_path), stage 2 loads it in part (--load 1) and trains on its
    own runner."""
    pt = str(tmp_path / "chorus_kg.pt")
    main.main(_kg_argv(runners_data, "Chorus", (
        "--stage", "1", "--model_path", pt, "--margin", "1", "--epoch", "1",
        "--device", "cpu")))
    stage1 = torch.load(pt, weights_only=True)
    res = main.main(_kg_argv(runners_data, "Chorus", (
        "--stage", "2", "--load", "1", "--model_path", pt, "--epoch", "1",
        "--device", "cpu")))
    assert os.path.exists(pt) and set(torch.load(pt, weights_only=True)) \
        == set(stage1)
    for split in ("dev", "test"):
        assert 0.0 <= res[split]["HR@1"] <= res[split]["HR@3"] <= 1.0
