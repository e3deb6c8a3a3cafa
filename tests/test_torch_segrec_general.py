"""The port's SegRec general models (segmminterest_tpu_torch/segrec/models/
general.py: BPRMF, BUIR, NeuMF, LightGCN, DirectAU, POP), their loss
routes and full-sort evaluation against the JAX package's on the CPU, and
the helpers tests/test_torch_segrec_sequential.py shares:

* each model's forward from the port's initial weights put into the JAX
  model's params (test_torch_segrec_context.py's flax_params), at
  test_baseline_models.py's shapes (emb 8, 30 users, 80 items, B=4, I=3,
  history 6), and on a final batch of 5 real rows padded to 8: scores in
  evaluation and in training mode (dropout 0) within 1e-6 relative, the
  models' own loss terms too; on the padded batch every gradient finite
  and within GRAD_RTOL of JAX's;
* the runner's BUIR, DirectAU and ContraRec routes on the same arrays;
* five lock-step steps (Adam, dropout 0) of BUIR (--l2 0 and 1e-4, the
  momentum update after each step) and DirectAU (--loss_n DirectAU) under
  test_torch_segrec.py's bounds;
* the test_all feeds bit for bit, the full-sort predictions (shape, the
  clicked items at -inf, column 0 the target's own column bit for bit)
  and their HR / NDCG against the JAX runner's, and through both CLIs;
* each model's state from the JAX runner's .msgpack.

Data: test_torch_segrec.py's ``data`` fixture (the port's
build_segrec_data over data/synthetic.py's CSV).
"""

import functools

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
from segmminterest_tpu_torch.models.convert import segrec_state_dict
from segmminterest_tpu_torch.segrec import feeds, layers, main, runner
from segmminterest_tpu_torch.segrec.corpus import Corpus
from segmminterest_tpu_torch.segrec.models import MODEL_REGISTRY, model_class
from segmminterest_tpu_torch.segrec.models.general import direct_au_loss
from test_torch_segrec import (ADAM_BOUND, FWD_RTOL, LOSS_RTOL, LR,
                               METRIC_ATOL, STEPS, _frame_equal, _rel,
                               data)  # noqa: F401 (fixture)
from test_torch_segrec_context import (flax_params,
                                       one_torch_thread)  # noqa: F401

N_USERS, N_ITEMS, HIST = 30, 80, 6
# a gradient of the padded batch against JAX's, relative to the largest
# entry of its leaf: the sums over rows round differently in the two
# frameworks (fp32). Measured: within 1e-6 but for TiMiRec's finetune
# (1.2e-5, its KL's cancellation, FP64_CASES) and ContraRec's GRU encoder
# (1.6e-5, against JAX's gradient of the real rows alone, see forwards)
GRAD_RTOL = 3e-5
# TiMiRec's KL between two near-equal softmaxes is a sum of q (log q -
# log p) terms that cancel to ~1.5e-5: fp32's rounding of the logs alone
# puts JAX's own fp32 KL 7.5e-4 from its fp64 one (the port's 9.7e-4 and
# 1.5e-3 from JAX's fp32, 5.4e-7 in fp64). Such models are held in fp64
# within the bound too, their fp32 within COND times JAX's own fp32
# rounding (test_torch_segrec_context.py's rule for DCNv2).
FP64_CASES = {"TiMiRec"}
COND = 4

GENERAL = ("BPRMF", "BUIR", "NeuMF", "LightGCN", "DirectAU", "POP")
SEQUENTIAL = ("SASRec", "GRU4Rec", "Caser", "NARM", "FPMC", "TiSASRec",
              "ComiRec", "ContraRec", "TiMiRec", "SRGNN", "CLRec",
              "FourierTA", "S3Rec")


def pair(name, **kw):
    """(JAX model, port model) of one registry name at
    test_baseline_models.py's sizes, dropout 0; ``kw`` overrides."""
    base = dict(user_num=N_USERS, item_num=N_ITEMS, emb_size=8)
    edges = np.random.default_rng(1)
    table = dict(
        LightGCN=dict(edge_users=edges.integers(1, N_USERS, 50).astype(
            np.int32), edge_items=edges.integers(1, N_ITEMS, 50).astype(
            np.int32)),
        NeuMF=dict(dropout=0.0),
        SASRec=dict(num_heads=2, history_max=HIST),
        GRU4Rec=dict(hidden_size=12),
        Caser=dict(num_horizon=4, num_vertical=2, L=3, history_max=HIST),
        NARM=dict(hidden_size=12, attention_size=6),
        TiSASRec=dict(num_heads=2, history_max=HIST, time_max=16),
        ComiRec=dict(attn_size=4, K=2, history_max=HIST),
        ContraRec=dict(num_heads=2, history_max=HIST),
        TiMiRec=dict(attn_size=4, K=2, history_max=HIST),
        CLRec=dict(num_heads=2, history_max=HIST),
        S3Rec=dict(num_heads=2, history_max=HIST),
    ).get(name, {})
    kw = dict(base, **table, **kw)
    if name in SEQUENTIAL:
        kw.setdefault("dropout", 0.0)
    if name == "POP":
        kw = dict(popularity=np.random.default_rng(2).random(N_ITEMS)
                  .astype(np.float32))
    jkw = {k: v for k, v in kw.items() if k != "pretrain"}
    return JAX_MODELS[name](**jkw), MODEL_REGISTRY[name](**kw)


def seq_feed(seed, B=4, I=3, pad=0, views=False):
    """test_baseline_models.py's seq_feed with a session graph built from
    the history (the feeds' own builder) and, with ``views``, ContraRec's
    two augmented histories (mask token N_ITEMS among them); the last
    ``pad`` rows zero with row_mask off, as a padded final batch's."""
    rng = np.random.default_rng(seed)
    L = HIST
    lengths = rng.integers(1, L + 1, size=B)
    hist = rng.integers(1, N_ITEMS, size=(B, L))
    hist[np.arange(L)[None, :] >= lengths[:, None]] = 0
    hist[0, :2] = hist[0, 2]     # a repeated item: a node of two slots
    feed = {
        "user_id": rng.integers(1, N_USERS, size=B),
        "item_id": rng.integers(1, N_ITEMS, size=(B, I)),
        "row_mask": np.ones(B, bool),
        "history_item_id": hist,
        "history_times": np.sort(rng.integers(0, 10_000, size=(B, L))),
        "user_min_intervals": rng.integers(1, 50, size=B),
        "lengths": lengths,
        "history_delta_t": rng.integers(0, 10_000, size=(B, L)),
    }
    feed.update(feeds.FeedBuilder._session_graphs(hist))
    if views:
        for k in ("history_item_id_a", "history_item_id_b"):
            v = hist.copy()
            v[rng.random((B, L)) < 0.3] = N_ITEMS
            v[hist == 0] = 0
            feed[k] = v
    if pad:
        for k, v in feed.items():
            v[B - pad:] = 0
    return feed


def s3rec_feed(seed, B=4, pad=1):
    """A pretrain batch of S3Rec (test_baseline_models.py's
    test_s3rec_pretrain_forward), the last ``pad`` rows padding."""
    rng = np.random.default_rng(seed)
    L = HIST
    feed = {k: rng.integers(1, N_ITEMS, size=(B, L)) for k in (
        "mask_seq", "pos_item", "neg_item", "mask_seg_seq", "pos_seg",
        "neg_seg")}
    feed["mask_seq"][:, 2] = N_ITEMS
    feed["mask_seq"][rng.random((B, L)) < 0.2] = N_ITEMS
    feed["seq_len"] = rng.integers(2, L + 1, size=B).astype(np.int32)
    feed["row_mask"] = np.arange(B) < B - pad
    return feed


@functools.lru_cache(maxsize=None)
def start(name, kw=(), pretrain_feed=False):
    """The JAX model and fp32 params holding the port's initial weights
    (init_weights from seed 0), and those weights."""
    kw = dict(kw)
    jm, tm = pair(name, **kw)
    layers.init_weights(tm, torch.Generator().manual_seed(0))
    feed = s3rec_feed(0) if pretrain_feed else seq_feed(0, views=True)
    params = flax_params(jm, tm, {k: jnp.asarray(v) for k, v in
                                  feed.items()}, {})
    return jm, params, {k: v.clone() for k, v in tm.state_dict().items()}


@functools.lru_cache(maxsize=None)
def jax_forwards(name, kw, pretrain, dtype):
    """The JAX model's evaluation and training forwards and the gradient
    of their sum (``total``) in one jitted function, compiled once for
    each shape of feed; and ``total``."""
    jm = start(name, kw, pretrain)[0]
    jdt = jnp.float32
    if dtype == torch.float64:
        jm, jdt = jm.clone(dtype=jnp.float64), jnp.float64

    def run(p, f, mode):
        scores, sown = jm.apply(
            {"params": p}, f, deterministic=mode == "eval",
            rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["losses"])
        return scores, {k: v[0] for k, v in sown.get("losses", {}).items()}

    def total(p, f):
        sc, losses = run(p, f, "train")
        return (jnp.where(f["row_mask"][:, None], sc, 0).sum()
                + sum(losses.values(), jnp.zeros((), jdt)))

    @jax.jit
    def everything(p, f):
        return run(p, f, "eval"), run(p, f, "train"), jax.grad(total)(p, f)
    return everything, total


def forwards(name, feed, kw=(), grads=False, pretrain=False):
    """The JAX model's and the port's forwards on ``feed`` from the same
    weights, dropout 0: per (mode, dtype), mode eval or train, (JAX
    scores, port scores, JAX's sown losses, the port's losses); fp64 too
    for FP64_CASES. With ``grads``, the fp32 gradients of sum(real rows'
    scores) + the losses in training mode, JAX's mapped onto the port's
    keys."""
    _, params32, state = start(name, kw, pretrain)
    out = {}
    dtypes = (torch.float32,) + ((torch.float64,) if name in FP64_CASES
                                 else ())
    for dtype in dtypes:
        _, tm = pair(name, **dict(kw))
        tm.load_state_dict(state)
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        params = jax.tree.map(lambda x: jnp.asarray(x, jdt), params32)
        tm = tm.to(dtype)
        jfeed = {k: jnp.asarray(v) for k, v in feed.items()}
        tfeed = {k: torch.from_numpy(v) for k, v in feed.items()}
        everything, total = jax_forwards(name, kw, pretrain, dtype)
        want_grads = grads and dtype == torch.float32
        jeval, jtrain, jg = everything(params, jfeed)
        if not want_grads:
            jg = None
        for mode, (want, jl) in (("eval", jeval), ("train", jtrain)):
            tm.train(mode == "train")
            got, tl = tm(tfeed)
            out[mode, dtype] = (np.asarray(want), got.detach().numpy(),
                                {k: float(v) for k, v in jl.items()},
                                {k: float(v.detach()) for k, v in
                                 tl.items()})
        if want_grads:
            jg = jax.tree.map(np.asarray, jg)
            if not all(np.isfinite(g).all() for g in jax.tree.leaves(jg)):
                # jnp.linalg.norm's gradient at a zero vector is NaN
                # (torch's is 0): a padded row's zero sequence vector
                # normalised (ContraRec's views, CLRec's InfoNCE) makes
                # JAX's gradient NaN, though the row's terms are masked
                # out. The reference is then JAX's gradient of the real
                # rows alone, the same sum without the padding.
                real = {k: v[feed["row_mask"]] for k, v in jfeed.items()}
                jg = jax.tree.map(np.asarray, jax.jit(jax.grad(total))(
                    params, real))
                out["jax_grad_nan"] = True
            tm.zero_grad(set_to_none=True)
            total_t = (torch.where(tfeed["row_mask"][:, None], got,
                                   torch.zeros_like(got)).sum()
                       + sum(tl.values(), torch.zeros((), dtype=dtype)))
            if total_t.requires_grad:   # POP's scores hold no parameter
                total_t.backward()
            out["grads"] = (segrec_state_dict(tm, jg),
                            {k: (p.grad if p.grad is not None
                                 else torch.zeros_like(p))
                             for k, p in tm.named_parameters()})
        tm.eval()
    return out


def assert_forwards(res, name, tol=FWD_RTOL):
    """fp32 within ``tol``; for FP64_CASES fp64 within ``tol`` and fp32
    within COND times the JAX model's own fp32 rounding where that is
    more. Gradients within GRAD_RTOL of their leaf's largest entry, or,
    where a leaf's gradient is rounding alone (a key bias, which a softmax
    over the keys cancels: zero in exact arithmetic), FWD_RTOL of the
    largest gradient of the model."""
    for mode in ("eval", "train"):
        want, got, jl, tl = res[mode, torch.float32]
        assert got.shape == want.shape, (name, mode)
        assert np.isfinite(got).all(), (name, mode)
        bound, lbound = tol, {k: tol for k in jl}
        if (mode, torch.float64) in res:
            want64, got64, jl64, tl64 = res[mode, torch.float64]
            assert _rel(got64, want64) <= tol, (name, mode)
            bound = max(tol, COND * _rel(want, want64))
            for k in jl:
                assert abs(tl64[k] - jl64[k]) <= tol * abs(jl64[k]), (name, k)
                lbound[k] = max(tol, COND * abs(jl[k] / jl64[k] - 1))
        assert _rel(got, want) <= bound, (name, mode, _rel(got, want), bound)
        assert set(tl) == set(jl), (name, mode, jl, tl)
        for k in jl:
            assert abs(tl[k] - jl[k]) <= lbound[k] * abs(jl[k]), (name, k,
                                                                  jl, tl)
    if "grads" in res:
        want, got = res["grads"]
        assert set(want) == set(got), name
        top = max(np.abs(w.numpy()).max() for w in want.values())
        for k, w in want.items():
            g = got[k].detach().numpy()
            assert np.isfinite(g).all(), (name, k)
            d = np.abs(g - w.numpy()).max()
            bound = max(GRAD_RTOL * np.abs(w.numpy()).max(), FWD_RTOL * top)
            assert d <= bound, (name, k, d, bound)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("name", GENERAL)
def test_forward_matches_jax(name, padded):
    """Scores (evaluation and training mode), and on a final batch of 5
    real rows padded to 8 the gradients, against JAX's."""
    feed = seq_feed(3, B=8, pad=3) if padded else seq_feed(7, B=8)
    assert_forwards(forwards(name, feed, grads=True), name)


def test_registry_holds_every_model():
    """Every model of the JAX registry and the KG family has its port:
    model_class finds each, and an unknown name raises ValueError."""
    from segmminterest_tpu.segrec.kg import KG_MODELS as JAX_KG
    names = GENERAL + SEQUENTIAL
    assert len(names) == 19 and set(names) <= set(MODEL_REGISTRY)
    assert set(JAX_MODELS) - set(MODEL_REGISTRY) == set()
    assert JAX_KG == {"CFKG", "SLRCPlus", "Chorus", "KDA"}
    for name in sorted(set(JAX_MODELS) | JAX_KG):
        assert model_class(name).__name__.endswith("Model"), name
    with pytest.raises(ValueError, match="unknown model"):
        model_class("NoSuchModel")


def test_loss_routes_match_jax():
    """The runner's BUIR, DirectAU and ContraRec routes on the same weights
    and batch (the first candidate column as the model saw it)."""
    feed = seq_feed(4, B=8, pad=2)
    tfeed = {k: torch.from_numpy(v) for k, v in feed.items()}
    jfeed = {k: jnp.asarray(v) for k, v in feed.items()}
    rm = feed["row_mask"]
    jm, params, state = start("BUIR")
    _, tm = pair("BUIR")
    tm.load_state_dict(state)
    with torch.no_grad():   # the targets away from the online tables
        tm.user_target.weight.mul_(-0.5)
    params = dict(params, user_target={
        "embedding": tm.user_target.weight.detach().numpy().copy()})
    want = float(JAX_MODELS["BUIR"].buir_loss(
        params, jfeed["user_id"].astype(jnp.int32),
        jfeed["item_id"][:, 0].astype(jnp.int32),
        jnp.asarray(rm, jnp.float32)))
    got = float(tm.buir_loss(tfeed["user_id"], tfeed["item_id"][:, 0],
                             tfeed["row_mask"]).detach())
    assert abs(got / want - 1) <= FWD_RTOL
    rng = np.random.default_rng(5)
    u = rng.normal(size=(8, 8)).astype(np.float32)
    i = rng.normal(size=(8, 8)).astype(np.float32)
    for gamma in (1.0, 0.5):
        want = float(JAX_MODELS["DirectAU"].direct_au_loss(
            jnp.asarray(u), jnp.asarray(i), jnp.asarray(rm, jnp.float32),
            gamma))
        got = float(direct_au_loss(torch.from_numpy(u), torch.from_numpy(i),
                                   torch.from_numpy(rm), gamma))
        assert abs(got / want - 1) <= FWD_RTOL
    pred = rng.normal(size=(8, 5)).astype(np.float32)
    for temp in (1.0, 0.2):
        jr = jrunner.RankingRunner.__new__(jrunner.RankingRunner)
        jr.cfg = jrunner.RunnerConfig(loss_n="ContraRec", ctc_temp=temp)
        want = float(jr._loss(jnp.asarray(pred), {"row_mask": jnp.asarray(
            rm)}))
        tr = runner.RankingRunner(tm, runner.RunnerConfig(
            loss_n="ContraRec", ctc_temp=temp), device="cpu")
        got = float(tr._loss(torch.from_numpy(pred),
                             {"row_mask": torch.from_numpy(rm)}))
        assert abs(got / want - 1) <= FWD_RTOL


def test_buir_sync_and_momentum_match_jax():
    jm, params, state = start("BUIR")
    _, tm = pair("BUIR", momentum=0.9)
    tm.load_state_dict(state)
    want = JAX_MODELS["BUIR"].sync_targets(params)
    tm.sync_targets()
    with torch.no_grad():
        tm.user_online.weight.add_(0.01)
    want = dict(want, user_online={
        "embedding": tm.user_online.weight.detach().numpy().copy()})
    want = JAX_MODELS["BUIR"].momentum_update(want, 0.9)
    tm.momentum_update()
    for k, v in segrec_state_dict(tm, jax.tree.map(np.asarray,
                                                   want)).items():
        np.testing.assert_array_equal(tm.state_dict()[k].numpy(), v.numpy(),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# lock-step training of the ranking routes

def _builders(side, args, corpus, phases=("train", "dev", "test")):
    """Each main's FeedBuilders for ``args`` (the JAX CLI's wiring, which
    the port's main repeats)."""
    fm = jfeeds if side == "jax" else feeds
    hist = args.model_name in main.SEQ_MODELS
    return {p: fm.FeedBuilder(
        corpus, p, task="ranking", num_neg=args.num_neg,
        history_max=args.history_max, include_history=hist,
        augment_history=args.model_name == "ContraRec",
        beta_a=args.beta_a, beta_b=args.beta_b,
        session_graph=args.model_name == "SRGNN",
        s3rec_pretrain=(args.model_name == "S3Rec" and args.s3rec_stage == 1
                        and p == "train"),
        s3rec_mask_ratio=args.mask_ratio,
        test_all=bool(args.test_all) and p != "train", seed=0)
        for p in phases}


def ranking_argv(data, name, extra=()):
    return ["--model_name", name, "--path", data["dir"], "--dataset",
            "SegMM", "--model_mode", "Ranking", "--emb_size", "16",
            "--history_max", "6", "--batch_size", "48",
            "--eval_batch_size", "64", "--lr", str(LR), "--num_neg", "3",
            "--use_mesh", "0", "--topk", "1,3", *extra]


def ranking_setups(data, argv, loss_n):
    """The JAX and the port's ranking runners on ``argv`` from the port's
    initial weights (BUIR's targets synced first), loss route ``loss_n``
    (the port's main picks it too), and each side's builders."""
    out = {}
    pargs = main.build_parser().parse_args(argv)
    assert main.loss_name(pargs, "ranking") == loss_n
    model = main.build_model(pargs, Corpus(pargs.path, pargs.dataset), False)
    if hasattr(model, "sync_targets"):
        model.sync_targets()
    for side in ("jax", "torch"):
        m = jmain if side == "jax" else main
        args = m.build_parser().parse_args(argv)
        corpus = (JaxCorpus if side == "jax" else Corpus)(args.path,
                                                          args.dataset)
        cfg = dict(lr=args.lr, l2=args.l2, batch_size=args.batch_size,
                   eval_batch_size=args.eval_batch_size, epoch=1, seed=0,
                   metrics=("NDCG", "HR"), topk=(1, 3), loss_n=loss_n,
                   ctc_temp=args.ctc_temp)
        builders = _builders(side, args, corpus)
        if side == "jax":
            jm = jmain.build_model(args, corpus, False)
            r = jrunner.RankingRunner(jm, jrunner.RunnerConfig(**cfg))
            example = next(_builders(side, args, corpus, ("train",))[
                "train"].batches(args.batch_size, shuffle=False)) \
                if args.model_name == "S3Rec" and args.s3rec_stage == 1 \
                else next(builders["dev"].batches(64, shuffle=False))
            p32 = flax_params(jm, model, jrunner._device_feed(example), {})
            out[side] = (r, {"params": p32,
                             "opt_state": r.optimizer.init(p32)}, builders)
        else:
            r = runner.RankingRunner(model, runner.RunnerConfig(**cfg),
                                     device="cpu")
            out[side] = (r, None, builders)
    return out


def lockstep_ranking(data, name, loss_n, extra=()):
    """Five ranking steps (Adam, dropout 0) of the two runners in lock step
    from the same weights and batches: the losses within LOSS_RTOL, every
    weight within Adam's bound, the trained models' training-mode scores
    on a dev batch (their differences from the target's) within
    LOSS_RTOL. BUIR's momentum update follows each JAX step, as its fit
    applies it."""
    s = ranking_setups(data, ranking_argv(data, name, extra), loss_n)
    jr, jstate, jb = s["jax"]
    pr, _, pb = s["torch"]
    jb, pb, jb_dev = jb["train"], pb["train"], jb["dev"]
    jb.actions_before_epoch()
    pb.actions_before_epoch()
    jl, pl = [], []
    B = pr.cfg.batch_size
    for step, (jf, pf) in enumerate(zip(jb.batches(B, True),
                                        pb.batches(B, True))):
        if step == STEPS:
            break
        if "item_id" in jf:
            jf, _ = jr._shuffled_batch(jf)
            pf = pr._shuffled_batch(pf)
        _frame_equal(pf, jf, f"step {step}")
        seed = int(jr.rng.integers(0, 2 ** 31 - 1))
        assert seed == int(pr.rng.integers(0, 2 ** 31 - 1))
        jstate, loss = jr._jit_train(jstate, jrunner._device_feed(jf),
                                     jax.random.PRNGKey(seed))
        if jr._momentum_update is not None:
            jstate = dict(jstate, params=jr._momentum_update(
                jstate["params"]))
        jl.append(float(loss))
        pl.append(float(pr.train_step(pf, seed)))
    assert len(jl) == STEPS and len(set(jl)) == STEPS, jl
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    want = segrec_state_dict(pr.model,
                             jax.tree.map(np.asarray, jstate["params"]))
    got = pr.model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        d = np.abs(got[k].numpy() - v.numpy()).max()
        assert d <= ADAM_BOUND, (k, d)
    feed = next(jb_dev.batches(64, shuffle=False))
    want, _ = jax.jit(lambda v, f: jr._apply(
        v, f, False, {"dropout": jax.random.PRNGKey(0)},
        mutable=["losses"]))({"params": jstate["params"]},
                             jrunner._device_feed(feed))
    want = np.asarray(want)
    pr.model.train()
    with torch.no_grad():
        got = pr._forward(pr.put(feed))[0].numpy()
    pr.model.eval()
    assert _rel(got - got[:, :1], want - want[:, :1]) <= LOSS_RTOL
    return jr, jstate, pr


@pytest.mark.parametrize("l2", [0.0, 1e-4])
def test_lockstep_buir(data, l2):
    """BUIR's bootstrap loss, its target tables (parameters that the loss
    gives no gradient: --l2 moves them) and the momentum update after
    every step."""
    lockstep_ranking(data, "BUIR", "BUIR", ("--l2", str(l2)))


def test_lockstep_directau(data):
    lockstep_ranking(data, "DirectAU", "DirectAU", ("--loss_n", "DirectAU"))


# ---------------------------------------------------------------------------
# full-sort evaluation

@pytest.mark.parametrize("phase", ["dev", "test"])
def test_test_all_feeds_match_jax(data, phase):
    out = []
    for corpus_cls, mod in ((JaxCorpus, jfeeds), (Corpus, feeds)):
        b = mod.FeedBuilder(corpus_cls(data["dir"], "SegMM"), phase,
                            task="ranking", history_max=5,
                            include_history=True, test_all=True, seed=2)
        batches = []
        for _ in range(2):
            b.actions_before_epoch()
            batches += list(b.batches(16, shuffle=False))
        out.append((b, batches))
    (jb, want), (pb, got) = out
    assert len(got) == len(want) > 2
    for i, (g, w) in enumerate(zip(got, want)):
        _frame_equal(g, w, f"batch {i}")
    n_items = pb.corpus.n_items
    np.testing.assert_array_equal(want[0]["item_id"][0, 1:],
                                  np.arange(1, n_items))


@pytest.fixture(scope="module")
def bprmf_msgpack(data, tmp_path_factory):
    """BPRMF trained one epoch by the JAX CLI, its .msgpack."""
    path = str(tmp_path_factory.mktemp("bprmf") / "bprmf.msgpack")
    jmain.main(ranking_argv(data, "BPRMF", ("--epoch", "1", "--model_path",
                                            path)))
    return path


def test_test_all_predictions_match_jax(data, bprmf_msgpack):
    """Full-sort predictions of the same BPRMF weights: (rows, n_items),
    each row's clicked items at -inf, column 0 the target's own column bit
    for bit; the predictions and HR / NDCG the JAX runner's."""
    from flax import serialization
    path = bprmf_msgpack
    argv = ranking_argv(data, "BPRMF", ("--test_all", "1"))
    s = ranking_setups(data, argv, "BPR")
    jr, jstate, jb = s["jax"]
    pr, _, pb = s["torch"]
    with open(path, "rb") as f:
        params = serialization.from_bytes(
            jax.tree.map(np.asarray, jstate["params"]), f.read())
    pr.load_state(path)
    for phase in ("dev", "test"):
        want = jr.predict(jb[phase], {"params": params})
        got = pr.predict(pb[phase])
        corpus = pb[phase].corpus
        assert got.shape == want.shape == (len(pb[phase]), corpus.n_items)
        assert _rel(np.where(np.isinf(got), 0, got),
                    np.where(np.isinf(want), 0, want)) <= FWD_RTOL
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        for r, u in enumerate(pb[phase].user_id):
            clicked = sorted(corpus.train_clicked_set.get(u, set())
                             | corpus.residual_clicked_set.get(u, set()))
            assert (got[r, clicked] == -np.inf).all()
            assert np.isfinite(got[r, 0])
        # before the clicked items leave: the target's score at column 0
        # and at its own id's column, the same bits
        feed = next(pb[phase].batches(64, shuffle=False))
        raw = pr.eval_scores(feed)
        rows = np.flatnonzero(feed["row_mask"])
        target = feed["item_id"][rows, 0]
        np.testing.assert_array_equal(raw[rows, 0], raw[rows, target])
        assert runner.evaluate_ranking(got, [1, 5, 20], ["HR", "NDCG"]) == \
            jrunner.evaluate_ranking(want, [1, 5, 20], ["HR", "NDCG"])


@pytest.mark.usefixtures("one_torch_thread")
def test_main_test_all_matches_jax(data, bprmf_msgpack):
    """Both CLIs evaluate the JAX run's BPRMF with --test_all 1 (--train
    0): the same HR / NDCG on dev and test."""
    path = bprmf_msgpack
    argv = ranking_argv(data, "BPRMF", ("--test_all", "1", "--train", "0",
                                        "--model_path", path, "--topk",
                                        "1,5,20"))
    want = jmain.main(argv)
    got = main.main(argv + ["--device", "cpu"])
    for split in ("dev", "test"):
        assert list(got[split]) == list(want[split])
        for k, v in want[split].items():
            assert abs(got[split][k] - v) <= METRIC_ATOL, (split, k)


# ---------------------------------------------------------------------------
# .msgpack loads

def check_msgpack_load(name, tmp_path, kw=(), pretrain=False):
    """The JAX runner's .msgpack of ``name``'s params (flax to_bytes) loads
    whole into the port's model through the runner's load_state, every
    leaf bit for bit."""
    from flax import serialization
    _, params, _ = start(name, kw, pretrain)
    _, tm = pair(name, **dict(kw))
    path = tmp_path / f"{name}.msgpack"
    path.write_bytes(serialization.to_bytes(params))
    r = runner.RankingRunner(tm, runner.RunnerConfig(), device="cpu")
    r.load_state(str(path))
    want = segrec_state_dict(tm, params)
    assert set(want) == set(tm.state_dict())
    for k, v in want.items():
        torch.testing.assert_close(tm.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("name", GENERAL)
def test_load_state_msgpack(name, tmp_path):
    check_msgpack_load(name, tmp_path)


def test_pop_state_is_its_dummy():
    """POP's popularity and LightGCN's edges are buffers out of the
    state_dict, as static fields are out of the JAX params."""
    assert list(pair("POP")[1].state_dict()) == ["dummy"]
    assert sorted(pair("LightGCN")[1].state_dict()) == ["i_embeddings",
                                                        "u_embeddings"]

