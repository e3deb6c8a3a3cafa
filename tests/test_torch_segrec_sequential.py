"""The port's SegRec sequential models (segmminterest_tpu_torch/segrec/
models/sequential.py: SASRec through S3Rec), their feeds and two-stage
runs against the JAX package's on the CPU, with
test_torch_segrec_general.py's helpers and bounds:

* each model's forward, TiMiRec in both stages, ContraRec with both
  encoders and S3Rec on a pretrain batch: scores and the models' own
  terms (ContraRec's CCC, CLRec's InfoNCE, TiMiRec's KL, S3Rec's pretrain
  loss) within 1e-6 relative in evaluation and in training mode (dropout
  0); on a final batch of 5 real rows padded to 8 (their histories empty,
  so every attention score of theirs is masked) every gradient finite and
  within GRAD_RTOL of JAX's;
* flax's LayerNorm epsilon (1e-6) on inputs of a small variance, where
  torch's default 1e-5 would move the scores;
* ComiRec's training branch on tied interests (the first, as jnp.argmax);
* the augment_history, session_graph and s3rec_pretrain feeds over two
  epochs, key for key and bit for bit;
* five lock-step steps (Adam, dropout 0) of SASRec (BPR), NARM,
  ContraRec, CLRec, S3Rec's pretrain and TiMiRec's finetune;
* each model's state from the JAX runner's .msgpack; S3Rec's and
  TiMiRec's second stage from the first stage's .msgpack and .pt
  (partial), scoring as JAX's partial load;
* segrec.main --device cpu --model_mode TopK for each of the 19 general
  and sequential models, S3Rec's --s3rec_stage 1 then 2 --load 1 and
  TiMiRec's pretrain then finetune --load 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from segmminterest_tpu.segrec import feeds as jfeeds
from segmminterest_tpu.segrec import runner as jrunner
from segmminterest_tpu.segrec.corpus import Corpus as JaxCorpus
from segmminterest_tpu_torch.segrec import feeds, layers, runner
from segmminterest_tpu_torch.segrec.corpus import Corpus
from segmminterest_tpu_torch.segrec.models import sequential
from test_torch_segrec import FWD_RTOL, _frame_equal, _rel, \
    data  # noqa: F401 (fixture)
from test_torch_segrec_context import (flax_params, one_torch_thread,
                                       run_main)  # noqa: F401 (fixture)
from test_torch_segrec_general import (GENERAL, SEQUENTIAL, assert_forwards,
                                       check_msgpack_load, forwards,
                                       lockstep_ranking, pair, s3rec_feed,
                                       seq_feed, start)

FORWARD_CASES = {
    **{name: (name, ()) for name in SEQUENTIAL if name != "TiMiRec"},
    "TiMiRec-pretrain": ("TiMiRec", (("stage", "pretrain"),)),
    "TiMiRec-finetune": ("TiMiRec", (("stage", "finetune"),)),
    "ContraRec-GRU4Rec": ("ContraRec", (("encoder", "GRU4Rec"),)),
    "ComiRec-no_pos": ("ComiRec", (("add_pos", False),)),
}


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_jax(case, padded):
    name, kw = FORWARD_CASES[case]
    views = name == "ContraRec"
    feed = (seq_feed(3, B=8, pad=3, views=views) if padded
            else seq_feed(7, B=8, views=views))
    res = forwards(name, feed, kw, grads=True)
    assert_forwards(res, case)
    # JAX's own gradient is NaN on the padded batch where a padded row's
    # zero vector is normalised; the port's is finite (forwards)
    assert res.get("jax_grad_nan", False) == (padded and name in (
        "ContraRec", "CLRec")), case
    terms = {"ContraRec": {"contrarec_ccc"}, "CLRec": {"clrec_infonce"},
             "TiMiRec": {"timirec_kl"} if "finetune" in case else set()}
    assert set(res["train", torch.float32][3]) == terms.get(name, set())
    assert not res["eval", torch.float32][3]


def test_s3rec_pretrain_matches_jax():
    """S3Rec's pretrain loss on a pretrain batch (the JAX test's) of 5 real
    rows padded to 8, and its gradients."""
    feed = s3rec_feed(5, B=8, pad=3)
    res = forwards("S3Rec", feed, (("pretrain", True),), grads=True,
                   pretrain=True)
    assert_forwards(res, "S3Rec-pretrain")
    assert set(res["train", torch.float32][3]) == {"s3rec_pretrain"}
    assert res["train", torch.float32][3]["s3rec_pretrain"] > 0


def test_layer_norm_epsilon_is_flax():
    """Every LayerNorm at flax's epsilon; and on inputs of a small variance
    (every weight scaled by 1e-3, the LayerNorms' own aside), where torch's
    1e-5 would move the normalised values by a large share, the scores
    still JAX's."""
    for name in ("SASRec", "TiSASRec", "TiMiRec", "ContraRec", "CLRec",
                 "FourierTA", "S3Rec"):
        _, tm = pair(name)
        lns = [m for m in tm.modules() if isinstance(m, torch.nn.LayerNorm)]
        assert lns and all(m.eps == 1e-6 for m in lns), name
    for name in ("SASRec", "FourierTA", "S3Rec"):
        jm, tm = pair(name)
        layers.init_weights(tm, torch.Generator().manual_seed(4))
        with torch.no_grad():
            for n, p in tm.named_parameters():
                if ".ln" not in n and "layer_norm" not in n \
                        and not n.startswith("ln"):
                    p.mul_(1e-3)
        feed = seq_feed(8)
        jfeed = {k: jnp.asarray(v) for k, v in feed.items()}
        params = flax_params(jm, tm, jfeed, {})
        want = np.asarray(jax.jit(lambda p, f: jm.apply(
            {"params": p}, f, deterministic=True))(params, jfeed))
        tm.eval()
        got = tm({k: torch.from_numpy(v) for k, v in feed.items()})[0]
        assert _rel(got.detach().numpy(), want) <= FWD_RTOL, name
        for m in tm.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.eps = 1e-5
        wrong = tm({k: torch.from_numpy(v) for k, v in feed.items()})[0]
        assert _rel(wrong.detach().numpy(), want) > 100 * FWD_RTOL, name


def test_multi_interest_ties_take_the_first():
    """ComiRec's training branch where two interests tie on the target:
    the first is taken, as jnp.argmax takes it."""
    interests = torch.tensor([[[1.0, 0.0], [0.0, 1.0]],
                              [[2.0, 1.0], [1.0, 2.0]]])
    i_vectors = torch.tensor([[[1.0, 1.0], [3.0, 0.0]],
                              [[1.0, 1.0], [0.0, 1.0]]])
    module = torch.nn.Module().train()
    got = sequential._multi_interest_scores(module, interests, i_vectors)
    sel = np.asarray(jnp.argmax(jnp.asarray(
        (interests * i_vectors[:, :1]).sum(-1).numpy()), -1))
    assert sel.tolist() == [0, 0]
    want = (interests[[0, 1], sel][:, None, :] * i_vectors).sum(-1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    module.eval()
    want = (interests[:, None] * i_vectors[:, :, None]).sum(-1).max(-1)[0]
    torch.testing.assert_close(
        sequential._multi_interest_scores(module, interests, i_vectors),
        want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# feeds

FEED_CASES = {
    "augment_history": (dict(augment_history=True, beta_a=2, beta_b=5),
                        "train"),
    "session_graph-train": (dict(session_graph=True), "train"),
    "session_graph-dev": (dict(session_graph=True), "dev"),
    "s3rec_pretrain": (dict(s3rec_pretrain=True, s3rec_mask_ratio=0.3),
                       "train"),
}


@pytest.mark.parametrize("case", list(FEED_CASES))
def test_feeds_match_jax(data, case):
    kw, phase = FEED_CASES[case]
    out = []
    for corpus_cls, mod in ((JaxCorpus, jfeeds), (Corpus, feeds)):
        b = mod.FeedBuilder(corpus_cls(data["dir"], "SegMM"), phase,
                            task="ranking", num_neg=2, history_max=5,
                            include_history=True, seed=6, **kw)
        batches = []
        for _ in range(2):  # two epochs: views, negatives, order drawn anew
            b.actions_before_epoch()
            batches += list(b.batches(32, shuffle=phase == "train"))
        out.append((len(b), batches))
    (jn, want), (pn, got) = out
    assert pn == jn and len(got) == len(want) > 2
    for i, (g, w) in enumerate(zip(got, want)):
        _frame_equal(g, w, f"batch {i}")
    keys = set(want[0])
    if "augment_history" in kw:
        rm = np.concatenate([b["row_mask"] for b in want])
        a = np.concatenate([b["history_item_id_a"] for b in want])[rm]
        h = np.concatenate([b["history_item_id"] for b in want])[rm]
        assert (a != h).any()
    if "session_graph" in kw:
        assert {"srgnn_alias", "srgnn_items", "srgnn_A"} <= keys
    if "s3rec_pretrain" in kw:
        assert "item_id" not in keys and "mask_seq" in keys
        n_items = Corpus(data["dir"], "SegMM").n_items
        assert (np.concatenate([b["mask_seq"] for b in want])
                == n_items).any()


# ---------------------------------------------------------------------------
# lock-step training

LOCKSTEP = {
    "SASRec": ("SASRec", "BPR", ()),
    "NARM": ("NARM", "BPR", ()),
    "ContraRec": ("ContraRec", "ContraRec", ()),
    "CLRec": ("CLRec", "CLRec", ()),
    # the pretrain corpus's chunks of 6: 16 a batch for five steps
    "S3Rec-pretrain": ("S3Rec", "S3Rec", ("--s3rec_stage", "1",
                                          "--batch_size", "16")),
    "TiMiRec-finetune": ("TiMiRec", "BPR", ()),
}


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_lockstep_matches_jax(data, case):
    name, loss_n, extra = LOCKSTEP[case]
    lockstep_ranking(data, name, loss_n, extra)


# ---------------------------------------------------------------------------
# loads

LOADS = {**{n: () for n in SEQUENTIAL},
         "S3Rec-pretrain": (("pretrain", True),),
         "TiMiRec-pretrain": (("stage", "pretrain"),),
         "TiMiRec-3layers": (("n_layers", 3),),
         "ContraRec-GRU4Rec": (("encoder", "GRU4Rec"),)}


@pytest.mark.parametrize("case", list(LOADS))
def test_load_state_msgpack(case, tmp_path):
    check_msgpack_load(case.split("-")[0], tmp_path, LOADS[case],
                       pretrain=case == "S3Rec-pretrain")


TWO_STAGE = {
    "S3Rec": ((("pretrain", True),), ()),
    "TiMiRec": ((("stage", "pretrain"),), (("stage", "finetune"),)),
}


@pytest.mark.parametrize("name", list(TWO_STAGE))
def test_second_stage_loads_the_first(name, tmp_path):
    """The first stage's weights (with S3Rec's mip_norm and sp_norm, which
    the second stage lacks; TiMiRec's pretrain lacks the predictor) load
    into the second stage's model in part, from the JAX runner's .msgpack
    and from the port's .pt: every shared weight taken, the others kept,
    and the scores of JAX's partial load of the same file."""
    kw1, kw2 = TWO_STAGE[name]
    pre = name == "S3Rec"
    _, params1, state1 = start(name, kw1, pre)
    jm2, tm2 = pair(name, **dict(kw2))
    layers.init_weights(tm2, torch.Generator().manual_seed(1))
    feed = seq_feed(9)
    jfeed = {k: jnp.asarray(v) for k, v in feed.items()}
    p2 = flax_params(jm2, tm2, jfeed, {})
    path = tmp_path / "stage1.msgpack"
    path.write_bytes(serialization.to_bytes(params1))
    jr = jrunner.RankingRunner(jm2, jrunner.RunnerConfig())
    jstate = jr.load_state({"params": p2, "opt_state": None}, str(path),
                           partial=True)
    want = np.asarray(jax.jit(lambda p, f: jm2.apply(
        {"params": p}, f, deterministic=True))(jstate["params"], jfeed))
    _, tm1 = pair(name, **dict(kw1))
    tm1.load_state_dict(state1)
    pt = str(tmp_path / "stage1.pt")
    runner.RankingRunner(tm1, runner.RunnerConfig(),
                         device="cpu").save_state(tm1.state_dict(), pt)
    fresh = {k: v.clone() for k, v in tm2.state_dict().items()}
    for src in (str(path), pt):
        tm2.load_state_dict(fresh)
        r = runner.RankingRunner(tm2, runner.RunnerConfig(), device="cpu")
        r.load_state(src, partial=True)
        for k, v in tm2.state_dict().items():
            torch.testing.assert_close(v, state1[k] if k in state1
                                       else fresh[k], rtol=0, atol=0)
        got = r.eval_scores(feed)
        assert _rel(got, want) <= FWD_RTOL, src
    assert set(state1) ^ set(fresh)   # each stage has weights of its own


# ---------------------------------------------------------------------------
# the CLI, on the CPU

@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("name", GENERAL + SEQUENTIAL)
def test_main_cpu_runs(data, name, tmp_path):
    """segrec.main --device cpu --model_mode TopK trains an epoch and
    evaluates each model with its own loss route."""
    run_main(data, name, "TopK", tmp_path, ("--model_mode", "TopK"))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("name,first,second", [
    ("S3Rec", ("--s3rec_stage", "1"), ("--s3rec_stage", "2")),
    ("TiMiRec", ("--timirec_stage", "pretrain"),
     ("--timirec_stage", "finetune"))])
def test_main_two_stages(data, name, first, second, tmp_path):
    """The first stage saves its state (.pt) to --model_path; the second
    loads it in part (--load 1) and trains on."""
    pt = str(tmp_path / f"{name}.pt")
    topk = ("--model_mode", "TopK", "--model_path", pt)
    run_main(data, name, "TopK", tmp_path, first + topk)
    stage1 = torch.load(pt, weights_only=True)
    run_main(data, name, "TopK", tmp_path, second + topk + ("--load", "1"))
    stage2 = torch.load(pt, weights_only=True)
    assert set(stage1) != set(stage2)
