"""The port's SegRec AdaGIN, DIEN, CAN, SDIM, ETA and the six Clip variants
(segmminterest_tpu_torch/segrec/models/{adagin,dien,can,sdim,
clip_variants}.py) against the JAX package's on the CPU, with
test_torch_segrec_context.py's helpers and bounds:

* each model's forward and the options the CLI exposes (DIEN's three GRU
  types and its auxiliary loss, CAN's orders, ETA without its long
  branch, the Clip variants with frames, ClipDCNv2Rec's full-matrix
  cross): fp64 within 1e-6 relative, fp32 within 1e-6 in evaluation and
  1e-5 in training mode (dropout 0); AdaGIN's given the Gumbel noise
  jax.random drew (the port's test seam);
* the neg_history feed (DIEN's history negatives) bit for bit;
* ETA's top-k on tied similarities in jax.lax.top_k's order;
* SDIM's and ETA's hash codes against JAX's on the same inputs;
* DIEN's batch-axis softmax on a final batch of 5 real rows padded to 8;
* AdaGIN's sampling in evaluation;
* each model's state from the JAX runner's .msgpack;
* five lock-step CTR steps (Adam, dropout 0) of AdaGIN (JAX's noise
  injected), DIEN with alpha_aux 0.1, CAN, SDIM, ETA, ClipDIENRec and
  ClipAdaGINRec;
* segrec.main --device cpu for each model in CTR and ranking mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.segrec import feeds as jfeeds
from segmminterest_tpu.segrec.corpus import Corpus as JaxCorpus
from segmminterest_tpu.segrec.models import adagin as jadagin
from segmminterest_tpu_torch.segrec import feeds, layers
from segmminterest_tpu_torch.segrec.corpus import Corpus
from segmminterest_tpu_torch.segrec.models import sdim
from test_torch_segrec import _frame_equal, data  # noqa: F401 (fixture)
from test_torch_segrec_context import (assert_forward, check_load_state,
                                       forward_pair, lockstep, models,
                                       one_torch_thread, run_main,
                                       small_feed)  # noqa: F401 (fixture)


class GumbelTap:
    """Records the Gumbel noise the JAX AdaGIN draws (its module's
    gumbel_softmax, wrapped), jitted or not: the n-th draw since the last
    trace started at reset() is drawn()[n]."""

    def __init__(self, monkeypatch):
        self.store, self.n = {}, 0

        def tap(rng, logits, tau, axis):
            g = jax.random.gumbel(rng, logits.shape, dtype=jnp.float32)
            i, self.n = self.n, self.n + 1
            jax.debug.callback(
                lambda x, i=i: self.store.__setitem__(i, np.asarray(x)), g)
            return jax.nn.softmax((logits.astype(jnp.float32) + g) / tau,
                                  axis=axis)
        monkeypatch.setattr(jadagin, "gumbel_softmax", tap)

    def reset(self):
        self.n = 0

    def drawn(self):
        return [torch.from_numpy(np.array(self.store[i]))
                for i in sorted(self.store)]


FORWARD_CASES = {
    "AdaGIN": ("AdaGIN", False, {}),
    "AdaGIN-all_layers": ("AdaGIN", False, dict(only_use_last_layer=False,
                                                num_gnn_layers=2)),
    "DIEN-AGRU": ("DIEN", False, {}),
    "DIEN-AUGRU": ("DIEN", False, dict(evolving_gru_type="AUGRU")),
    "DIEN-AIGRU": ("DIEN", False, dict(evolving_gru_type="AIGRU")),
    "DIEN-alpha_aux": ("DIEN", False, dict(alpha_aux=0.1)),
    "CAN": ("CAN", False, {}),
    "CAN-orders2": ("CAN", False, dict(orders=2, co_action_layers=(4, 2))),
    "SDIM": ("SDIM", False, dict(num_hashes=2)),
    "ETA": ("ETA", False, dict(num_hashes=2, dnn_layers=(16, 8))),
    "ETA-short_only": ("ETA", False, dict(history_max=5)),
    "ClipDCNv2Rec": ("ClipDCNv2Rec", False, dict(cross_layer_num=2)),
    "ClipDCNv2Rec-full-frames": ("ClipDCNv2Rec", True, dict(
        mixed=False, cross_layer_num=2, duration_mask=True)),
    "ClipAutoIntRec": ("ClipAutoIntRec", False, {}),
    "ClipAutoIntRec-frames": ("ClipAutoIntRec", True, dict(
        adjust_interest_weight=True)),
    "ClipFinalMLPRec": ("ClipFinalMLPRec", False, {}),
    "ClipFinalMLPRec-frames-no_fs": ("ClipFinalMLPRec", True, dict(
        use_fs=False)),
    "ClipAdaGINRec": ("ClipAdaGINRec", False, {}),
    "ClipAdaGINRec-frames": ("ClipAdaGINRec", True, {}),
    "ClipDIENRec": ("ClipDIENRec", False, {}),
    "ClipDIENRec-frames": ("ClipDIENRec", True, dict(
        norm_interest_type="softmax", duration_mask=True)),
    "ClipCANRec": ("ClipCANRec", False, {}),
    "ClipCANRec-frames": ("ClipCANRec", True, dict(
        adjust_interest_weight=True)),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_jax(case, monkeypatch):
    name, frames, kw = FORWARD_CASES[case]
    tap = GumbelTap(monkeypatch) if "AdaGIN" in name else None
    feed = small_feed(7, frames=frames,
                      neg_history=bool(kw.get("alpha_aux")))
    res = forward_pair(name, frames, kw, feed=feed, noise=tap)
    assert_forward(res, case)
    if kw.get("alpha_aux"):   # the pre-weighted auxiliary loss, in training
        assert set(res["train", torch.float32][3]) == {"aux_loss"}


@pytest.mark.parametrize("name,frames", [
    ("AdaGIN", False), ("DIEN", False), ("CAN", False), ("SDIM", False),
    ("ETA", False), ("ClipDCNv2Rec", True), ("ClipAutoIntRec", True),
    ("ClipFinalMLPRec", True), ("ClipAdaGINRec", True),
    ("ClipDIENRec", True), ("ClipCANRec", True)])
def test_load_state_msgpack(name, frames, tmp_path):
    check_load_state(name, tmp_path, use_frames=frames)


# ---------------------------------------------------------------------------
# the quirks that need a case of their own

@pytest.mark.parametrize("task,dataset", [("ctr", "SegMM_CTR"),
                                          ("ranking", "SegMM")])
def test_neg_history_feeds_match_jax(data, task, dataset):
    """DIEN's history negatives drawn by the two builders over two epochs,
    before the ranking negatives and from the same generator: every batch
    key for key and bit for bit."""
    out = []
    for corpus_cls, mod in ((JaxCorpus, jfeeds), (Corpus, feeds)):
        b = mod.FeedBuilder(corpus_cls(data["dir"], dataset), "train",
                            task=task, num_neg=3, history_max=5,
                            include_history=True, neg_history=True, seed=4)
        batches = []
        for _ in range(2):
            b.actions_before_epoch()
            batches += list(b.batches(32, shuffle=True))
        out.append(batches)
    want, got = out
    assert len(got) == len(want) > 2
    for i, (g, w) in enumerate(zip(got, want)):
        _frame_equal(g, w, f"batch {i}")
    real = np.concatenate([b["row_mask"] for b in want])
    neg = np.concatenate([b["history_neg_item_id"] for b in want])[real]
    pos = np.concatenate([b["history_item_id"] for b in want])[real]
    assert (neg != pos).all() and "history_neg_i_duration" in want[0]


def test_eta_topk_keeps_jax_order_on_ties():
    """Integer similarities full of ties: the port's top-k indices are
    jax.lax.top_k's (the lower index first among equals), in order."""
    rng = np.random.default_rng(0)
    sim = -rng.integers(0, 3, size=(64, 5, 20))   # three values in 20
    sim[0] = -4                                   # a row all tied
    for k in (1, 5, 20):
        want = np.asarray(jax.lax.top_k(jnp.asarray(sim), k)[1])
        got = sdim.topk_lower_index_first(torch.from_numpy(sim), k).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sdim.topk_lower_index_first(torch.from_numpy(sim[:1]), 5)[0, 0],
        np.arange(5))


def test_eta_forward_on_tied_history():
    """ETA over histories of a few repeated items, where every similarity
    ties with many others: the scores JAX's."""
    feed = small_feed(5)
    rng = np.random.default_rng(6)
    feed["history_item_id"] = rng.integers(1, 4, size=(4, 20))
    feed["lengths"] = np.full(4, 20)
    res = forward_pair("ETA", kw=dict(num_hashes=2), feed=feed)
    assert_forward(res, "ETA-ties")


@pytest.mark.parametrize("num_hashes,hash_bits", [(1, 4), (3, 6)])
def test_hash_codes_match_jax(num_hashes, hash_bits):
    """SDIM's and ETA's bucket ids on the same embeddings and rotations:
    equal to JAX's except where a projection lies within 1e-6 of 0, where
    fp32 rounding may pick either sign (counted)."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4096, 16)).astype(np.float32) * 0.05
    rot = rng.normal(size=(16, num_hashes, hash_bits)).astype(np.float32)
    proj = np.einsum("nh,hkb->nkb", x.astype(np.float64), rot)
    powers = 2 ** jnp.arange(hash_bits)
    want = np.asarray(((jnp.einsum("...h,hnb->...nb", jnp.asarray(x),
                                   jnp.asarray(rot)) > 0).astype(jnp.int32)
                       * powers).sum(-1))
    got = sdim.hash_codes(torch.from_numpy(x), torch.from_numpy(rot)).numpy()
    near = (np.abs(proj) < 1e-6).any(-1)
    differ = got != want
    print(f"{differ.sum()} of {got.size} codes differ, "
          f"{near.sum()} within 1e-6 of a sign change")
    assert not (differ & ~near).any()


def test_dien_padded_final_batch():
    """A final batch of 5 real rows padded to 8: the batch-axis softmax
    leaves the padded rows out, so the real rows' scores are JAX's, do not
    move with what the padded rows hold, and differ from the same rows in
    a batch where all 8 are real."""
    feed = small_feed(3, B=8)
    feed["row_mask"] = np.arange(8) < 5
    res = forward_pair("DIEN", feed=feed)
    assert_forward(res, "DIEN-padded")
    model, want = res["model"], res["eval", torch.float32][1]
    other = {k: v.copy() for k, v in feed.items()}
    for k in ("history_item_id", "item_id", "user_id", "lengths"):
        other[k][5:] = other[k][:3]
    full = dict(feed, row_mask=np.ones(8, bool))

    def scores(f):
        with torch.no_grad():
            return model({k: torch.from_numpy(v)
                          for k, v in f.items()})[0].numpy()
    np.testing.assert_array_equal(scores(other)[:5], want[:5])
    assert np.abs(scores(full)[:5] - want[:5]).max() > 1e-6


def test_adagin_samples_in_evaluation():
    """AdaGIN draws its Gumbel noise in evaluation too: the scores follow
    the generator (the same seed, the same scores), not a fixed path."""
    _, model = models("AdaGIN", cold_tau=1.0)
    layers.init_weights(model, torch.Generator().manual_seed(0))
    feed = {k: torch.from_numpy(v) for k, v in small_feed(2).items()}
    model.eval()

    def scores(seed):
        with torch.no_grad():
            return model(feed, generator=torch.Generator().manual_seed(
                seed))[0].numpy()
    np.testing.assert_array_equal(scores(1), scores(1))
    assert np.abs(scores(1) - scores(2)).max() > 0


# ---------------------------------------------------------------------------
# lock-step training

LOCKSTEP = {
    "AdaGIN": ("SegMM_CTR", "AdaGIN", ("--num_gnn_layers", "2")),
    "DIEN-alpha_aux": ("SegMM_CTR", "DIEN", ("--alpha_aux", "0.1")),
    "CAN": ("SegMM_CTR", "CAN", ()),
    "SDIM": ("SegMM_CTR", "SDIM", ("--history_max", "10")),
    "ETA": ("SegMM_CTR", "ETA", ("--history_max", "10")),
    "ClipDIENRec": ("SegMM_CTR", "ClipDIENRec", ()),
    "ClipAdaGINRec": ("SegMM_CTR", "ClipAdaGINRec", ("--num_gnn_layers",
                                                      "2")),
}


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_lockstep_matches_jax(data, case, monkeypatch):
    dataset, model, extra = LOCKSTEP[case]
    tap = GumbelTap(monkeypatch) if "AdaGIN" in model else None
    lockstep(data, (dataset, model), monkeypatch, extra, tap=tap)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("mode", ["CTR", "Ranking"])
@pytest.mark.parametrize("name,extra", [
    ("AdaGIN", ()), ("DIEN", ()), ("DIEN", ("--alpha_aux", "0.1")),
    ("CAN", ("--alpha_aux", "0.1")), ("SDIM", ()), ("ETA", ()),
    ("ClipDCNv2Rec", ()), ("ClipAutoIntRec", ()), ("ClipFinalMLPRec", ()),
    ("ClipAdaGINRec", ()), ("ClipDIENRec", ()), ("ClipCANRec", ())],
    ids=lambda v: "-".join(v) if isinstance(v, tuple) and v else
    (v or "defaults"))
def test_main_cpu_runs(data, name, extra, mode, tmp_path):
    """segrec.main --device cpu trains an epoch and evaluates each model in
    CTR and ranking mode (--alpha_aux > 0 draws the history negatives)."""
    run_main(data, name, mode, tmp_path, extra)
