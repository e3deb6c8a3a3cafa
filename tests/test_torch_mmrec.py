"""The port's MMRec graph recommenders (segmminterest_tpu_torch/mmrec/
graph.py, models.py, the runner's loss and train step; models/convert.py's
mmrec_state_dict) against the JAX package's on the CPU:

* bipartite_norm_edges and knn_item_graph (block-local, two block sizes)
  bit for bit; global_weighted_knn_graph's host copy bit for bit and its
  device version (chunked, on CPU tensors), knn_edges_device,
  masked_norm_values, weighted_laplacian_values (and its gradient),
  propagate and item_graph_propagate: JAX's edges, values within 1e-6, on
  tie-free features with a row whose cosines sum below zero;
* every model's embeddings from the JAX model's initial params put into
  the port's by mmrec_state_dict, within 1e-6 relative, over 64, 65 and
  1,025 feature columns (a position column with negative values and
  values past 1) and without features; LATTICE also with learned edges;
  the position column's index;
* the runner's loss (bpr_triplet_loss, FREEDOM's extra_loss also under an
  edge-dropout keep mask, bm3_loss and ssl_loss with JAX's dropout masks
  handed in) and its gradient within 1e-6 relative on a padded batch over
  a graph with isolated users and items;
* five lock-step Adam steps over two epochs of every model (FREEDOM also
  with --edge_dropout 0.1; BM3 and SLMRec with JAX's masks): the
  triplets, the keep masks and LATTICE's rebuilt edges from the same
  numpy generator, the losses within 3e-4, the trained models' scores of
  the items with a train edge (differences from one item's, as BPR sees
  them) within 3e-4 relative,
  every weight within Adam's bound.

JAX runs eagerly (one model a case); torch on one thread.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segmminterest_tpu.mmrec import graph as jgraph
from segmminterest_tpu.mmrec import models as jmodels
from segmminterest_tpu.mmrec import runner as jrunner
from segmminterest_tpu_torch.mmrec import graph, models, runner
from segmminterest_tpu_torch.models.convert import mmrec_state_dict
from test_torch_segrec import ADAM_BOUND, LOSS_RTOL, LR, STEPS, _rel
from test_torch_segrec_context import one_torch_thread  # noqa: F401

N_USERS, N_ITEMS, EMB, KNN = 12, 40, 8, 4
B = 48   # rows of a batch: 120 train pairs are three batches
RTOL = 1e-6
NAMES = list(jmodels.MMREC_REGISTRY)
FEATS = {"d64": 64, "d65": 65, "d1025": 1025, "none": None}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _t(x):
    return torch.from_numpy(np.array(x))


def _cosine_cluster(rng, n=30, d=8):
    """Tie-free features whose row 0 points away from all others: its top
    k cosines (itself and k-1 near -1) sum below zero."""
    x = -np.eye(d, dtype=np.float32)[0] + 0.3 * rng.normal(
        size=(n, d)).astype(np.float32)
    x[0] = np.eye(d, dtype=np.float32)[0]
    return x


@pytest.fixture(scope="module")
def g():
    """A graph with isolated nodes: user 0 and items 0 and 20..39 have no
    edge."""
    rng = np.random.default_rng(7)
    users = rng.integers(1, N_USERS, 120)
    items = rng.integers(1, N_ITEMS // 2, 120)
    eu, ei, ev = jgraph.bipartite_norm_edges(users, items, N_USERS, N_ITEMS)
    feats = {}
    for key, d in FEATS.items():
        if d is None:
            feats[key] = None
            continue
        v = rng.normal(size=(N_ITEMS, d)).astype(np.float32)
        if d % 8 == 1:
            v[:, -1] = rng.random(N_ITEMS) * 1.2 - 0.1
        feats[key] = v
    mm_feat = rng.normal(size=(N_ITEMS, 16)).astype(np.float32)
    return dict(users=users, items=items, edges=(eu, ei, ev), feats=feats,
                mm_feat=mm_feat)


def _kwargs(g, feat):
    eu, ei, ev = g["edges"]
    v = g["feats"][feat]
    fe = g["mm_feat"] if v is None else (v[:, :-1] if v.shape[1] % 8 == 1
                                         else v)
    mm_edges, mm_values = jgraph.knn_item_graph(fe, KNN)
    return dict(n_users=N_USERS, n_items=N_ITEMS, edge_u=eu, edge_i=ei,
                edge_values=ev, emb_size=EMB, v_feat=v, mm_edges=mm_edges,
                mm_values=mm_values)


def _flax_params(pm):
    """The port model ``pm``'s weights as a flax params tree: a Dense's
    weight is its kernel transposed (test_convert_maps_every_param holds
    the tree's names and shapes to the JAX model's init)."""
    tree = {}
    for k, v in pm.state_dict().items():
        v = v.detach().numpy().copy()
        if "." not in k:
            tree[k] = v
            continue
        mod, leaf = k.split(".")
        tree.setdefault(mod, {})["kernel" if leaf == "weight" else leaf] = \
            v.T.copy() if leaf == "weight" else v
    return tree


@pytest.fixture(scope="module")
def pair(g):
    """(JAX model, params, the port's model holding them) per (model,
    features), made once: the port's initial weights from a seed, its
    biases made nonzero."""
    cache = {}

    def make(name, feat="d65"):
        if (name, feat) not in cache:
            kw = _kwargs(g, feat)
            jm = jmodels.MMREC_REGISTRY[name](**kw)
            pm = models.MMREC_REGISTRY[name](**kw)
            gen = torch.Generator().manual_seed(len(cache))
            pm.reset_parameters(gen)
            with torch.no_grad():
                for k, p in pm.named_parameters():
                    if k.endswith("bias"):
                        p.normal_(0, 0.1, generator=gen)
            cache[name, feat] = (jm, _flax_params(pm), pm)
        return cache[name, feat]
    return make


@pytest.fixture(scope="module")
def jax_loss_grad(pair, g):
    """The JAX runner's loss and its gradient, jitted once per model (one
    compile per argument structure): shared by the loss and the lock-step
    cases."""
    cache = {}

    def get(name):
        if name not in cache:
            jm = pair(name)[0]
            jr = jrunner.MMRecRunner(jm, jrunner.MMRecConfig(batch_size=B),
                                     g["users"], g["items"], N_ITEMS)
            cache[name] = jax.jit(jax.value_and_grad(jr._loss))
        return cache[name]
    return get


# ---------------------------------------------------------------------------
# graph functions

def test_bipartite_norm_edges_bit_equal(g):
    want = jgraph.bipartite_norm_edges(g["users"], g["items"], N_USERS,
                                       N_ITEMS)
    got = graph.bipartite_norm_edges(g["users"], g["items"], N_USERS,
                                     N_ITEMS)
    for w, x in zip(want, got):
        assert x.dtype == w.dtype
        np.testing.assert_array_equal(x, w)


@pytest.mark.parametrize("batch", [1024, 16])
def test_knn_item_graph_bit_equal(g, batch):
    want = jgraph.knn_item_graph(g["mm_feat"], KNN, batch=batch)
    got = graph.knn_item_graph(g["mm_feat"], KNN, batch=batch)
    for w, x in zip(want, got):
        assert x.dtype == w.dtype
        np.testing.assert_array_equal(x, w)
    if batch == 16:  # neighbors never cross a block
        e = got[0]
        assert (e[:, 0] // 16 == e[:, 1] // 16).all()


def _same_rows(got_edges, want_edges, k):
    """The same rows, and per row the same neighbor set."""
    got, want = np.asarray(got_edges), np.asarray(want_edges)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_array_equal(np.sort(got[:, 1].reshape(-1, k), 1),
                                  np.sort(want[:, 1].reshape(-1, k), 1))


@pytest.mark.parametrize("where", ["host", "device"])
def test_global_weighted_knn_graph(where):
    x = _cosine_cluster(np.random.default_rng(3))
    w_edges, w_vals = jgraph.global_weighted_knn_graph(x, KNN, chunk=8)
    assert not w_vals[:KNN].any()   # row 0's cosines sum below zero
    assert (w_vals[KNN:] != 0).any()
    if where == "host":
        edges, vals = graph.global_weighted_knn_graph(x, KNN, chunk=8)
        np.testing.assert_array_equal(edges, w_edges)
        np.testing.assert_array_equal(vals, w_vals)
        return
    edges, vals = graph.global_weighted_knn_graph_device(_t(x), KNN,
                                                         chunk=8)
    np.testing.assert_array_equal(edges.numpy(), w_edges)  # sorted, tie-free
    assert vals.dtype == torch.float32
    np.testing.assert_allclose(vals.numpy(), w_vals, rtol=0, atol=RTOL)


def test_knn_edges_device(g):
    x = g["mm_feat"]
    want = jgraph.knn_edges_device(jnp.asarray(x), KNN, chunk=16)
    got = graph.knn_edges_device(_t(x), KNN, chunk=16)
    assert got.shape == (N_ITEMS * KNN, 2)
    _same_rows(got, want, KNN)


def test_masked_norm_values(g):
    eu, ei, _ = g["edges"]
    keep = np.random.default_rng(1).random(len(eu)) < 0.7
    want = jgraph.masked_norm_values(jnp.asarray(eu), jnp.asarray(ei),
                                     jnp.asarray(keep), N_USERS, N_ITEMS)
    got = graph.masked_norm_values(_t(eu).long(), _t(ei).long(), _t(keep),
                                   N_USERS, N_ITEMS)
    assert (got.numpy() == 0).tolist() == (~keep).tolist()
    assert _rel(got.numpy(), want) <= RTOL


def test_weighted_laplacian_values_and_gradient():
    x = _cosine_cluster(np.random.default_rng(4))
    edges = graph.global_weighted_knn_graph(x, KNN)[0]
    w = np.random.default_rng(5).normal(size=len(edges))

    @jax.jit
    def jf(p):
        v = jgraph.weighted_laplacian_values(jnp.asarray(edges), p, len(x))
        return (v * w).sum(), v
    (_, want), want_g = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    p = _t(x).requires_grad_()
    got = graph.weighted_laplacian_values(_t(edges).long(), p, len(x))
    (got * _t(w).float()).sum().backward()
    assert not np.asarray(want)[:KNN].any() and not got[:KNN].any()
    assert _rel(got.detach().numpy(), want) <= RTOL
    assert _rel(p.grad.numpy(), want_g) <= RTOL


def test_propagations(g):
    eu, ei, ev = g["edges"]
    rng = np.random.default_rng(2)
    u = rng.normal(size=(N_USERS, EMB)).astype(np.float32)
    i = rng.normal(size=(N_ITEMS, EMB)).astype(np.float32)
    want = jgraph.propagate(u, i, eu, ei, ev)
    got = graph.propagate(_t(u), _t(i), _t(eu).long(), _t(ei).long(), _t(ev))
    for w, x in zip(want, got):
        assert _rel(x.numpy(), w) <= RTOL
    assert not got[0][0].any() and not got[1][N_ITEMS // 2:].any()
    edges, vals = jgraph.knn_item_graph(g["mm_feat"], KNN)
    want = jgraph.item_graph_propagate(i, edges, vals)
    got = graph.item_graph_propagate(_t(i), _t(edges).long(), _t(vals))
    assert _rel(got.numpy(), want) <= RTOL


# ---------------------------------------------------------------------------
# forwards

@pytest.mark.parametrize("feat", list(FEATS))
@pytest.mark.parametrize("name", NAMES)
def test_embeddings_match_jax(pair, name, feat):
    jm, params, pm = pair(name, feat)
    ju, ji = jm.apply({"params": params}, method="embeddings")
    with torch.no_grad():
        pu, pi = pm.embeddings()
    assert _rel(pu.detach().numpy(), ju) <= RTOL, name
    assert _rel(pi.detach().numpy(), ji) <= RTOL, name


def test_lattice_learned_edges_match_jax(pair):
    jm, params, pm = pair("LATTICE", "d64")
    proj = jm.apply({"params": params}, method="projected_features")
    learned = np.asarray(jgraph.knn_edges_device(proj, KNN))
    ju, ji = jm.apply({"params": params}, None, jnp.asarray(learned),
                      method="embeddings")
    with torch.no_grad():
        _same_rows(graph.knn_edges_device(pm.projected_features(), KNN),
                   learned, KNN)
        pu, pi = pm.embeddings(None, _t(learned).long())
    assert _rel(pu.detach().numpy(), ju) <= RTOL
    assert _rel(pi.detach().numpy(), ji) <= RTOL


@pytest.mark.parametrize("feat", ["d64", "d65", "d1025"])
def test_position_column(g, pair, feat):
    _, params, pm = pair("FREEDOM", feat)
    v = g["feats"][feat]
    assert pm.has_pos_column == (v.shape[1] % 8 == 1)
    assert ("new_pos_embedding" in params) == pm.has_pos_column
    if pm.has_pos_column:
        want = np.clip((v[:, -1] * np.float32(40)).astype(np.int32), 0, 39)
        assert v[:, -1].min() < 0 and v[:, -1].max() > 1
        np.testing.assert_array_equal(pm.pos_index.numpy(), want)
        assert pm.modal_feat.shape == (N_ITEMS, v.shape[1] - 1)


@pytest.mark.parametrize("feat", ["d65", "none"])
@pytest.mark.parametrize("name", NAMES)
def test_convert_maps_every_param(pair, name, feat):
    """The JAX model's params tree (names and shapes from ``jax.eval_shape``
    of its init) is the one these tests build, and mmrec_state_dict puts it
    (the Denses' kernels transposed) on exactly the port model's
    state_dict: the parameters, none of the graph buffers."""
    jm, params, pm = pair(name, feat)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        method="init_all"))["params"]
    assert jax.tree.structure(shapes) == jax.tree.structure(params)
    assert all(a.shape == b.shape for a, b in zip(
        jax.tree.leaves(shapes), jax.tree.leaves(params)))
    sd = mmrec_state_dict(pm, params)
    assert set(sd) == set(pm.state_dict())
    assert set(sd) == {k for k, _ in pm.named_parameters()}
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy())
    if name == "MMGCN" and feat == "d65":
        assert {"modal_layer_u_1", "modal_layer_i_1"} <= set(params)


# ---------------------------------------------------------------------------
# losses and gradients

def _batch(rng, real=40):
    """A padded triplet batch of B rows (its padded rows index row 0)
    touching isolated users and items."""
    u = rng.integers(0, N_USERS, B)
    pos = rng.integers(0, N_ITEMS, B)
    neg = rng.integers(1, N_ITEMS, B)
    u[:2], pos[:2] = 0, (0, N_ITEMS - 1)
    rm = np.ones(B, np.float32)
    rm[real:] = 0
    u[real:], pos[real:], neg[real:] = u[0], pos[0], neg[0]
    return u, pos, neg, rm


def jax_masks(jm, params, key, name):
    """The dropout masks the JAX loss method draws from ``key``: flax's
    key for its first make_rng("dropout"), split as the method splits it."""
    k = jm.apply({"params": params}, rngs={"dropout": key},
                 method=lambda m: m.make_rng("dropout"))
    if name == "BM3":
        k1, k2, k3 = jax.random.split(k, 3)
        keep = 1 - jm.dropout
        return [np.asarray(jax.random.bernoulli(kk, keep, s)) for kk, s in
                ((k1, (N_USERS, EMB)), (k2, (N_ITEMS, EMB)),
                 (k3, (N_ITEMS, EMB)))]
    k1, k2 = jax.random.split(k)
    return [np.asarray(jax.random.bernoulli(kk, 1 - 0.1, (B, EMB)))
            for kk in (k1, k2)]


def _masks(jm, params, key, name):
    if name not in ("BM3", "SLMRec"):
        return None
    return [_t(m) for m in jax_masks(jm, params, key, name)]


# LATTICE's loss with its learned edges (the runner's route: its
# fallback onto the frozen structure is a forward case above)
LOSS_CASES = [n for n in NAMES if n != "LATTICE"] + [
    "FREEDOM-keep", "LATTICE-learned"]


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_and_gradient_match_jax(g, pair, jax_loss_grad, case):
    name = case.split("-")[0]
    jm, params, pm = pair(name, "d65")
    u, pos, neg, rm = _batch(np.random.default_rng(11))
    eu, ei, _ = g["edges"]
    keep = learned = None
    if case == "FREEDOM-keep":
        keep = np.random.default_rng(12).random(len(eu)) < 0.8
        keep = jgraph.masked_norm_values(jnp.asarray(eu), jnp.asarray(ei),
                                         jnp.asarray(keep), N_USERS, N_ITEMS)
    if case == "LATTICE-learned":
        learned = jgraph.knn_edges_device(
            jm.apply({"params": params}, method="projected_features"), KNN)
    key = jax.random.PRNGKey(5)
    jloss, jgrads = jax_loss_grad(name)(
        params, *map(jnp.asarray, (u, pos, neg, rm)), keep, key, learned)
    pr = runner.MMRecRunner(pm, runner.MMRecConfig(batch_size=B),
                            g["users"], g["items"], N_ITEMS, device="cpu")
    pm.zero_grad(set_to_none=True)
    loss = pr._loss(*map(_t, (u, pos, neg, rm)),
                    None if keep is None else _t(keep).float(),
                    None if learned is None else _t(learned).long(),
                    _masks(jm, params, key, name))
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= RTOL * abs(float(jloss))
    want = mmrec_state_dict(pm, jax.tree.map(np.asarray, jgrads))
    names = [k for k, _ in pm.named_parameters()]
    got = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    assert all(np.isfinite(v).all() for v in got.values())
    # the gradient as one vector, relative to its largest entry (a Dense
    # bias whose terms cancel in pos - neg holds rounding alone)
    flat = [np.concatenate([d[k].ravel() for k in names])
            for d in (got, {k: v.numpy() for k, v in want.items()})]
    assert _rel(*flat) <= RTOL


# ---------------------------------------------------------------------------
# lock-step training

LOCKSTEP = NAMES + ["FREEDOM-edge_dropout"]


def _jax_epoch(jr):
    """The JAX fit_epoch's draws (runner.py:193-207), before its steps."""
    n = len(jr.train_users)
    order = jr.rng.permutation(n)
    neg = jr.rng.integers(1, jr.n_items, size=n)
    keep = jr._epoch_keep_values()
    bs = jr.cfg.batch_size
    out = []
    for start in range(0, n, bs):
        idx = order[start:start + bs]
        pad = bs - len(idx)
        rm = np.ones(bs, np.float32)
        if pad:
            rm[len(idx):] = 0.0
            idx = np.concatenate([idx, np.zeros(pad, np.int64)])
        out.append((jr.train_users[idx], jr.train_items[idx], neg[idx], rm))
    return keep, out


@pytest.mark.parametrize("case", LOCKSTEP)
def test_lockstep_matches_jax(g, pair, jax_loss_grad, case):
    name = case.split("-")[0]
    jm, params, pm = pair(name, "d65")
    pm = copy.deepcopy(pm)
    kw = dict(batch_size=B, learning_rate=LR, seed=3,
              edge_dropout=0.1 if "edge_dropout" in case else 0.0)
    jr = jrunner.MMRecRunner(jm, jrunner.MMRecConfig(**kw), g["users"],
                             g["items"], N_ITEMS)
    pr = runner.MMRecRunner(pm, runner.MMRecConfig(**kw), g["users"],
                            g["items"], N_ITEMS, device="cpu")
    pr.init_state()
    pm.load_state_dict(mmrec_state_dict(pm, params))
    jparams, opt_state = params, jr.optimizer.init(params)
    rng_key = jax.random.PRNGKey(3)
    jl, pl = [], []
    while len(jl) < STEPS:   # three batches an epoch: two epochs
        jkeep, jbatches = _jax_epoch(jr)
        keep, arrays = pr.epoch_batches()
        if jkeep is None:
            assert keep is None
        else:
            np.testing.assert_array_equal(keep.numpy() > 0,
                                          np.asarray(jkeep) > 0)
            assert _rel(keep.numpy(), jkeep) <= RTOL
        jlearned = learned = None
        if name == "LATTICE":   # the JAX runner's _rebuild_edges, eagerly
            jlearned = jgraph.knn_edges_device(jm.apply(
                {"params": jparams}, method="projected_features"), KNN)
            learned = pr._rebuild_edges()
            _same_rows(learned, jlearned, KNN)
        for b, jb in enumerate(jbatches):
            batch = [a[b * B:(b + 1) * B] for a in arrays]
            for x, w in zip(batch, jb):
                np.testing.assert_array_equal(x, w)
            rng_key, k = jax.random.split(rng_key)
            # the JAX runner's _train_step
            loss, grads = jax_loss_grad(name)(
                jparams, *map(jnp.asarray, jb), jkeep, k, jlearned)
            updates, opt_state = jr.optimizer.update(grads, opt_state,
                                                     jparams)
            jparams = optax.apply_updates(jparams, updates)
            jl.append(float(loss))
            pl.append(float(pr.train_step(*map(_t, batch), keep, learned,
                                          _masks(jm, params, k, name))))
            if len(jl) == STEPS:
                break
    assert len(set(jl)) == STEPS, jl
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    want = mmrec_state_dict(pm, jax.tree.map(np.asarray, jparams))
    for k, v in pm.state_dict().items():
        assert np.abs(v.numpy() - want[k].numpy()).max() <= ADAM_BOUND, k
    # the trained models' scores as BPR sees them, differences from an
    # item's: a bias every item shares drifts as its rounding picks. Items
    # with a train edge only: MMGCN's isolated items sit on leaky_relu's
    # kink (their pre-activation is that bias alone), where the slope is
    # the rounding's pick too
    ju, ji = jm.apply({"params": jparams}, method="embeddings")
    with torch.no_grad():
        pu, pi = pm.embeddings()
    linked = np.unique(g["items"])
    want = np.asarray(ju) @ np.asarray(ji)[linked].T
    got = (pu @ pi[linked].T).detach().numpy()
    assert _rel(got - got[:, :1], want - want[:, :1]) <= LOSS_RTOL
