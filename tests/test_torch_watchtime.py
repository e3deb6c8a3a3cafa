"""The watch-time task of the port against the JAX package's, on the CPU:

* D2QModel and TreeModel forwards with the flax params transplanted
  (``models/convert.py``), within 1e-6;
* the TPM tree functions on seeded inputs, within 1e-6 (labels exact);
* five lock-step optimizer steps on the same batches: WLR and D2Q on
  ``optax.adagrad`` against the port's :class:`Adagrad`, TPM (dropout off)
  on ``optax.adam`` against ``torch.optim.Adam``: the losses within 3e-4
  relative (tests/test_torch_train.py's bar), every parameter within 3e-4;
* the CLI's four methods end to end with ``--device cpu`` on a synthetic
  CSV: finite results under the JAX CLI's keys.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segmminterest_tpu.engine import evaluation as j_eval
from segmminterest_tpu.models import watchtime as JW
from segmminterest_tpu.tasks import watchtime as j_task
from segmminterest_tpu_torch.data.dataset import BatchIterator
from segmminterest_tpu_torch.data.reader import SeqReader
from segmminterest_tpu_torch.data.synthetic import write_synthetic_csv
from segmminterest_tpu_torch.models import watchtime as TW
from segmminterest_tpu_torch.models.convert import (flax_to_state_dict,
                                                    load_flax_params)
from segmminterest_tpu_torch.tasks import watchtime as t_task

FWD_ATOL = 1e-6
LOSS_RTOL, PARAM_ATOL = 3e-4, 3e-4
BUCKNUM = 32
SPLIT = ["--min_interactions", "30", "--num_warmup", "10"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("watchtime")
    csv = write_synthetic_csv(str(d / "inter.csv"), n_users=10,
                              per_user=(35, 60), n_videos=200, seed=4)
    reader = SeqReader.from_single_csv(csv, min_interactions=30,
                                       num_warmup=10)
    return dict(dir=d, csv=csv, reader=reader)


def _ids(rng, B, reader):
    return (rng.integers(0, reader.n_users + 1, B),
            rng.integers(0, reader.n_items + 1, B),
            rng.integers(0, 200, B))


def _torch(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def test_d2q_forward_matches_flax(data, rng):
    reader = data["reader"]
    uid, iid, dur = _ids(rng, 48, reader)
    jm = JW.D2QModel(max_item=reader.n_items, max_user=reader.n_users)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1), uid, iid, dur)["params"])
    want = np.asarray(jm.apply({"params": params}, uid, iid, dur))
    tm = TW.D2QModel(max_item=reader.n_items, max_user=reader.n_users)
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(*_torch(uid, iid, dur)).numpy()
    assert got.shape == want.shape == (48, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


def test_tree_forward_matches_flax(data, rng):
    reader = data["reader"]
    uid, iid, dur = _ids(rng, 48, reader)
    jm = JW.TreeModel(max_item=reader.n_items, max_user=reader.n_users,
                      class_num=BUCKNUM - 1)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(2), uid, iid, dur, deterministic=True)["params"])
    want = np.asarray(jm.apply({"params": params}, uid, iid, dur,
                               deterministic=True))
    tm = TW.TreeModel(max_item=reader.n_items, max_user=reader.n_users,
                      class_num=BUCKNUM - 1)
    assert set(flax_to_state_dict(params, tm)) == set(tm.state_dict())
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(*_torch(uid, iid, dur)).numpy()
    assert got.shape == want.shape == (48, BUCKNUM - 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


def test_tree_dropout_draws_from_the_generator(data, rng):
    reader = data["reader"]
    ids = _torch(*_ids(rng, 16, reader))
    tm = TW.TreeModel(max_item=reader.n_items, max_user=reader.n_users,
                      class_num=BUCKNUM - 1)
    a = tm(*ids, generator=torch.Generator().manual_seed(3))
    b = tm(*ids, generator=torch.Generator().manual_seed(3))
    c = tm(*ids, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, tm(*ids))


@pytest.mark.parametrize("method", ["d2q", "tpm"])
def test_init_scales_match_flax(data, method):
    """Each leaf of the port's fresh model has the spread of flax's init
    (embeddings std emb_size ** -0.5, LeCun-normal kernels, zero biases):
    the std pooled over eight seeds within 10%."""
    reader = data["reader"]
    ids = [np.zeros((2,), np.int32)] * 3
    if method == "d2q":
        jm = JW.D2QModel(max_item=reader.n_items, max_user=reader.n_users)
        kw = {}
    else:
        jm = JW.TreeModel(max_item=reader.n_items, max_user=reader.n_users,
                          class_num=BUCKNUM - 1)
        kw = {"deterministic": True}
    make = (lambda: TW.D2QModel(reader.n_items, reader.n_users)) \
        if method == "d2q" else \
        (lambda: TW.TreeModel(reader.n_items, reader.n_users, BUCKNUM - 1))
    want, got = {}, {}
    for seed in range(8):
        params = jm.init(jax.random.PRNGKey(seed), *ids, **kw)["params"]
        for k, v in flax_to_state_dict(
                jax.tree.map(np.asarray, params), make()).items():
            want.setdefault(k, []).append(v.numpy().ravel())
        torch.manual_seed(seed)
        for k, v in make().state_dict().items():
            got.setdefault(k, []).append(v.numpy().ravel())
    assert set(got) == set(want)
    for k in want:
        w, g = np.concatenate(want[k]), np.concatenate(got[k])
        if k.endswith("bias"):
            assert not w.any() and not g.any(), k
        else:
            assert abs(g.std() / w.std() - 1) <= 0.1, (k, g.std(), w.std())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tpm_functions_match_jax(rng, dtype):
    """The tree's labels and weights exactly; the encoding loss and the
    expected playtime within 1e-6 (relative past 1); the variance and the
    total loss at fp64 only: the variance is the square root of the
    difference of two sums near E[x]^2 ~ 1e3 that cancel (the reference's
    quirk), which leaves fp32 rounding noise of ~0.1 in it on either side."""
    B = 24
    play_ms = rng.integers(0, 300_000, 500).astype(np.float64)
    jb, je = JW.playtime_percentiles(play_ms, BUCKNUM)
    tb, te = TW.playtime_percentiles(play_ms, BUCKNUM)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(te, je)
    probs = rng.uniform(0.01, 0.99, (B, BUCKNUM - 1)).astype(dtype)
    target = (np.minimum(rng.uniform(0, 50, B) / 40.0, 1.0)
              * 40.0).astype(dtype)
    rm = (rng.random(B) < 0.8).astype(dtype)
    jb, je = jb.astype(dtype), je.astype(dtype)
    jargs = [jnp.asarray(x) for x in (probs, target, jb, je, rm)]
    targs = _torch(probs, target, jb, je, rm)

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=FWD_ATOL, atol=FWD_ATOL)

    jl, jw = JW.tpm_label_encoding(BUCKNUM, jargs[1], jargs[2], jargs[3])
    tl, tw = TW.tpm_label_encoding(BUCKNUM, targs[1], targs[2], targs[3])
    assert list(tl) == list(jl) and len(tl) == BUCKNUM - 1
    for k in jl:
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]))
    close(TW.tpm_label_encoding_loss(tl, tw, targs[0], BUCKNUM, targs[4]),
          JW.tpm_label_encoding_loss(jl, jw, jargs[0], BUCKNUM, jargs[4]))
    jx, jv = JW.tpm_encoded_playtime(jargs[0], BUCKNUM, jargs[2], jargs[3])
    tx, tv = TW.tpm_encoded_playtime(targs[0], BUCKNUM, targs[2], targs[3])
    assert tx.dtype == torch.from_numpy(probs).dtype
    close(tx, jx)
    if dtype == np.float64:
        close(tv, jv)
        jloss, _ = JW.tpm_loss(*jargs[:4], BUCKNUM, 0.2, 0.1, jargs[4])
        tloss, _ = TW.tpm_loss(*targs[:4], BUCKNUM, 0.2, 0.1, targs[4])
        close(tloss, jloss)


# --- five lock-step optimizer steps ----------------------------------------

class _Args:
    wr_bucknum, mse_weight, var_weight = BUCKNUM, 0.2, 0.1


def _batches(reader, n=5, B=64):
    it = BatchIterator(reader, reader.tables["train"], B, shuffle=True,
                       seed=5, prefetch_size=0)
    return [b for _, b in zip(range(n), it)]


def _jax_fwd_inputs(b):
    return (jnp.asarray(b["user_identity_id"]),
            jnp.asarray(b["photo_identity_id"]),
            jnp.clip(jnp.asarray(b["duration"]), 0, 199))


def _jax_loss(method, model, q_threshold, begins, ends):
    """The JAX task's loss_fn of each method (watchtime.py:72-81,
    :158-165), dropout off."""
    def loss_fn(params, b):
        rm = jnp.asarray(b["row_mask"]).astype(jnp.float32)
        play = jnp.asarray(b["play_time"]).astype(jnp.float32)
        if method == "tpm":
            probs = model.apply({"params": params}, *_jax_fwd_inputs(b),
                                deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(0)})
            target = jnp.minimum(play / 40.0, 1.0) * 40.0
            return JW.tpm_loss(probs, target, begins, ends, BUCKNUM, 0.2,
                               0.1, rm)[0]
        out = model.apply({"params": params}, *_jax_fwd_inputs(b))[:, 0]
        if method == "wlr":
            return j_task._bce(out, (play > q_threshold).astype(jnp.float32),
                               rm)
        return j_task._mse(out, jnp.minimum(play / 40.0, 1.0), rm)
    return loss_fn


def _tree_models(reader, jax_dtype=jnp.float32):
    return (JW.TreeModel(max_item=reader.n_items, max_user=reader.n_users,
                         class_num=BUCKNUM - 1, dropout=0.0,
                         dtype=jax_dtype),
            TW.TreeModel(max_item=reader.n_items, max_user=reader.n_users,
                         class_num=BUCKNUM - 1, dropout=0.0))


@pytest.mark.parametrize("method", ["wlr", "d2q", "tpm"])
def test_lockstep_steps_match_jax(data, method):
    """WLR and D2Q at fp32. TPM at fp64 on both sides: Adam's first steps
    move a weight by about lr whatever its gradient's size, so a gradient
    that fp32 rounding leaves near zero with either sign moves it by lr
    one way or the other (at fp32: 77 of 6,400 duration-embedding weights
    0.0156 apart after five steps, where the gradients agree within 1.1e-5
    (test_tpm_fp32_gradients_match_jax))."""
    reader = data["reader"]
    batches = _batches(reader)
    lr = 1e-2
    q_threshold = float(np.quantile(
        reader.tables["train"].playing_time / 5000.0, 0.6))
    begins, ends = TW.playtime_percentiles(
        reader.tables["train"].playing_time, BUCKNUM)
    if method == "tpm":
        jm, tm = _tree_models(reader, jnp.float64)
        tm.double()
        tx = optax.adam(lr)
        opt = torch.optim.Adam(tm.parameters(), lr=lr)
        params = jax.tree.map(lambda x: x.astype(jnp.float64), jm.init(
            jax.random.PRNGKey(3), *_jax_fwd_inputs(batches[0]),
            deterministic=True)["params"])
        begins, ends = begins.astype(np.float64), ends.astype(np.float64)
        tb, te = _torch(begins, ends)
        gen = torch.Generator().manual_seed(0)

        def t_loss(m, b):
            return t_task.tpm_batch_loss(m, b, tb, te, _Args, gen)
    else:
        jm = JW.D2QModel(max_item=reader.n_items, max_user=reader.n_users)
        tm = TW.D2QModel(max_item=reader.n_items, max_user=reader.n_users)
        tx = optax.adagrad(lr)
        opt = t_task.Adagrad(tm.parameters(), lr)
        params = jm.init(jax.random.PRNGKey(3),
                         *_jax_fwd_inputs(batches[0]))["params"]

        def t_loss(m, b):
            return t_task.wlr_d2q_loss(m, b, method, q_threshold)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    loss_fn = jax.jit(jax.value_and_grad(_jax_loss(
        method, jm, q_threshold, jnp.asarray(begins), jnp.asarray(ends))))
    opt_state = tx.init(params)
    for b in batches:
        jloss, grads = loss_fn(params, b)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tloss = t_task.train_step(tm, opt, t_loss,
                                  t_task.to_device(b, torch.device("cpu")))
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=LOSS_RTOL)
    want = flax_to_state_dict(jax.tree.map(np.asarray, params), tm)
    got = tm.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    moved = max(float((got[k] - start[k]).abs().max()) for k in got)
    assert moved > 10 * PARAM_ATOL  # the steps moved the weights


def test_tpm_fp32_gradients_match_jax(data):
    """TPM's loss and gradients at fp32 on one batch, dropout off: within
    3e-5 of JAX's (the loss relative)."""
    reader = data["reader"]
    b = _batches(reader, n=1)[0]
    begins, ends = TW.playtime_percentiles(
        reader.tables["train"].playing_time, BUCKNUM)
    jm, tm = _tree_models(reader)
    params = jm.init(jax.random.PRNGKey(3), *_jax_fwd_inputs(b),
                     deterministic=True)["params"]
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_loss(
        "tpm", jm, 0.0, jnp.asarray(begins), jnp.asarray(ends))))(params, b)
    tloss = t_task.tpm_batch_loss(tm, t_task.to_device(b, "cpu"),
                                  *_torch(begins, ends), _Args,
                                  torch.Generator())
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=3e-5)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jgrads), tm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), rtol=0,
                                   atol=3e-5, err_msg=n)


def test_adagrad_is_optax():
    """The optax formula on hand-made gradients, zero sums included."""
    w = torch.tensor([1.0, -2.0, 0.5, 3.0])
    grads = [torch.tensor([0.1, 0.0, -3.0, 0.0]),
             torch.tensor([0.2, 0.0, 1.0, -0.5])]
    p = torch.nn.Parameter(w.clone())
    opt = t_task.Adagrad([p], 0.3, initial_accumulator_value=0.0)
    tx = optax.adagrad(0.3, initial_accumulator_value=0.0)
    jp = jnp.asarray(w.numpy())
    state = tx.init(jp)
    for g in grads:
        p.grad = g.clone()
        opt.step()
        u, state = tx.update(jnp.asarray(g.numpy()), state, jp)
        jp = optax.apply_updates(jp, u)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0,
                               atol=1e-7)


# --- the CLI ---------------------------------------------------------------

# the keys of the JAX CLI's results (watchtime.py:144, :220)
JAX_KEYS = {"wlr": {"HR1", "MAE", "threshold"},
            "d2q": {"HR1", "MAE", "threshold"}, "tpm": {"HR1", "MAE"}}


def _ours_keys():
    """The test-metric keys of the JAX harness's watch-time evaluation
    (run_training's test loop with watchtime_metrics) on one batch."""
    rng = np.random.default_rng(0)
    rl = j_eval.make_results_list(t_task.OURS_EVAL_TYPES.split(","))
    for k in ("duration_lengths", "TOP1MSE", "MAES", "pred_leave"):
        rl[k] = []
    gt = np.full((8, 40), -2)
    for i in range(8):
        gt[i, :10] = -1
        gt[i, :i + 1] = 1
        gt[i, i + 1] = 0
    j_eval.main_eval_batch(rng.uniform(0.1, 0.9, (8, 40)), gt, rl,
                           logits=rng.normal(size=(8, 40)), rng=rng)
    return set(j_eval.compute_final_result_watchtime(rl, 8))


def _finite(x):
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return bool(np.isfinite(x))


@pytest.mark.parametrize("method", ["wlr", "d2q", "tpm", "ours"])
def test_cli_end_to_end(data, method):
    args = ["--sample_csv", data["csv"], "--method", method, "--epochs",
            "1", "--debug", "1", "--batch_size", "64", "--valid_step", "2",
            "--early_stop", "0", "--ckpt_dir", str(data["dir"] / method)] \
        + SPLIT
    extra = ["--d_model", "32", "--nhead", "4", "--num_layers_enc", "2",
             "--user_input_type", "id", "--photo_input_type", "id"]
    got = t_task.main(args + extra + ["--device", "cpu"])
    got = json.loads(json.dumps(got))
    assert _finite(got), got
    assert set(got) == (_ours_keys() if method == "ours"
                        else JAX_KEYS[method])
    if method == "wlr":  # the JAX CLI on the same CSV
        assert got["threshold"] == j_task.main(args)["threshold"]


def test_cli_needs_a_card_unless_told_cpu(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_task.main(["--sample_csv", data["csv"], "--method", "wlr",
                     "--debug", "1"] + SPLIT)
