"""The port's MMRec data, evaluator, runner and CLI (segmminterest_tpu_torch/
mmrec/main.py, runner.py) and its seed sweeps (tasks/exp.py) on the CPU:

* build_mmrec_data key for key against the JAX function (pandas) over a
  synthetic CSV, with integer columns and with a float playing_time (the
  rows iterrows widens);
* interest_topk, mask and non-mask, on interests with ties, from the same
  generator: JAX's figures bit for bit;
* evaluate and export_logits of the same embeddings: the JAX runner's
  figures bit for bit, its export key for key and value for value;
* train on scripted metrics: JAX's best epoch and results, and a best
  state that later epochs leave as it was;
* mmrec.main --device cpu for two epochs over every model, FREEDOM with
  --edge_dropout 0.1, --test_cold 1 with --save_logits (one 40-wide row a
  key), --grid over lr and over batch_size=100,128; --use_mesh over
  several cards raises;
* tasks.exp --seeds 0,1 over mmrec and over segrec (FM, CTR): each
  seed's row that entry's own result, the mean row their mean.

Data: data/synthetic.py's CSV (12 users, --min_interactions 30
--num_warmup 10: 5,310 frames, 4,704 train pairs); torch on one thread.
"""

import csv
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.mmrec import main as jmain
from segmminterest_tpu.mmrec import models as jmodels
from segmminterest_tpu.mmrec import runner as jrunner
from segmminterest_tpu_torch.data.synthetic import write_synthetic_csv
from segmminterest_tpu_torch.mmrec import main, models, runner
from segmminterest_tpu_torch.tasks import build_segrec_data, exp
from test_torch_segrec_context import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = list(jmodels.MMREC_REGISTRY)
SMALL = ("--min_interactions", "30", "--num_warmup", "10")
TINY = ("--emb_size", "8", "--feat_dim", "16", "--knn_k", "4",
        "--batch_size", "1024")


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """The synthetic CSV as written, and again with a float playing_time."""
    d = tmp_path_factory.mktemp("mmrec")
    ints = write_synthetic_csv(str(d / "inter.csv"), n_users=12,
                               per_user=(40, 60), n_videos=300, seed=0)
    with open(ints) as f:
        rows = list(csv.reader(f))
    for r in rows[1::3]:
        r[4] = f"{r[4]}.5" if r[4] != "playing_time" else r[4]
    floats = str(d / "inter_float.csv")
    with open(floats, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return {"ints": ints, "floats": floats}


@pytest.fixture(scope="module")
def data(csvs):
    return main.build_mmrec_data(csvs["ints"], ",", 30, 10, 2024)


def _argv(csv_path, name, *extra):
    return ["--model", name, "--inter_csv", csv_path, *SMALL, *TINY,
            "--epochs", "2", "--device", "cpu", *extra]


def _finite(res):
    assert res and all(np.isfinite(v) for v in res.values()), res
    assert 0 <= res["hr@1"] <= res["hr@5"] <= res["hr@10"] <= 1


# ---------------------------------------------------------------------------
# data and evaluator

@pytest.mark.parametrize("kind", ["ints", "floats"])
def test_build_mmrec_data_matches_jax(csvs, kind):
    want = jmain.build_mmrec_data(csvs[kind], ",", 30, 10, 2024)
    got = main.build_mmrec_data(csvs[kind], ",", 30, 10, 2024)
    assert list(got) == list(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w)
        else:
            assert got[k] == w, k
    assert got["n_items"] > 5000 and len(got["train_u"]) > 4000


@pytest.mark.parametrize("mask", [True, False])
def test_interest_topk_matches_jax(mask):
    """Interests with ties (rounded to a tenth, padding zeros) and
    completed views; the same generator: the same figures, bit for bit."""
    rng = np.random.default_rng(9)
    bsz, seq_len = 80, 40
    interests = np.round(rng.random((bsz, seq_len)), 1)
    durations = rng.integers(2, seq_len + 1, size=bsz)
    interests[np.arange(seq_len)[None, :] >= durations[:, None]] = 0.0
    view_lengths = np.array([rng.integers(0, d) for d in durations])
    view_lengths[:7] = durations[:7]
    view_lengths[7:9] = seq_len
    want = jrunner.interest_topk(interests, view_lengths, durations, mask,
                                 rng=np.random.default_rng(3))
    got = runner.interest_topk(interests, view_lengths, durations, mask,
                               rng=np.random.default_rng(3))
    assert got == want


def _runners(data):
    """The JAX and the port's runner of a BPR model over ``data``."""
    from segmminterest_tpu_torch.mmrec.graph import bipartite_norm_edges
    eu, ei, ev = bipartite_norm_edges(data["train_u"], data["train_i"],
                                      data["n_users"], data["n_items"])
    kw = dict(n_users=data["n_users"], n_items=data["n_items"], edge_u=eu,
              edge_i=ei, edge_values=ev, emb_size=8)
    cfg = dict(epochs=6, stopping_step=3, batch_size=1024, seed=4)
    jr = jrunner.MMRecRunner(jmodels.BPRMM(**kw), jrunner.MMRecConfig(**cfg),
                             data["train_u"], data["train_i"],
                             data["n_items"])
    pr = runner.MMRecRunner(models.BPRMM(**kw), runner.MMRecConfig(**cfg),
                            data["train_u"], data["train_i"],
                            data["n_items"], device="cpu")
    return jr, pr


def test_evaluate_and_export_match_jax(data):
    """Both runners handed the same embeddings: the evaluation figures
    (dev, test, dev again from one generator) bit for bit, the export key
    for key and value for value."""
    jr, pr = _runners(data)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(data["n_users"], 8)).astype(np.float32)
    i = rng.normal(size=(data["n_items"], 8)).astype(np.float32)
    i[1::7] = i[2::7]   # tied frames
    jr._jit_embed = lambda params, edges: (jnp.asarray(u), jnp.asarray(i))
    pr._embeddings = lambda state=None: (u, i)
    jrng, prng = np.random.default_rng(5), np.random.default_rng(5)
    for split in ("dev", "test", "dev"):
        want = jr.evaluate({"params": None}, data[split], data["frame_map"],
                           jrng)
        got = pr.evaluate(None, data[split], data["frame_map"], prng)
        assert got == want, split
        assert all(np.isfinite(v) for v in got.values())
    want = jr.export_logits({"params": None}, data["all"], data["frame_map"])
    got = pr.export_logits(None, data["all"], data["frame_map"])
    assert list(got) == list(want) and got == want


def test_train_picks_jax_best_epoch(data):
    """train on scripted metrics (hr@5 0.1, 0.3, 0.2, 0.3, 0.25, 0.4;
    stopping_step 3): both stop after epoch 4 with epoch 1 best; the port's
    best state is epoch 1's weights, a copy later epochs did not touch."""
    jr, pr = _runners(data)
    script = [0.1, 0.3, 0.2, 0.3, 0.25, 0.4]

    def scripted(calls):
        def evaluate(state, inters, frame_map, rng=None):
            calls.append(len(inters))
            hr = script[(len(calls) - 1) // 2]
            return {"hr@5": hr, "ndcg@5": hr / 2 + len(calls) % 2}
        return evaluate
    jcalls, pcalls = [], []
    jr.init_state = lambda: {"params": {"epoch": np.zeros(1)}}
    jr.fit_epoch = lambda state, key: (
        {"params": {"epoch": state["params"]["epoch"] + 1}}, 0.5, key)
    jr.evaluate = scripted(jcalls)
    jbest, want = jr.train(data["dev"], data["test"], data["frame_map"])
    pr.evaluate = scripted(pcalls)
    snapshots = []
    fit = pr.fit_epoch

    def fit_and_keep():
        loss = fit()
        snapshots.append(pr.state())
        return loss
    pr.fit_epoch = fit_and_keep
    best, got = pr.train(data["dev"], data["test"], data["frame_map"])
    assert got == want and pcalls == jcalls
    assert int(jbest["params"]["epoch"][0]) == 2 and len(snapshots) == 5
    assert want["best_valid_result"]["hr@5"] == 0.3
    for k, v in best.items():
        torch.testing.assert_close(v, snapshots[1][k], rtol=0, atol=0)
    assert any(not torch.equal(v, snapshots[-1][k])
               for k, v in best.items())


# ---------------------------------------------------------------------------
# the CLI

@pytest.mark.parametrize("name", NAMES)
def test_cli_trains_every_model(csvs, name):
    res = main.main(_argv(csvs["ints"], name))
    _finite(res["best_valid_result"])
    _finite(res["best_test_upon_valid"])


def test_cli_edge_dropout(csvs):
    res = main.main(_argv(csvs["ints"], "FREEDOM", "--edge_dropout", "0.1"))
    _finite(res["best_test_upon_valid"])


def test_cli_test_cold_and_save_logits(csvs, data, tmp_path):
    out = str(tmp_path / "logits.json")
    res = main.main(_argv(csvs["ints"], "FREEDOM", "--test_cold", "1",
                          "--save_logits", out))
    cold = [r for r in data["test"]
            if r["photo_id"] not in data["train_photos"]]
    assert cold and len(cold) < len(data["test"])
    _finite(res["cold_test"])
    _finite(res["hot_test"])
    with open(out) as f:
        logits = json.load(f)
    keys = {f"{r['user_id']}-{r['photo_id']}-{r['time']}"
            for r in data["all"]}
    assert set(logits) == keys
    assert all(len(v) == 40 and np.isfinite(v).all()
               for v in logits.values())


@pytest.mark.parametrize("grid,key,values", [
    ("lr=0.01,0.001", "lr", [0.01, 0.001]),
    ("batch_size=100,128", "batch_size", [100, 128])],
    ids=["lr", "batch_size"])
def test_cli_grid(csvs, grid, key, values):
    res = main.main(_argv(csvs["ints"], "BPR", "--epochs", "1", "--grid",
                          grid))
    assert [r["params"][key] for r in res["grid"]] == values
    assert res["best"] in res["grid"]
    for r in res["grid"]:
        _finite(r["best_test_upon_valid"])


def test_use_mesh_over_cards_raises(monkeypatch):
    args = main.build_parser().parse_args(["--inter_csv", "x"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        main._check_mesh(args, torch.device("cuda"), 128)
    main._check_mesh(args, torch.device("cuda"), 101)   # does not divide
    main._check_mesh(args, torch.device("cpu"), 128)
    args.use_mesh = 0
    main._check_mesh(args, torch.device("cuda"), 128)


# ---------------------------------------------------------------------------
# the seed sweeps

def _sweep(tmp_path, entry, rest):
    out = str(tmp_path / f"{entry}.csv")
    rows = exp.main(["--entry", entry, "--seeds", "0,1", "--out", out, "--",
                     *rest])
    with open(out) as f:
        table = list(csv.DictReader(f))
    return rows, table


def _check_sweep(rows, table, direct):
    """Each seed's row is that entry's own result, flattened and filtered;
    the CSV holds them and their mean."""
    assert [r["seed"] for r in table] == ["0", "1", "mean"]
    for seed, (row, res) in enumerate(zip(rows, direct)):
        flat = {}
        exp._flatten("", res, flat)
        flat = {k: v for k, v in flat.items() if k in row}
        assert flat and row == {**flat, "seed": seed}
        for k, v in flat.items():
            assert float(table[seed][k]) == v
    for k in rows[0]:
        if k != "seed":
            assert float(table[2][k]) == pytest.approx(
                (rows[0][k] + rows[1][k]) / 2, rel=1e-12)


def test_exp_sweeps_mmrec(csvs, tmp_path):
    rest = _argv(csvs["ints"], "BPR", "--epochs", "1")
    rows, table = _sweep(tmp_path, "mmrec", rest)
    direct = [main.main(rest + ["--seed", str(s)]) for s in (0, 1)]
    assert any("hr@5" in k for k in rows[0])
    _check_sweep(rows, table, direct)


def test_exp_sweeps_segrec(csvs, tmp_path):
    from segmminterest_tpu_torch.segrec import main as segrec_main
    build_segrec_data.main(["--inter_csv", csvs["ints"], "--out",
                            str(tmp_path), "--name", "SegMM", *SMALL,
                            "--n_eval_neg", "9"])
    rest = ["--model_name", "FM", "--model_mode", "CTR", "--path",
            str(tmp_path), "--dataset", "SegMM_CTR", "--epoch", "1",
            "--early_stop", "0", "--device", "cpu"]
    rows, table = _sweep(tmp_path, "segrec", rest)
    direct = [segrec_main.main(rest + ["--random_seed", str(s)])
              for s in (0, 1)]
    assert any("AUC" in k for k in rows[0])
    _check_sweep(rows, table, direct)
