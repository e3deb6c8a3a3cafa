"""The port's training engine against the JAX package's ``InterestEngine``
on the CPU: five lock-step AdamW steps from converted params with dropout
off (every attention route, the ablations, fuse_dual and fuse_layer), the
eval loss dict, the bf16 forward, the ``skip_train`` CLI end to end, resume,
and remat.

Tolerances: losses 3e-4 relative over five steps (PARITY "Cross-
implementation verification", ROADMAP "Same weights"): the same fp32 math
summed in another order; measured 1e-6 absolute. Parameters after five
steps 2e-5 absolute: Adam moves each weight by up to lr = 1e-3 per step
whatever the gradient's size, so a gradient near zero whose rounding
differs between the two could move a weight by far more than its rounding;
measured max 8e-7.
"""

import glob
import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.data.dataset import BatchIterator as JaxIterator
from segmminterest_tpu.data.feature_store import FeatureStore as JaxStore
from segmminterest_tpu.data.reader import SeqReader as JaxReader
from segmminterest_tpu.engine.train import InterestEngine as JaxEngine
from segmminterest_tpu.models.interest import SegInterestModel as JaxModel
from segmminterest_tpu.tasks import skip_train as jax_skip_train
from segmminterest_tpu.utils.config import InterestConfig as JaxConfig
from segmminterest_tpu_torch.core import attention as A
from segmminterest_tpu_torch.data.feature_store import FeatureStore
from segmminterest_tpu_torch.data.reader import SeqReader
from segmminterest_tpu_torch.data.synthetic import (synthetic_lineid_map,
                                                    write_synthetic_csv)
from segmminterest_tpu_torch.engine.train import (InterestEngine,
                                                  clip_by_global_norm_)
from segmminterest_tpu_torch.models.convert import flax_to_state_dict
from segmminterest_tpu_torch.models.interest import SegInterestModel
from segmminterest_tpu_torch.tasks import skip_train
from segmminterest_tpu_torch.utils.config import InterestConfig

B, STEPS = 16, 5
LOSS_RTOL, PARAM_ATOL = 3e-4, 2e-5
MODEL = dict(d_model=32, nhead=4, num_layers_enc=2, fusion_heads=2,
             exposure_prob=[1.0] * 40, seed=11, dropout=0.0, remat=False,
             train_batch_size=B, valid_batch_size=B, test_batch_size=B,
             loss_type="interestBPR,focal,interestCE,hazard")
READER = dict(min_interactions=30, num_warmup=10)
ROUTES = {"composed": dict(fused_attention=False),
          "k1": dict(fused_attention=True, fuse_qkv=False),
          "k2": dict(fused_attention=True, fuse_qkv=True),
          "k2v2": dict(fused_attention=True, fuse_qkv=True)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    csv = write_synthetic_csv(str(d / "inter.csv"), n_users=10,
                              per_user=(35, 60), n_videos=200, seed=4)
    reader = SeqReader.from_single_csv(csv, **READER)
    lineid_map = synthetic_lineid_map(reader)
    memmap = str(d / "feat.dat")
    mm = np.memmap(memmap, dtype="float32", mode="w+",
                   shape=(len(lineid_map), 1024))
    mm[:] = np.random.default_rng(0).normal(size=mm.shape)
    mm.flush()
    lineid = str(d / "lineid.json")
    with open(lineid, "w") as f:
        json.dump(lineid_map, f)
    return dict(dir=d, csv=csv, memmap=memmap, lineid=lineid)


def _setup(data, kw):
    """The JAX engine with its initial params, the port's engine on the
    CPU with the same params, and STEPS training batches (numpy)."""
    store = (JaxStore.open(data["memmap"], data["lineid"])
             if kw.get("user_input_type") != "id" else None)
    jreader = JaxReader.from_single_csv(data["csv"], **READER)
    jcfg = JaxConfig(**kw)
    table = np.asarray(store.feat) if store else None
    jeng = JaxEngine(jcfg, jreader.n_users, jreader.n_items,
                     feature_table=table)
    it = JaxIterator(jreader, jreader.tables["train"], B, shuffle=True,
                     feature_store=store, seed=3, prefetch_size=0)
    batches = [b for _, b in zip(range(STEPS), it)]
    jstate = jeng.init_state(jax.random.PRNGKey(3), batches[0])
    params = jax.tree.map(np.asarray, jstate["params"])
    peng = InterestEngine(InterestConfig(**kw), jreader.n_users,
                          jreader.n_items, feature_table=table, device="cpu")
    peng.init_state()
    pstate = {"params": flax_to_state_dict(params, peng.model)}
    return jeng, jstate, peng, pstate, batches


@pytest.mark.parametrize("route,modality", [
    ("composed", "id"), ("k1", "id"), ("k2", "id"), ("k2", "both"),
    ("k2v2", "both")])
def test_lockstep_adamw_matches_jax(data, route, modality, monkeypatch):
    """``k2v2``: the port under SEGMM_ATTN_V2's switch (K6's plain version,
    with its interleaving, block swap and de-interleaved gradients) against
    the JAX engine, which sends fuse_qkv to its composed path on the CPU."""
    kw = dict(MODEL, user_input_type=modality, photo_input_type=modality,
              **ROUTES[route])
    monkeypatch.setattr(A, "ATTN_V2", route == "k2v2")
    v2_calls = []
    plain = A.proj_two_block_attention_v2_bwd_plain
    monkeypatch.setattr(A, "proj_two_block_attention_v2_bwd_plain",
                        lambda *a: v2_calls.append(1) or plain(*a))
    jeng, jstate, peng, pstate, batches = _setup(data, kw)
    key = jax.random.PRNGKey(0)
    jl, pl = [], []
    for b in batches:
        jstate, jld = jeng.train_step(jstate, key, b)
        pstate, pld = peng.train_step(pstate, b)
        jl.append(float(jld["loss"]))
        pl.append(float(pld["loss"]))
    assert bool(v2_calls) == (route == "k2v2")
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert len(set(jl)) == STEPS  # the weights moved every step
    want = flax_to_state_dict(jax.tree.map(np.asarray, jstate["params"]),
                              peng.model)
    for name, p in pstate["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    # the optimizer state is fp32 and one entry per parameter
    opt = pstate["opt_state"]["state"]
    assert len(opt) == len(pstate["params"])
    assert all(s["exp_avg"].dtype == torch.float32 for s in opt.values())


ABLATIONS = {"CrossAtt-composed": dict(ablation_type="CrossAtt",
                                       fused_attention=False),
             "CrossAtt-k3": dict(ablation_type="CrossAtt",
                                 fused_attention=True),
             "SelfAtt-k3": dict(ablation_type="SelfAtt", fused_attention=True,
                                fuse_qkv=True),
             "CrossMLP": dict(ablation_type="CrossMLP", num_layers_enc=6),
             "fuse_projections": dict(fused_attention=True,
                                      fuse_projections=True)}


@pytest.mark.parametrize("case", list(ABLATIONS))
def test_lockstep_ablations_match_jax(data, case):
    """Five AdamW steps of the ablations and of fuse_projections against
    the JAX engine, every parameter included: the ones that reach no output
    (CrossAtt's v2v/t2t value Denses, SelfAtt's user stream) have zero
    gradients on both sides and move only by the decoupled weight decay."""
    kw = dict(MODEL, user_input_type="id", photo_input_type="id",
              **ABLATIONS[case])
    jeng, jstate, peng, pstate, batches = _setup(data, kw)
    dead = "backbone1.layers.0.cross_attn.t2t_proj.0.weight"
    p0 = pstate["params"].get(dead)
    key = jax.random.PRNGKey(0)
    jl, pl = [], []
    for b in batches:
        jstate, jld = jeng.train_step(jstate, key, b)
        pstate, pld = peng.train_step(pstate, b)
        jl.append(float(jld["loss"]))
        pl.append(float(pld["loss"]))
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert len(set(jl)) == STEPS
    want = flax_to_state_dict(jax.tree.map(np.asarray, jstate["params"]),
                              peng.model)
    assert set(want) == set(pstate["params"])
    for name, p in pstate["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    if case == "SelfAtt-k3":  # dead: moved by the weight decay alone
        cfg = peng.config
        decay = (1 - cfg.learning_rate * cfg.weight_decay) ** STEPS
        np.testing.assert_allclose(pstate["params"][dead].detach().numpy(),
                                   p0.numpy() * decay, rtol=1e-6)


FUSED = {"fuse_dual-both": ("both", dict(fused_attention=True,
                                           fuse_dual=True)),
         "fuse_layer-id": ("id", dict(fuse_layer=True)),
         "fuse_layer-both": ("both", dict(fuse_layer=True))}


@pytest.mark.parametrize("case", list(FUSED))
def test_lockstep_fused_variants_match_jax(data, case):
    """Five AdamW steps of fuse_dual (K5 on the feature backbone, K2 on
    the ID backbone's single-query user stream) and fuse_layer (K4) against
    the JAX engine, every parameter included."""
    modality, flags = FUSED[case]
    kw = dict(MODEL, user_input_type=modality, photo_input_type=modality,
              **flags)
    jeng, jstate, peng, pstate, batches = _setup(data, kw)
    layer = peng.model.backbone1.layers[0]
    assert layer.fuse_layer == ("fuse_layer" in case)
    assert layer.cross_attn.fuse_dual == ("fuse_dual" in case)
    key = jax.random.PRNGKey(0)
    jl, pl = [], []
    for b in batches:
        jstate, jld = jeng.train_step(jstate, key, b)
        pstate, pld = peng.train_step(pstate, b)
        jl.append(float(jld["loss"]))
        pl.append(float(pld["loss"]))
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert len(set(jl)) == STEPS
    want = flax_to_state_dict(jax.tree.map(np.asarray, jstate["params"]),
                              peng.model)
    assert set(want) == set(pstate["params"])
    for name, p in pstate["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_eval_loss_dict_matches_jax(data):
    kw = dict(MODEL, user_input_type="both", photo_input_type="both",
              **ROUTES["k2"], mask_loss=True,
              loss_type="focal,interestKL,huber,surviveCE,interestBPR")
    jeng, jstate, peng, pstate, batches = _setup(data, kw)
    for b in batches[:2]:
        b = dict(b, row_mask=b["row_mask"].copy())
        b["row_mask"][-3:] = False  # padded rows
        jld, jlog, jint = jeng.eval_step(jstate, b)
        pld, plog, pint = peng.eval_step(pstate, b)
        assert set(pld) == set(jld)
        for k in jld:
            np.testing.assert_allclose(float(pld[k]), float(jld[k]),
                                       rtol=2e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), atol=1e-4)
        np.testing.assert_allclose(pint.numpy(), np.asarray(jint), atol=1e-5)


@pytest.mark.parametrize("route", ["composed", "k2"])
def test_bf16_forward_matches_jax(rng, route):
    """fp32 params, bf16 compute, on both sides from the same params. The
    fusion head's output is bf16, which keeps 8 significant bits: one ulp
    of the largest logit before the (fp32) learnable bias is 2^-7 of its
    power of two (0.03125 for logits in [4, 8)). The two frameworks round
    at the same points but sum in other orders, so a value that rounds the
    other way moves the logits by an ulp or two; tolerance 4 ulps of that
    largest pre-bias logit, measured up to 2 over four seeds (each side
    is ~1.5 ulps from its own fp32 result)."""
    kw = dict(d_model=64, num_heads=4, num_layers=3, ff_dim=64, n_users=20,
              n_items=30, fusion_heads=2, learnable_bias=True)
    Bm, F, LU = 4, 48, 100
    usr = rng.normal(size=(Bm, LU, F)).astype(np.float32)
    vid = rng.normal(size=(Bm, 40, F)).astype(np.float32)
    um = np.arange(LU)[None] < rng.integers(1, LU + 1, Bm)[:, None]
    vm = np.arange(40)[None] < rng.integers(1, 41, Bm)[:, None]
    uid = rng.integers(1, 21, Bm).astype(np.int32)
    vidid = rng.integers(1, 31, Bm).astype(np.int32)
    args = (usr, uid, um, vid, vidid, vm)
    jm = JaxModel(**kw, dtype=jnp.bfloat16)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              *map(jnp.asarray, args))["params"]
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    params["bias_weight"] = rng.normal(size=(1, 40)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": params},
                                        *map(jnp.asarray, args)), np.float32)
    tm = SegInterestModel(**kw, feat_dim=F, **ROUTES[route]).eval()
    tm.load_state_dict(flax_to_state_dict(params, tm))
    tm.to_compute_dtype(torch.bfloat16)
    # the LayerNorms and the learnable bias stay fp32 (flax param_dtype)
    assert tm.backbone1.vid_ln.weight.dtype == torch.float32
    assert tm.bias_weight.dtype == torch.float32
    assert tm.backbone1.vid_pe.dtype == torch.bfloat16
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args)).float().numpy()
    bias = ((np.arange(40) + 1.0) * params["bias_weight"]
            + params["bias_bias"])
    pre = np.abs(want - bias).max()
    assert pre > 1.0
    ulp = 2.0 ** (np.floor(np.log2(pre)) - 7)
    np.testing.assert_allclose(got, want, atol=4 * ulp, rtol=0)


def test_bf16_engine_keeps_fp32_params(data):
    kw = dict(MODEL, user_input_type="id", photo_input_type="id",
              compute_dtype="bfloat16", dropout=0.1, **ROUTES["k2"])
    reader = SeqReader.from_single_csv(data["csv"], **READER)
    eng = InterestEngine(InterestConfig(**kw), reader.n_users,
                         reader.n_items, device="cpu")
    state = eng.init_state()
    batch = next(iter(JaxIterator(JaxReader.from_single_csv(
        data["csv"], **READER), JaxReader.from_single_csv(
            data["csv"], **READER).tables["train"], B, prefetch_size=0)))
    before = {n: p.detach().clone() for n, p in state["params"].items()}
    state, ld = eng.train_step(state, batch)
    assert np.isfinite(float(ld["loss"]))
    assert all(p.dtype == torch.float32 for p in state["params"].values())
    opt = state["opt_state"]["state"]
    assert all(s["exp_avg_sq"].dtype == torch.float32 for s in opt.values())
    # the working copy is the fp32 params rounded once, refreshed per step
    w = dict(eng.model.named_parameters())
    name = "backbone1.layers.0.cross_attn.v2v_proj.0.weight"
    assert w[name].dtype == torch.bfloat16
    torch.testing.assert_close(w[name], state["params"][name].bfloat16(),
                               rtol=0, atol=0)
    assert not torch.equal(before[name], state["params"][name])


def test_clip_by_global_norm_is_optax():
    import optax
    rng = np.random.default_rng(0)
    for scale in (0.1, 10.0):
        gs = [rng.normal(size=s).astype(np.float32) * scale
              for s in ((3, 4), (5,))]
        want, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(g) for g in gs], None)
        got = [torch.from_numpy(g.copy()) for g in gs]
        clip_by_global_norm_(got, 1.0)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_remat_changes_no_numbers(data):
    """Layer and attention remat give the losses and gradients of no remat,
    dropout on, K1 route: the kernels' seeds are drawn before the
    recomputed region and nn.Dropout's RNG state is replayed."""
    reader = SeqReader.from_single_csv(data["csv"], **READER)
    batch = next(iter(JaxIterator(JaxReader.from_single_csv(
        data["csv"], **READER), JaxReader.from_single_csv(
            data["csv"], **READER).tables["train"], B, prefetch_size=0)))
    out = {}
    for remat, scope in ((False, "layer"), (True, "layer"),
                         (True, "attention")):
        kw = dict(MODEL, user_input_type="id", photo_input_type="id",
                  dropout=0.1, remat=remat, remat_scope=scope,
                  **ROUTES["k1"])
        eng = InterestEngine(InterestConfig(**kw), reader.n_users,
                             reader.n_items, device="cpu")
        torch.manual_seed(0)
        dev = eng.put_batch(batch)
        eng.model.train()
        logits = eng.model(*eng._model_inputs(dev))
        loss = eng._loss_from_logits(logits, dev)["loss"]
        loss.backward()
        # the last layer's user stream reaches no output: no gradient
        out[(remat, scope)] = (loss.item(), {
            n: p.grad.clone() for n, p in eng.model.named_parameters()
            if p.grad is not None})
    base_loss, base_grads = out[(False, "layer")]
    for key in ((True, "layer"), (True, "attention")):
        loss, grads = out[key]
        assert loss == base_loss
        assert set(grads) == set(base_grads)
        for n, g in grads.items():
            torch.testing.assert_close(g, base_grads[n], rtol=0, atol=0,
                                       msg=f"{key} {n}")


def _cli_args(data, ckpt_dir, extra=()):
    return ["--sample_csv", data["csv"], "--min_interactions", "30",
            "--num_warmup", "10", "--user_input_type", "id",
            "--photo_input_type", "id", "--d_model", "32", "--nhead", "4",
            "--num_layers_enc", "3", "--debug", "1", "--seed", "5",
            "--ckpt_dir", str(ckpt_dir), "--eval_cold", "test", "--remat",
            "0", *extra]


def test_skip_train_end_to_end_matches_jax_outputs(data):
    """The port's CLI on the CPU writes the files the JAX CLI writes, and
    final_results.json holds the same keys; the JAX CLI runs on the same
    CSV for the comparison."""
    res = skip_train.main(_cli_args(data, data["dir"] / "port_ckpt",
                                    ["--device", "cpu"]))
    work = res["work_dir"]
    assert osp.exists(osp.join(work, "ckpt-latest.pt"))
    assert len(glob.glob(osp.join(work, "ckpt-best-*.pt"))) == 1
    with open(osp.join(work, "final_results.json")) as f:
        got = json.load(f)
    jres = jax_skip_train.main(_cli_args(data, data["dir"] / "jax_ckpt"))
    with open(osp.join(jres["work_dir"], "final_results.json")) as f:
        want = json.load(f)
    assert set(got) == set(want)
    assert set(res) >= {"test_metrics", "cold_test_metrics",
                        "hot_test_metrics", "steps"}
    assert res["steps"] == jres["steps"] > 0
    assert all(np.isfinite(v) for v in got.values())


def test_skip_train_ablation_cli_matches_jax_outputs(data):
    """``--ablation_type CrossAtt`` through both CLIs: the same output files
    and JSON keys, and as many steps."""
    extra = ["--ablation_type", "CrossAtt"]
    res = skip_train.main(_cli_args(data, data["dir"] / "port_abl",
                                    extra + ["--device", "cpu"]))
    work = res["work_dir"]
    assert osp.exists(osp.join(work, "ckpt-latest.pt"))
    assert len(glob.glob(osp.join(work, "ckpt-best-*.pt"))) == 1
    with open(osp.join(work, "final_results.json")) as f:
        got = json.load(f)
    jres = jax_skip_train.main(_cli_args(data, data["dir"] / "jax_abl", extra))
    with open(osp.join(jres["work_dir"], "final_results.json")) as f:
        want = json.load(f)
    assert set(got) == set(want)
    assert set(res) >= {"test_metrics", "cold_test_metrics",
                        "hot_test_metrics", "steps"}
    assert res["steps"] == jres["steps"] > 0
    assert all(np.isfinite(v) for v in got.values())


def test_skip_train_fuse_layer_cli_matches_jax_outputs(data):
    """``--fuse_layer 1`` through both CLIs on the CPU: the same output
    files and JSON keys, and as many steps."""
    extra = ["--fuse_layer", "1"]
    res = skip_train.main(_cli_args(data, data["dir"] / "port_fl",
                                    extra + ["--device", "cpu"]))
    work = res["work_dir"]
    assert osp.exists(osp.join(work, "ckpt-latest.pt"))
    assert len(glob.glob(osp.join(work, "ckpt-best-*.pt"))) == 1
    with open(osp.join(work, "final_results.json")) as f:
        got = json.load(f)
    jres = jax_skip_train.main(_cli_args(data, data["dir"] / "jax_fl", extra))
    with open(osp.join(jres["work_dir"], "final_results.json")) as f:
        want = json.load(f)
    assert set(got) == set(want)
    assert res["steps"] == jres["steps"] > 0
    assert all(np.isfinite(v) for v in got.values())


def test_resume_from_latest(data):
    args = _cli_args(data, data["dir"] / "resume", ["--device", "cpu"])
    first = skip_train.main(args)
    work = first["work_dir"]
    saved = torch.load(osp.join(work, "ckpt-latest.pt"), weights_only=True)
    assert saved["num_epochs"] == 1  # debug: epochs=2, both ran
    assert set(saved["state"]) == {"params", "opt_state"}
    # resuming at the saved epoch (1 of 2) runs the last epoch only
    again = skip_train.main(args + ["--load", "1"])
    assert first["steps"] == 2 * again["steps"] > 0


def test_distributed_raises(data):
    with pytest.raises(NotImplementedError):
        skip_train.main(_cli_args(data, data["dir"] / "dist",
                                  ["--device", "cpu", "--distributed", "1"]))


def test_launch_counters_untouched_on_cpu(data):
    """A training step on the CPU runs the plain versions only."""
    reader = SeqReader.from_single_csv(data["csv"], **READER)
    store = FeatureStore.open(data["memmap"], data["lineid"])
    kw = dict(MODEL, user_input_type="both", photo_input_type="both",
              dropout=0.1, **ROUTES["k2"])
    eng = InterestEngine(InterestConfig(**kw), reader.n_users,
                         reader.n_items, feature_table=np.asarray(store.feat),
                         device="cpu")
    batch = next(iter(JaxIterator(JaxReader.from_single_csv(
        data["csv"], **READER), JaxReader.from_single_csv(
            data["csv"], **READER).tables["train"], B,
        feature_store=JaxStore.open(data["memmap"], data["lineid"]),
        prefetch_size=0)))
    before = dict(A.LAUNCHES)
    _, ld = eng.train_step(eng.init_state(), batch)
    assert np.isfinite(float(ld["loss"]))
    assert A.LAUNCHES == before
