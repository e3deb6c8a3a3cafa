"""The port's ablation models and ``fuse_projections`` against the flax
models with converted weights: CrossAtt and SelfAtt on the composed route
and on the K3 route (with ``fuse_qkv`` off and on: the 'ours'-only flag
does not apply to them), CrossMLP, SelfMLP, w/oAtt, noPos and woCrossAtt,
for the both and id modalities; flax runs its kernels with
``interpret=True`` and the port their plain versions on the CPU.

Tolerances: fp32 logits 1e-4, as tests/test_torch_model.py holds the 'ours'
path (the same fp32 math summed in another order through a few layers with
LayerNorm, measured ~1e-6); bf16 and dropout as stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.models.interest import SegInterestModel as JaxModel
from segmminterest_tpu.models.segformerx import SegFormerX as JaxSegFormerX
from segmminterest_tpu_torch.models.convert import (flax_to_state_dict,
                                                    load_flax_params)
from segmminterest_tpu_torch.models.interest import SegInterestModel
from segmminterest_tpu_torch.models.segformerx import SegFormerX

B, D, H, F, LU = 3, 32, 2, 24, 20
ATOL = 1e-4
ROUTES = {"composed": dict(fused_attention=False),
          "k3": dict(fused_attention=True, fuse_qkv=False),
          "k3_fuse_qkv": dict(fused_attention=True, fuse_qkv=True),
          "k1": dict(fused_attention=True, fuse_qkv=False),
          "none": {}}
# (ablation, route); the MLP ablations build no layer, so they run at 6
# layers (CrossMLP then has 2 hidden Denses, SelfMLP 4)
CASES = ([(a, r) for a in ("CrossAtt", "SelfAtt")
          for r in ("composed", "k3", "k3_fuse_qkv")]
         + [("CrossMLP", "none"), ("SelfMLP", "none"), ("w/oAtt", "none"),
            ("noPos", "k1"), ("woCrossAtt", "k3")])


def _layers(ablation):
    return 6 if ablation in ("CrossMLP", "SelfMLP", "w/oAtt") else 3


def _inputs(rng, b=B):
    usr_img = rng.normal(size=(b, LU, F)).astype(np.float32)
    vid_img = rng.normal(size=(b, 40, F)).astype(np.float32)
    um, vm = np.zeros((b, LU), bool), np.zeros((b, 40), bool)
    for i in range(b):
        um[i, :rng.integers(1, LU + 1)] = True
        vm[i, :rng.integers(1, 41)] = True
    uid = rng.integers(1, 21, size=b).astype(np.int32)
    vid = rng.integers(1, 31, size=b).astype(np.int32)
    return usr_img, uid, um, vid_img, vid, vm


def _flax_params(module, args):
    """Params of ``module``'s tree, initialised through its composed route
    (the same tree for the ablations; the interpreter is slow)."""
    if "CrossAtt" in module.ablation or "SelfAtt" in module.ablation:
        module = module.clone(fused_attention=False, interpret=False)
    params = module.init(jax.random.PRNGKey(0),
                         *map(jnp.asarray, args))["params"]
    return jax.tree.map(np.asarray, params)


def _model_kw(ablation, modality, **extra):
    return dict(d_model=D, num_heads=H, num_layers=_layers(ablation),
                ff_dim=D, n_users=20, n_items=30, fusion_heads=2,
                user_input=modality, photo_input=modality,
                ablation=ablation, **extra)


@pytest.mark.parametrize("modality", ["both", "id"])
@pytest.mark.parametrize("ablation,route", CASES,
                         ids=[f"{a.replace('/', '')}-{r}" for a, r in CASES])
def test_ablation_model_matches_flax(rng, ablation, route, modality):
    kw = _model_kw(ablation, modality)
    args = _inputs(rng)
    jm = JaxModel(**kw, **ROUTES[route], interpret=True)
    params = _flax_params(jm, args)
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args)))
    tm = SegInterestModel(**kw, feat_dim=F, **ROUTES[route]).eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args)).numpy()
    assert got.shape == (B, 40)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ablation", ["CrossAtt", "SelfAtt"])
def test_segformerx_user_state_matches_flax(rng, ablation):
    """The backbone's states: SelfAtt's layers return no user state, so the
    user state that comes out is the embedded input (segformerx.py:848)."""
    usr_img, _, um, vid_img, _, vm = _inputs(rng)
    kw = dict(d_model=D, num_heads=H, num_layers=3, ff_dim=2 * D,
              max_usr_len=LU, output_layers=[-1], ablation=ablation,
              fused_attention=True)
    jm = JaxSegFormerX(**kw, interpret=True)
    args = (usr_img, um, vid_img, vm)
    params = _flax_params(jm, args)
    states, usr = jm.apply({"params": params}, *map(jnp.asarray, args))
    tm = load_flax_params(SegFormerX(**kw, feat_dim=F).eval(), params)
    with torch.no_grad():
        got_states, got_usr = tm(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got_states[-1].numpy(),
                               np.asarray(states[-1]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_usr.numpy(), np.asarray(usr), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("modality", ["both", "id"])
def test_fuse_projections_matches_flax(rng, modality):
    """Two Linear(d, 6d) in place of the per-stream Denses, sliced in
    flax's column order, on the K1 route (segformerx.py:446-460)."""
    kw = _model_kw("ours", modality, fuse_projections=True)
    args = _inputs(rng)
    jm = JaxModel(**kw, **ROUTES["k1"], interpret=True)
    params = _flax_params(jm, args)
    attn = params["backbone1"]["layer_0"]["cross_attn"]
    assert set(attn) == {"vid_projs", "usr_projs", "ff_usr", "ff_vid",
                         "ln_vid", "ln_usr"}
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args)))
    tm = load_flax_params(SegInterestModel(**kw, feat_dim=F, **ROUTES["k1"])
                          .eval(), params)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ablation", ["CrossAtt", "CrossMLP"])
def test_bf16_ablation_matches_flax(rng, ablation):
    """fp32 params, bf16 compute, from the same params. CrossMLP's
    encoder_mlp runs in fp32 in both (flax builds it without a dtype), so
    its state and the fused logits are fp32 there. Tolerance as in
    tests/test_torch_train.py's bf16 forward: 4 bf16 ulps (2^-7 of its
    power of two) of the largest logit, since bf16 results that round the
    other way move the logits by an ulp or two."""
    kw = dict(_model_kw(ablation, "both"), num_layers=_layers(ablation),
              learnable_bias=True)
    route = ROUTES["k3"] if ablation == "CrossAtt" else {}
    args = _inputs(rng, 4)
    jm = JaxModel(**kw, **route, interpret=True, dtype=jnp.bfloat16)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          _flax_params(jm, args))
    params["bias_weight"] = rng.normal(size=(1, 40)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args)),
                      np.float32)
    tm = SegInterestModel(**kw, feat_dim=F, **route).eval()
    tm.load_state_dict(flax_to_state_dict(params, tm))
    tm.to_compute_dtype(torch.bfloat16)
    if ablation == "CrossMLP":
        assert tm.backbone1.encoder_mlp.dense_0.weight.dtype == torch.float32
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args)).float().numpy()
    bias = ((np.arange(40) + 1.0) * params["bias_weight"]
            + params["bias_bias"])
    pre = np.abs(want - bias).max()
    ulp = 2.0 ** (np.floor(np.log2(pre)) - 7)
    np.testing.assert_allclose(got, want, atol=4 * ulp, rtol=0)


def test_crossatt_dropout_k3_matches_flax(rng, monkeypatch):
    """Training mode, dropout 0.3, CrossAtt on the K3 route: the port's K3
    (plain version) against flax's K3 in interpret mode with the same
    per-layer seeds, so both draw the same hash mask. Every nn.Dropout
    outside the kernels is the identity on both sides (their generators
    differ), which leaves the kernels' mask as the only randomness; one
    differing keep bit would move a logit by far more than 1e-4."""
    import flax.linen as fnn
    from segmminterest_tpu.core import attention as JA

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(torch.nn.Dropout, "forward", lambda self, x: x)
    seeds = []
    jax_k3 = JA.fused_masked_attention

    def recording(*a, seed=None, **k):
        seeds.append(int(np.asarray(seed).reshape(-1)[0]))
        return jax_k3(*a, seed=seed, **k)

    monkeypatch.setattr(JA, "fused_masked_attention", recording)
    kw = dict(_model_kw("CrossAtt", "both"), dropout=0.3)
    args = _inputs(rng, 8)
    jm = JaxModel(**kw, **ROUTES["k3"], interpret=True)
    params = _flax_params(jm, args)
    seeds.clear()
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args),
                               deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(5)}))
    n = _layers("CrossAtt") - 1       # layers run per backbone
    assert len(seeds) == 2 * 2 * n and len(set(seeds)) > 1
    tm = load_flax_params(SegInterestModel(**kw, feat_dim=F, **ROUTES["k3"]),
                          params).train()
    for i, bb in enumerate(tm.backbones()):
        s = seeds[2 * n * i:2 * n * (i + 1)]
        bb._layer_seeds = lambda s=s: [(s[2 * j], s[2 * j + 1])
                                       for j in range(n)]
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args)).numpy()
        tm.eval()
        plain = tm(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(got - plain).max() > 1e-2   # the mask did act


TREES = {"CrossAtt": dict(ablation="CrossAtt", fused_attention=True),
         "SelfAtt": dict(ablation="SelfAtt", fused_attention=True),
         "CrossMLP": dict(ablation="CrossMLP", num_layers=6),
         "SelfMLP": dict(ablation="SelfMLP", num_layers=6),
         "woAtt": dict(ablation="w/oAtt"),
         # both names: CrossAtt's streams, SelfAtt's missing user state
         "CrossAttSelfAtt": dict(ablation="CrossAttSelfAtt",
                                 fused_attention=True),
         "fuse_projections": dict(fused_attention=True,
                                  fuse_projections=True)}


@pytest.mark.parametrize("tree", list(TREES))
def test_converter_round_trip_per_tree(rng, tree):
    """Every leaf of each ablation's flax tree lands on a key of the port's
    model with its shape, every key is written, and a wrong shape, an extra
    leaf or a missing leaf raises."""
    kw = dict(_model_kw("ours", "both"), learnable_bias=True)
    kw.update(TREES[tree])
    args = _inputs(rng)
    params = _flax_params(JaxModel(**kw, interpret=True), args)
    tm = SegInterestModel(**kw, feat_dim=F)
    sd = flax_to_state_dict(params, tm)
    assert set(sd) == set(tm.state_dict())
    bb = params["backbone1"]
    if tree == "SelfAtt":
        layer = bb["layer_0"]
        assert "ln_usr" not in layer and "ff_usr" not in layer
        assert set(layer["cross_attn"]) == {
            "v2v_proj_0", "v2v_proj_1", "v2v_proj_2", "t2t_proj_0",
            "t2t_proj_1", "t2t_proj_2", "t2v_proj_2", "v2t_proj_2",
            "ff_usr", "ff_vid", "ln_vid"}
        np.testing.assert_array_equal(
            sd["backbone1.layers.0.cross_attn.t2v_proj.2.weight"].numpy(),
            layer["cross_attn"]["t2v_proj_2"]["kernel"].T)
    if tree == "CrossMLP":
        assert set(bb["encoder_mlp"]) == {"dense_0", "dense_1", "dense_out"}
        assert not any(k.startswith("layer_") for k in bb)
        np.testing.assert_array_equal(
            sd["backbone2.encoder_mlp.dense_out.weight"].numpy(),
            params["backbone2"]["encoder_mlp"]["dense_out"]["kernel"].T)
    leaf = next(k for k in ("encoder_mlp", "layer_0", "vid_ln") if k in bb)
    bad = jax.tree.map(lambda x: x, params)
    sub = bad["backbone1"][leaf]
    first = next(iter(sub))
    sub[first] = jax.tree.map(lambda x: np.zeros((x.shape[0] + 1,)
                                                 + x.shape[1:], x.dtype),
                              sub[first])
    with pytest.raises(ValueError):
        flax_to_state_dict(bad, tm)
    bad = jax.tree.map(lambda x: x, params)
    bad["backbone1"]["extra_proj"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        flax_to_state_dict(bad, tm)
    bad = jax.tree.map(lambda x: x, params)
    del bad["backbone2"][leaf][first]
    with pytest.raises(KeyError):
        flax_to_state_dict(bad, tm)


def test_nopos_permutes_positions_in_training(rng):
    """noPos in training: each row's frame positions are a permutation of
    0..Lv-1, drawn from the permute generator (another seed, other
    positions and another output); in eval they are 0..Lv-1 in order."""
    kw = _model_kw("noPos", "id")
    args = tuple(map(torch.from_numpy, _inputs(rng, 4)))
    tm = SegInterestModel(**kw, feat_dim=F, **ROUTES["k1"], dropout=0.0)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    seen = []
    tm.backbone1.frameid_proj.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[0][..., 0].clone()))

    def run(train, seed):
        tm.train(train)
        tm.set_seed_generator(None, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return tm(*args)

    out_a, out_b, out_a2 = run(True, 1), run(True, 2), run(True, 1)
    out_eval = run(False, 1)
    pos_a, pos_b, pos_a2, pos_eval = seen
    ref = torch.arange(40, dtype=torch.float32)
    for pos in (pos_a, pos_b):
        assert pos.shape == (4, 40)
        assert all(torch.equal(row.sort().values, ref) for row in pos)
        assert not torch.equal(pos, ref.expand(4, 40))
    assert not torch.equal(pos_a, pos_b)
    assert not torch.allclose(out_a, out_b)
    torch.testing.assert_close(pos_a2, pos_a, rtol=0, atol=0)
    torch.testing.assert_close(out_a2, out_a, rtol=0, atol=0)
    torch.testing.assert_close(pos_eval, ref.expand(4, 40), rtol=0, atol=0)
    assert not torch.allclose(out_eval, out_a)
