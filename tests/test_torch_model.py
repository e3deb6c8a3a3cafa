"""The port's SegFormerX / SegInterestModel against the flax models with
converted weights, at fp32 and deterministic, on each attention route
(composed, K1 and K2; the kernels' plain versions on the CPU). Tolerance
1e-4 on logits: the same fp32 math, summed in another order through a few
layers with LayerNorm (measured ~1e-6)."""

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

B, D, H, F, LU = 3, 64, 4, 48, 100
ATOL = 1e-4
ROUTES = {"composed": dict(fused_attention=False),
          "k1": dict(fused_attention=True, fuse_qkv=False),
          "k2": dict(fused_attention=True, fuse_qkv=True)}


def _inputs(rng):
    usr_img = rng.normal(size=(B, LU, F)).astype(np.float32)
    vid_img = rng.normal(size=(B, 40, F)).astype(np.float32)
    um, vm = np.zeros((B, LU), bool), np.zeros((B, 40), bool)
    for i in range(B):
        um[i, :rng.integers(1, LU + 1)] = True
        vm[i, :rng.integers(1, 41)] = True
    uid = rng.integers(1, 21, size=B).astype(np.int32)
    vid = rng.integers(1, 31, size=B).astype(np.int32)
    return usr_img, uid, um, vid_img, vid, vm


def _flax_params(module, args):
    params = module.init(jax.random.PRNGKey(0),
                         *map(jnp.asarray, args))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("modality", ["both", "id", "image"])
def test_interest_model_matches_flax(rng, modality, route):
    kw = dict(d_model=D, num_heads=H, num_layers=3, ff_dim=D, n_users=20,
              n_items=30, fusion_heads=2, user_input=modality,
              photo_input=modality, learnable_bias=modality == "both")
    args = _inputs(rng)
    jm = JaxModel(**kw)
    params = _flax_params(jm, args)
    if modality == "both":  # move the bias off its all-ones init
        params["bias_weight"] = rng.normal(size=(1, 40)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args)))
    tm = SegInterestModel(**kw, feat_dim=F, **ROUTES[route]).eval()
    load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args)).numpy()
    assert got.shape == (B, 40)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fusion_heads", [-2, -1, 0, 1])
def test_fusion_heads_match_flax(rng, fusion_heads):
    kw = dict(d_model=D, num_heads=H, num_layers=2, ff_dim=D, n_users=20,
              n_items=30, fusion_heads=fusion_heads)
    args = _inputs(rng)
    jm = JaxModel(**kw)
    params = _flax_params(jm, args)
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args)))
    tm = load_flax_params(SegInterestModel(**kw, feat_dim=F).eval(), params)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("route", list(ROUTES))
def test_segformerx_states_match_flax(rng, route):
    usr_img, _, um, vid_img, _, vm = _inputs(rng)
    kw = dict(d_model=D, num_heads=H, num_layers=3, ff_dim=2 * D,
              max_usr_len=LU, output_layers=[-1])
    jm = JaxSegFormerX(**kw)
    args = (usr_img, um, vid_img, vm)
    params = _flax_params(jm, args)
    states, usr = jm.apply({"params": params}, *map(jnp.asarray, args))
    tm = load_flax_params(SegFormerX(**kw, feat_dim=F, **ROUTES[route])
                          .eval(), params)
    with torch.no_grad():
        got_states, got_usr = tm(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got_states[-1].numpy(),
                               np.asarray(states[-1]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_usr.numpy(), np.asarray(usr), atol=ATOL,
                               rtol=0)


def test_converter_round_trip_checks_every_shape(rng):
    kw = dict(d_model=D, num_heads=H, num_layers=3, ff_dim=D, n_users=20,
              n_items=30, fusion_heads=2, learnable_bias=True)
    args = _inputs(rng)
    params = _flax_params(JaxModel(**kw), args)
    tm = SegInterestModel(**kw, feat_dim=F)
    sd = flax_to_state_dict(params, tm)
    assert set(sd) == set(tm.state_dict())
    for k, v in sd.items():
        assert v.shape == tm.state_dict()[k].shape, k
    layer = params["backbone1"]["layer_0"]["cross_attn"]["v2v_proj_1"]
    np.testing.assert_array_equal(
        sd["backbone1.layers.0.cross_attn.v2v_proj.1.weight"].numpy(),
        layer["kernel"].T)
    np.testing.assert_array_equal(
        sd["backbone2.vid_proj.weight"].numpy(),
        params["backbone2"]["vid_proj"]["embedding"])
    np.testing.assert_array_equal(
        sd["backbone1.layers.1.ff_usr.layers.0.bias"].numpy(),
        params["backbone1"]["layer_1"]["ff_usr"]["layer_0"]["bias"])
    # layer 2 (the last) is never built on either side (PARITY M1)
    assert "layer_2" not in params["backbone1"]
    # a wrong shape, an unknown leaf and a missing leaf all raise
    bad = jax.tree.map(lambda x: x, params)
    bad["fusion_module"]["w_xy"] = np.zeros((3, 1), np.float32)
    with pytest.raises(ValueError):
        flax_to_state_dict(bad, tm)
    bad = jax.tree.map(lambda x: x, params)
    bad["backbone1"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        flax_to_state_dict(bad, tm)
    bad = jax.tree.map(lambda x: x, params)
    del bad["backbone1"]["usr_ln"]
    with pytest.raises(KeyError):
        flax_to_state_dict(bad, tm)

