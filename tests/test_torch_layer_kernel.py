"""The layer-fused stream K4 (segmminterest_tpu_torch/core/layer_kernel.py)
against the JAX Pallas kernel run through the interpreter
(segmminterest_tpu/core/layer_kernel.py, as tests/test_layer_kernel.py runs
it), on the same seeded inputs: forward and every gradient, dropout off and
on (the attention's and the epilogue's three masks draw the same bits);
the GELU, LayerNorm and epilogue-dropout pieces alone; SegFormerX with
``fuse_layer`` against the flax model through models/convert.py; and the
rule that whole-layer remat is off while K4 runs.

Tolerances as the JAX tests use for this kernel: forward rtol 2e-4 / atol
2e-5, gradients 6e-4 (fp32, the same products summed in another order
through two LayerNorms). bf16: two ulps of the largest output.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.core import layer_kernel as JLK
from segmminterest_tpu.models.segformerx import SegFormerX as JaxSegFormerX
from segmminterest_tpu_torch.core import attention as A
from segmminterest_tpu_torch.core import layer_kernel as LK
from segmminterest_tpu_torch.models.convert import (flax_to_state_dict,
                                                    load_flax_params)
from segmminterest_tpu_torch.models.segformerx import SegFormerX

SEED, RATE = 77, 0.3
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=6e-4, atol=6e-4)


def _case(rng, B, Lq, L1, L2, d, ff):
    """Inputs in flax layout (kernels (in, out)), as
    tests/test_layer_kernel.py:make_case draws them."""
    mk = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)  # noqa
    xq, x1, x2 = mk(B, Lq, d), mk(B, L1, d), mk(B, L2, d)
    qkv = [(mk(d, d), mk(d)) for _ in range(6)]
    ep = [mk(d, d), mk(d), mk(d) + 1.0, mk(d), mk(d, ff), mk(ff), mk(ff, d),
          mk(d), mk(d) + 1.0, mk(d)]
    masks = [rng.random((B, L)) < 0.9 for L in (Lq, L1, L2)]
    masks[1][:, 0] = True
    return xq, x1, x2, qkv, ep, masks


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _port_params(qkv, ep, grad=False, dtype=torch.float32):
    """nn.Linear layout; the LayerNorm parameters stay fp32."""
    pq = [(_t(w.T).to(dtype).requires_grad_(grad),
           _t(b).to(dtype).requires_grad_(grad)) for w, b in qkv]
    pe = [_t(p.T if p.ndim == 2 else p).to(
        torch.float32 if i in (2, 3, 8, 9) else dtype).requires_grad_(grad)
        for i, p in enumerate(ep)]
    return pq, pe


def _drop_kw(drop):
    return dict(dropout_rate=RATE if drop else 0.0, deterministic=not drop)


def _jax_call(xq, x1, x2, qkv, ep, masks, H, drop):
    return JLK.fused_layer_stream(
        xq, x1, x2, qkv, ep, *map(jnp.asarray, masks), num_heads=H,
        seed=jnp.asarray([SEED], jnp.int32), interpret=True,
        **_drop_kw(drop))


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("shape", [(8, 5, 8, 7, 4, 32, 48),
                                   (16, 16, 16, 8, 2, 64, 64),
                                   (6, 1, 8, 1, 2, 32, 32)])
def test_layer_plain_fwd_bwd_match_jax_interpret(rng, shape, drop):
    B, Lq, L1, L2, H, d, ff = shape
    xq, x1, x2, qkv, ep, masks = _case(rng, B, Lq, L1, L2, d, ff)
    g = rng.normal(size=(B, Lq, d)).astype(np.float32)
    jq = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in qkv)
    out, vjp = jax.vjp(
        lambda xq, x1, x2, qkv, ep: _jax_call(xq, x1, x2, qkv, ep, masks, H,
                                              drop),
        jnp.asarray(xq), jnp.asarray(x1), jnp.asarray(x2), jq,
        tuple(map(jnp.asarray, ep)))
    jdx = vjp(jnp.asarray(g))

    tx = [_t(a, True) for a in (xq, x1, x2)]
    pq, pe = _port_params(qkv, ep, grad=True)
    got = LK.fused_layer_stream(*tx, pq, pe, *map(_t, masks), num_heads=H,
                                seed=SEED, **_drop_kw(drop))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **FWD_TOL)
    got.backward(_t(g))
    for t, want in zip(tx, jdx[:3]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)
    for (w, b), (jw, jb) in zip(pq, jdx[3]):
        np.testing.assert_allclose(w.grad.numpy().T, np.asarray(jw),
                                   **GRAD_TOL)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(jb), **GRAD_TOL)
    for p, want in zip(pe, jdx[4]):
        gp = p.grad.numpy()
        np.testing.assert_allclose(gp.T if gp.ndim == 2 else gp,
                                   np.asarray(want), **GRAD_TOL)


def test_layer_plain_bf16_forward_matches_jax_interpret(rng):
    """bf16 compute, fp32 LayerNorm parameters, dropout on (the epilogue's
    masks divide by bf16(1 - rate) there)."""
    B, Lq, L1, L2, H, d, ff = 8, 12, 12, 9, 4, 64, 64
    xq, x1, x2, qkv, ep, masks = _case(rng, B, Lq, L1, L2, d, ff)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    jep = tuple(jnp.asarray(p) if i in (2, 3, 8, 9) else bf(p)
                for i, p in enumerate(ep))
    want = _jax_call(bf(xq), bf(x1), bf(x2),
                     tuple((bf(w), bf(b)) for w, b in qkv), jep, masks, H,
                     True)
    tb = lambda a: _t(a).to(torch.bfloat16)  # noqa: E731
    pq, pe = _port_params(qkv, ep, dtype=torch.bfloat16)
    got = LK.fused_layer_stream(tb(xq), tb(x1), tb(x2), pq, pe,
                                *map(_t, masks), num_heads=H, seed=SEED,
                                **_drop_kw(True))
    assert got.dtype == torch.bfloat16
    # two bf16 LayerNorms amplify a rounding that goes the other way (XLA
    # may also keep bf16 chains in fp32, which PyTorch rounds at each op);
    # measured: both sides lie ~0.005 (mean) from the fp32 result, and up to
    # 1.5 ulps of the largest output apart. Tolerance: 2 of those ulps.
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * ulp)


def test_epilogue_dropout_divides_in_the_compute_dtype(rng):
    """h / (1.0 - p) with h in bf16 and a weakly typed scalar divides by
    bf16(0.9) in the JAX package; the port's epilogue dropout gives the
    same bits, and not those of an fp32 divisor."""
    h = rng.normal(size=(4, 7, 64)).astype(np.float32)
    keep = rng.random(h.shape) > 0.1
    want = np.asarray(jnp.where(jnp.asarray(keep),
                                jnp.asarray(h, jnp.bfloat16) / (1.0 - 0.1),
                                0.0), np.float32)
    hb = _t(h).to(torch.bfloat16)
    got = LK._epi_drop(hb, _t(keep), 0.1).float().numpy()
    np.testing.assert_array_equal(got, want)
    f32 = torch.where(_t(keep), (hb.float() / 0.9).to(torch.bfloat16), 0)
    assert (f32.float().numpy() != want).any()


def test_gelu_and_layer_norm_match_jax(rng):
    x = (rng.normal(size=(5, 64)) * 3).astype(np.float32)
    np.testing.assert_allclose(LK.gelu_f32(_t(x)).numpy(),
                               np.asarray(JLK._gelu_f32(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(LK.gelu_grad_f32(_t(x)).numpy(),
                               np.asarray(JLK._gelu_grad_f32(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    # the polynomial erf is within 1.5e-7 of the exact GELU's
    np.testing.assert_allclose(
        LK.gelu_f32(_t(x)).numpy(),
        torch.nn.functional.gelu(_t(x)).numpy(), atol=1e-6)
    s, b = (rng.normal(size=64) + 1).astype(np.float32), \
        rng.normal(size=64).astype(np.float32)
    y, xhat, inv = LK.layer_norm_fwd(_t(x), _t(s), _t(b))
    jy, jxhat, jinv = JLK._ln_fwd(jnp.asarray(x), jnp.asarray(s),
                                  jnp.asarray(b))
    for a, w in ((y, jy), (xhat, jxhat), (inv, jinv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    dy = rng.normal(size=x.shape).astype(np.float32)
    np.testing.assert_allclose(
        LK.layer_norm_bwd(_t(dy), xhat, inv, _t(s)).numpy(),
        np.asarray(JLK._ln_bwd(jnp.asarray(dy), jxhat, jinv, jnp.asarray(s))),
        rtol=1e-5, atol=1e-5)


def test_layer_function_equals_autograd_of_plain_forward(rng):
    """K4's autograd.Function on CPU tensors (the plain backward, which
    follows _fl_bwd_kernel) equals torch.autograd through the plain forward,
    dropout on."""
    B, Lq, L1, L2, H, d, ff = 8, 6, 7, 5, 2, 32, 64
    xq, x1, x2, qkv, ep, masks = _case(rng, B, Lq, L1, L2, d, ff)
    g = _t(rng.normal(size=(B, Lq, d)).astype(np.float32))
    ms = list(map(_t, masks))

    def leaves():
        pq, pe = _port_params(qkv, ep, grad=True)
        return [_t(a, True) for a in (xq, x1, x2)], pq, pe

    tx, pq, pe = leaves()
    flat = lambda tx, pq, pe: tx + [t for p in pq for t in p] + pe  # noqa
    want = torch.autograd.grad(LK.layer_stream_plain(
        *tx, [t for p in pq for t in p], pe, *ms, H, 1 / math.sqrt(d // H),
        RATE, 5), flat(tx, pq, pe), g)
    tx, pq, pe = leaves()
    got = torch.autograd.grad(LK.fused_layer_stream(
        *tx, pq, pe, *ms, num_heads=H, seed=5, dropout_rate=RATE,
        deterministic=False), flat(tx, pq, pe), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _segformerx_case(rng, Lv=12, Lu=9, B=8, F=16):
    usr = rng.normal(size=(B, Lu, F)).astype(np.float32)
    vid = rng.normal(size=(B, Lv, F)).astype(np.float32)
    um = rng.random((B, Lu)) > 0.2
    um[:, 0] = True
    vm = rng.random((B, Lv)) > 0.2
    return (usr, um, vid, vm)


@pytest.mark.parametrize("flags", [dict(fused_attention=True),
                                   dict(fused_attention=False),
                                   dict(fused_attention=True,
                                        fuse_projections=True)],
                         ids=["fused", "unfused", "fuse_projections"])
def test_segformerx_fuse_layer_matches_flax(rng, flags):
    """SegFormerX with fuse_layer against the flax model (K4 through the
    interpreter there) whatever fused_attention and fuse_projections are:
    the composed parameter tree on both sides, equal states."""
    kw = dict(d_model=32, num_heads=4, num_layers=3, ff_dim=64,
              max_vid_len=12, max_usr_len=9, dropout=0.0, output_layers=[-1])
    args = _segformerx_case(rng)
    jm = JaxSegFormerX(fuse_layer=True, interpret=True, **flags, **kw)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"])
    composed = jax.tree.map(np.asarray, JaxSegFormerX(**kw).init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"])
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(composed)
    states, u = jm.apply({"params": params}, *map(jnp.asarray, args))
    tm = SegFormerX(**kw, feat_dim=16, fuse_layer=True, **flags)
    assert set(flax_to_state_dict(params, tm)) == set(tm.state_dict())
    load_flax_params(tm.eval(), params)
    with torch.no_grad():
        got, got_u = tm(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(states[-1]),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(u), rtol=2e-4,
                               atol=2e-5)


def test_fuse_layer_turns_whole_layer_remat_off(monkeypatch):
    """Under fuse_layer on the 'ours' path no layer is recomputed (K4
    saves only its inputs); under CrossAtt fuse_layer changes nothing and
    remat stays."""
    from segmminterest_tpu_torch.models import segformerx as SX
    calls = []
    real = SX._remat
    monkeypatch.setattr(SX, "_remat",
                        lambda fn, *a: calls.append(fn) or real(fn, *a))
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a) for a in _segformerx_case(rng)]
    kw = dict(d_model=32, num_heads=4, num_layers=3, ff_dim=32,
              max_vid_len=12, max_usr_len=9, feat_dim=16, remat=True,
              fused_attention=True)
    for ablation, want in (("ours", 0), ("noPos", 0), ("CrossAtt", 2)):
        calls.clear()
        m = SegFormerX(**kw, fuse_layer=True, ablation=ablation).train()
        assert m.remat_layers == (want > 0)
        states, _ = m(*args)
        states[-1].sum().backward()
        assert len(calls) == want, ablation
        if want == 0:
            assert all(layer.fuse_layer for layer in m.layers)
