"""The dual-stream attention K5 (segmminterest_tpu_torch/core/dual_kernel.py)
against the JAX Pallas kernel run through the interpreter
(segmminterest_tpu/core/dual_kernel.py, as tests/test_dual_kernel.py runs
it), on the same seeded inputs: forward and every gradient, dropout off and
on; and SegFormerX with ``fuse_dual`` against the flax model through
models/convert.py.

With dropout on the outputs agree only if both sides draw the same mask
bits, the user stream salted from head H. Tolerances as the JAX tests use
for this kernel: 2e-5 forward, 5e-4 gradients (fp32, the same products
summed in another order). bf16: a few ulps (one ulp is 2^-8 relative; a
projection that rounds the other way moves an output by an ulp or two).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.core.dual_kernel import \
    fused_dual_stream_attention as jax_k5
from segmminterest_tpu.models.segformerx import SegFormerX as JaxSegFormerX
from segmminterest_tpu_torch.core import attention as A
from segmminterest_tpu_torch.core import dual_kernel as K5
from segmminterest_tpu_torch.models.convert import (flax_to_state_dict,
                                                    load_flax_params)
from segmminterest_tpu_torch.models.segformerx import SegFormerX

SEED, RATE = 4321, 0.3
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _case(rng, B, Lv, Lu, d):
    vid = rng.normal(size=(B, Lv, d)).astype(np.float32)
    usr = rng.normal(size=(B, Lu, d)).astype(np.float32)
    mv, mu = np.zeros((B, Lv), bool), np.zeros((B, Lu), bool)
    for i in range(B):
        mv[i, :rng.integers(1, Lv + 1)] = True
        mu[i, :rng.integers(1, Lu + 1)] = True
    mu[0] = False  # a fully padded user row
    # flax layout: kernel (in, out), bias (out,)
    ws = [[(rng.normal(size=(d, d)) * 0.15).astype(np.float32),
           (rng.normal(size=d) * 0.05).astype(np.float32)] for _ in range(12)]
    return vid, usr, mv, mu, ws[:6], ws[6:]


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _port_ws(pairs, grad=False):
    """nn.Linear layout: (out, in)."""
    return [(_t(w.T, grad), _t(b, grad)) for w, b in pairs]


def _drop_kw(drop):
    return dict(dropout_rate=RATE if drop else 0.0, deterministic=not drop)


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("B,Lv,Lu,d,H", [(4, 8, 7, 32, 2), (8, 12, 9, 64, 4),
                                         (6, 5, 11, 64, 2)])
def test_dual_plain_fwd_bwd_match_jax_interpret(rng, B, Lv, Lu, d, H, drop):
    vid, usr, mv, mu, wsa, wsb = _case(rng, B, Lv, Lu, d)
    gv = rng.normal(size=(B, Lv, d)).astype(np.float32)
    gu = rng.normal(size=(B, Lu, d)).astype(np.float32)
    seed = jnp.asarray([SEED], jnp.int32)

    def jf(vid, usr, wsa, wsb):
        return jax_k5(vid, usr, wsa, wsb, jnp.asarray(mv), jnp.asarray(mu),
                      num_heads=H, seed=seed, interpret=True, **_drop_kw(drop))
    jw = lambda ws: tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in ws)
    (jov, jou), vjp = jax.vjp(jf, jnp.asarray(vid), jnp.asarray(usr),
                              jw(wsa), jw(wsb))
    jdv, jdu, jdwa, jdwb = vjp((jnp.asarray(gv), jnp.asarray(gu)))

    tv, tu = _t(vid, True), _t(usr, True)
    pa, pb = _port_ws(wsa, True), _port_ws(wsb, True)
    ov, ou = K5.fused_dual_stream_attention(
        tv, tu, pa, pb, _t(mv), _t(mu), num_heads=H, seed=SEED,
        **_drop_kw(drop))
    np.testing.assert_allclose(ov.detach().numpy(), np.asarray(jov),
                               **FWD_TOL)
    np.testing.assert_allclose(ou.detach().numpy(), np.asarray(jou),
                               **FWD_TOL)
    torch.autograd.backward((ov, ou), (_t(gv), _t(gu)))
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jdv), **GRAD_TOL)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(jdu), **GRAD_TOL)
    for port, jax_g in ((pa, jdwa), (pb, jdwb)):
        for (w, b), (jw_, jb) in zip(port, jax_g):
            np.testing.assert_allclose(w.grad.numpy().T, np.asarray(jw_),
                                       **GRAD_TOL)
            np.testing.assert_allclose(b.grad.numpy(), np.asarray(jb),
                                       **GRAD_TOL)


def test_dual_plain_bf16_forward_matches_jax_interpret(rng):
    B, Lv, Lu, d, H = 8, 12, 9, 64, 4
    vid, usr, mv, mu, wsa, wsb = _case(rng, B, Lv, Lu, d)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    jov, jou = jax_k5(bf(vid), bf(usr),
                      tuple((bf(w), bf(b)) for w, b in wsa),
                      tuple((bf(w), bf(b)) for w, b in wsb),
                      jnp.asarray(mv), jnp.asarray(mu), num_heads=H,
                      seed=jnp.asarray([SEED], jnp.int32), interpret=True,
                      **_drop_kw(True))
    tb = lambda a: _t(a).to(torch.bfloat16)
    ov, ou = K5.fused_dual_stream_attention(
        tb(vid), tb(usr), [(tb(w.T), tb(b)) for w, b in wsa],
        [(tb(w.T), tb(b)) for w, b in wsb], _t(mv), _t(mu), num_heads=H,
        seed=SEED, **_drop_kw(True))
    assert ov.dtype == ou.dtype == torch.bfloat16
    for got, want in ((ov, jov), (ou, jou)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **BF16_TOL)


def test_dual_plain_is_two_k2_calls_with_offset_salts(rng):
    """The video stream is K2 with the layer's seed; the user stream K2
    with the same seed and salts from head H, which differ from the video
    stream's: the same inputs on both streams give other outputs."""
    B, L, d, H = 8, 6, 32, 2
    vid, _, mv, _, wsa, _ = _case(rng, B, L, L, d)
    x, m = _t(vid), _t(np.ones_like(mv))
    ws = [t for p in _port_ws(wsa) for t in p]
    ov, ou = K5.dual_stream_attention_plain(x, x, ws, ws, m, m, H,
                                            1 / math.sqrt(d // H), 0.5, 11)
    k2 = A.proj_two_block_attention_plain(x, x, x, *ws, m, m, m, H,
                                          1 / math.sqrt(d // H), 0.5, 11)
    torch.testing.assert_close(ov, k2, rtol=0, atol=0)
    assert not torch.allclose(ov, ou)
    keep = A.dropout_keep(B, H, L, L, 11, 1, 0.5, "cpu", head_offset=H)
    torch.testing.assert_close(
        keep, A.dropout_keep(B, 2 * H, L, L, 11, 1, 0.5, "cpu")[:, H:])


def test_dual_function_equals_autograd_of_plain_forward(rng):
    """K5's autograd.Function on CPU tensors (the plain backward, which
    mirrors _ds_bwd_kernel) equals torch.autograd through the plain
    forward, dropout on."""
    B, Lv, Lu, d, H = 8, 7, 5, 32, 2
    vid, usr, mv, mu, wsa, wsb = _case(rng, B, Lv, Lu, d)
    g = (_t(rng.normal(size=(B, Lv, d)).astype(np.float32)),
         _t(rng.normal(size=(B, Lu, d)).astype(np.float32)))
    scale = 1 / math.sqrt(d // H)

    def leaves():
        return [_t(vid, True), _t(usr, True)] + [
            t for p in _port_ws(wsa + wsb, True) for t in p]

    a = leaves()
    want = torch.autograd.grad(K5.dual_stream_attention_plain(
        a[0], a[1], a[2:14], a[14:], _t(mv), _t(mu), H, scale, RATE, 9), a, g)
    b = leaves()
    pairs = lambda ts: [(ts[i], ts[i + 1]) for i in range(0, len(ts), 2)]
    got = torch.autograd.grad(K5.fused_dual_stream_attention(
        b[0], b[1], pairs(b[2:14]), pairs(b[14:]), _t(mv), _t(mu),
        num_heads=H, seed=9, dropout_rate=RATE, deterministic=False), b, g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lengths", [(12, 9), (12, 1)], ids=["dual", "lq1"])
def test_segformerx_fuse_dual_matches_flax(rng, lengths):
    """SegFormerX with fuse_dual against the flax model (the kernels run
    through the interpreter there): the parameter trees are equal, and so
    are the states. (12, 1) is the single-query user stream, which both
    sides send through two K2 calls."""
    Lv, Lu = lengths
    kw = dict(d_model=32, num_heads=4, num_layers=3, ff_dim=32,
              max_vid_len=Lv, max_usr_len=Lu, dropout=0.0,
              output_layers=[-1])
    B, F = 8, 16
    usr = rng.normal(size=(B, Lu, F)).astype(np.float32)
    vid = rng.normal(size=(B, Lv, F)).astype(np.float32)
    um = rng.random((B, Lu)) > 0.2
    um[:, 0] = True
    vm = rng.random((B, Lv)) > 0.2
    args = (usr, um, vid, vm)
    jm = JaxSegFormerX(fused_attention=True, fuse_dual=True, interpret=True,
                       **kw)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"])
    qkv_params = jax.tree.map(np.asarray, JaxSegFormerX(
        fused_attention=True, fuse_qkv=True, **kw).init(
            jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"])
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(qkv_params)
    states, u = jm.apply({"params": params}, *map(jnp.asarray, args))
    tm = SegFormerX(**kw, feat_dim=F, fused_attention=True, fuse_dual=True)
    assert set(flax_to_state_dict(params, tm)) == set(tm.state_dict())
    load_flax_params(tm.eval(), params)
    before = dict(A.LAUNCHES)
    with torch.no_grad():
        got, got_u = tm(*map(torch.from_numpy, args))
    assert A.LAUNCHES == before  # plain versions on the CPU
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(states[-1]),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(u), rtol=2e-4,
                               atol=2e-5)
