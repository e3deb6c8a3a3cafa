"""K6, the weight-interleaved version 2 of the projection-fused attention
(``fused_proj_two_block_attention(..., version=2)`` and ``SEGMM_ATTN_V2``),
against the JAX package on the CPU: the plain forward and backward against
``jax.vjp`` of the JAX v2 Pallas kernel run through the interpreter, on the
same seeded inputs (the four stream shapes of a both/both layer scaled
down and a shape whose blocks are swapped, B=16 and B=6, padded rows,
dropout off and at rate 0.3); the alignment rules; the autograd.Function
against autograd through the plain forward; and a whole model under the
switch against the JAX model with the same weights.

With dropout on, the outputs agree only if the masks are the same bits: v2
draws one mask over (query, concatenated key) with salt h, K2 two masks
with salts 2h and 2h + 1. Tolerance 2e-5 (forward) and 1e-5 relative to
each gradient's largest entry (backward), as tests/test_torch_attention_bwd.py:
the same fp32 products summed in another order. The CUDA kernels are held
against these plain versions on the card by tests/test_torch_kernels.py and
chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.core import attention as JA
from segmminterest_tpu.models.interest import SegInterestModel as JaxModel
from segmminterest_tpu_torch.core import attention as A
from segmminterest_tpu_torch.models.convert import load_flax_params
from segmminterest_tpu_torch.models.interest import SegInterestModel

# the four stream shapes scaled down, then one with L1 unaligned and L2
# aligned, which v2 runs with its blocks swapped
SHAPES = [(8, 8, 12), (12, 8, 12), (8, 8, 1), (1, 8, 1), (5, 5, 8)]
H, DH, D = 2, 32, 64
SEED, RATE = 12345, 0.3
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_RTOL = 1e-5


def _masks(rng, B, Lq, L1, L2):
    def one(L, empty_row):
        m = np.zeros((B, L), bool)
        for i in range(B):
            m[i, :rng.integers(1, L + 1)] = True
        if empty_row:
            m[0] = False  # a fully padded row
        return m
    return one(Lq, True), one(L1, False), one(L2, Lq > 1)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _inputs(rng, B, shape):
    """xq, x1, x2 and the twelve parameters in flax layout (kernel (in,
    out), bias (out,)), fp32."""
    xs = [rng.normal(size=(B, L, D)).astype(np.float32) for L in shape]
    ws = []
    for _ in range(6):
        ws += [(rng.normal(size=(D, D)) / math.sqrt(D)).astype(np.float32),
               (0.1 * rng.normal(size=D)).astype(np.float32)]
    return xs, ws


def _linear(ws, grad=False):
    """The port's nn.Linear layout (out, in)."""
    return [_t(w.T if w.ndim == 2 else w, grad) for w in ws]


def _drop_kw(drop):
    return dict(dropout_rate=RATE if drop else 0.0, deterministic=not drop)


def _close_grads(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= GRAD_RTOL, f"gradient {i}: relative error {err:.3g}"


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("B", [16, 6])
@pytest.mark.parametrize("shape", SHAPES)
def test_k6_plain_fwd_bwd_match_jax_vjp(rng, shape, B, drop):
    xs, ws = _inputs(rng, B, shape)
    masks = _masks(rng, B, *shape)
    g = rng.normal(size=(B, shape[0], D)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: JA.fused_proj_two_block_attention(
        *a, *map(jnp.asarray, masks), num_heads=H,
        seed=jnp.asarray([SEED], jnp.int32), interpret=True, version=2,
        **_drop_kw(drop)), *map(jnp.asarray, xs + ws))
    tx, tw = [_t(x, True) for x in xs], _linear(ws, True)
    got = A.fused_proj_two_block_attention(*tx, *tw, *map(_t, masks),
                                           num_heads=H, seed=SEED, version=2,
                                           **_drop_kw(drop))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **FWD_TOL)
    got.backward(_t(g))
    grads = [t.grad.numpy() for t in tx] + [
        t.grad.numpy().T if t.ndim == 2 else t.grad.numpy() for t in tw]
    _close_grads(grads, vjp(jnp.asarray(g)))


def test_v2_dropout_mask_differs_from_k2(rng):
    """v2's one mask over the concatenated keys is not K2's two masks: with
    the same seed the two versions give different training outputs, while
    without dropout they compute the same function."""
    shape, B = (8, 8, 12), 8
    xs, ws = _inputs(rng, B, shape)
    args = [_t(x) for x in xs] + _linear(ws) + list(map(_t, _masks(
        rng, B, *shape)))
    evals = [A.fused_proj_two_block_attention(*args, num_heads=H, version=v)
             for v in (1, 2)]
    trains = [A.fused_proj_two_block_attention(*args, num_heads=H, seed=SEED,
                                               version=v, **_drop_kw(True))
              for v in (1, 2)]
    torch.testing.assert_close(evals[0], evals[1], rtol=2e-5, atol=2e-5)
    assert (trains[0] - trains[1]).abs().max() > 1e-2


def _call(args, **kw):
    """Output and gradients of every float input, through the wrapper."""
    leaves = [a.detach().requires_grad_(a.is_floating_point()) for a in args]
    out = A.fused_proj_two_block_attention(*leaves, num_heads=H, seed=SEED,
                                           **_drop_kw(True), **kw)
    grads = torch.autograd.grad(out.square().sum(),
                                [t for t in leaves if t.requires_grad])
    return (out,) + grads


def test_explicit_unaligned_v2_raises(rng):
    """An explicit version=2 where neither block is a multiple of 8 raises
    (attention.py:1105-1115); any other version raises too."""
    shape, B = (5, 7, 5), 4
    xs, ws = _inputs(rng, B, shape)
    args = [_t(x) for x in xs] + _linear(ws) + list(map(_t, _masks(
        rng, B, *shape)))
    with pytest.raises(ValueError, match="multiple of 8"):
        A.fused_proj_two_block_attention(*args, num_heads=H, version=2)
    with pytest.raises(ValueError, match="version"):
        A.fused_proj_two_block_attention(*args, num_heads=H, version=0)


@pytest.mark.parametrize("shape", [(5, 7, 5), (8, 8, 12), (5, 5, 8)],
                         ids=["unaligned", "aligned", "swapped"])
def test_switch_default_routes_as_jax(rng, monkeypatch, shape):
    """Under the switch the default version is 2 where a block is aligned
    (the explicit version=2, blocks swapped or not) and falls back to K2
    where neither is (version=1); without it the default is K2. Dropout is
    on, so the other route would differ by O(0.1): the outputs and every
    gradient must agree to 1e-6, the last-ulp differences the CPU's matmul
    may show between two calls on other buffers, and each call must take
    the plain version of the route it names."""
    B = 8
    xs, ws = _inputs(rng, B, shape)
    args = [_t(x) for x in xs] + _linear(ws) + list(map(_t, _masks(
        rng, B, *shape)))
    ran = []
    for name in ("proj_two_block_attention_plain",
                 "proj_two_block_attention_v2_plain"):
        fn = getattr(A, name)
        monkeypatch.setattr(A, name, lambda *a, _n=name, _f=fn:
                            ran.append(_n) or _f(*a))

    def same_route(kw_a, kw_b):
        ran.clear()
        got = _call(args, **kw_a)
        want = _call(args, **kw_b)
        assert ran[0] == ran[1]
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        return ran[0]

    monkeypatch.setattr(A, "ATTN_V2", True)
    v = 1 if shape[1] % 8 and shape[2] % 8 else 2
    assert same_route({}, dict(version=v)).endswith(
        "v2_plain" if v == 2 else "attention_plain")
    monkeypatch.setattr(A, "ATTN_V2", False)
    assert same_route({}, dict(version=1)) == \
        "proj_two_block_attention_plain"


def test_interleave_matches_jax(rng):
    """interleave_ws is the JAX package's _interleave_ws in nn.Linear
    layout, and the de-interleave takes each slot back out."""
    ws = [rng.normal(size=(D, D)).astype(np.float32) if i % 2 == 0
          else rng.normal(size=D).astype(np.float32) for i in range(8)]
    want = JA._interleave_ws(*map(jnp.asarray, ws), H)
    got = A.interleave_ws(*_linear(ws), H)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy(), b.T if b.ndim == 2 else b)
    tw = _linear(ws)
    for slot, (w, b) in ((0, (tw[0], tw[1])), (1, (tw[2], tw[3]))):
        assert torch.equal(A.deinterleave_w(got[0], H, slot), w)
        assert torch.equal(A.deinterleave_b(got[1], H, slot), b)
    assert not got[2].reshape(H, 2, DH, D)[:, 1].any()
    assert not got[4].reshape(H, 2, DH, D)[:, 0].any()


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
def test_k6_function_equals_autograd_of_plain_forward(rng, drop):
    """K6's autograd.Function on CPU tensors (the plain backward, which
    mirrors _fp2_bwd_kernel) equals torch.autograd through the plain
    forward."""
    B, shape = 8, (7, 8, 6)
    xs, ws = _inputs(rng, B, shape)
    arrays = xs + [w.T if w.ndim == 2 else w for w in ws]
    masks = tuple(map(_t, _masks(rng, B, *shape)))
    g = _t(rng.normal(size=(B, shape[0], D)).astype(np.float32))
    rate = RATE if drop else 0.0

    def grads(fn):
        leaves = [_t(a, True) for a in arrays]
        return torch.autograd.grad(fn(*leaves), leaves, g)

    want = grads(lambda *t: A.proj_two_block_attention_v2_plain(
        *t, *masks, H, 1 / math.sqrt(DH), rate, 7))
    got = grads(lambda *t: A.fused_proj_two_block_attention(
        *t, *masks, num_heads=H, seed=7, version=2, **_drop_kw(drop)))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_interest_model_under_switch_matches_jax(rng, monkeypatch):
    """A small both/both SegInterestModel on the K2 route, eval mode, under
    the switch (every stream on K6's plain version, the single-query user
    stream of the ID backbone included) against the JAX model with the same
    weights, its fuse_qkv streams through the v2 Pallas kernel in interpret
    mode. Tolerance 1e-4 on logits, as tests/test_torch_model.py."""
    B, F, LU = 2, 48, 12
    kw = dict(d_model=32, num_heads=4, num_layers=2, ff_dim=32, n_users=20,
              n_items=30, fusion_heads=2, fused_attention=True,
              fuse_qkv=True)
    usr_img = rng.normal(size=(B, LU, F)).astype(np.float32)
    vid_img = rng.normal(size=(B, 40, F)).astype(np.float32)
    um, vm = np.zeros((B, LU), bool), np.zeros((B, 40), bool)
    for i in range(B):
        um[i, :rng.integers(1, LU + 1)] = True
        vm[i, :rng.integers(1, 41)] = True
    args = (usr_img, rng.integers(1, 21, size=B).astype(np.int32), um,
            vid_img, rng.integers(1, 31, size=B).astype(np.int32), vm)
    monkeypatch.setattr(JA, "ATTN_V2", True)
    monkeypatch.setattr(A, "ATTN_V2", True)
    jm = JaxModel(**kw, interpret=True)
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"])
    want = np.asarray(jm.apply({"params": params}, *map(jnp.asarray, args)))
    tm = load_flax_params(SegInterestModel(**kw, feat_dim=F).eval(), params)
    calls = []
    plain = A.proj_two_block_attention_v2_plain
    monkeypatch.setattr(A, "proj_two_block_attention_v2_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, args)).numpy()
    # 2 backbones x 1 run layer x 2 streams, the (1, 40, 1) stream included
    assert sorted(s[1] for s in calls) == [1, 12, 40, 40]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
