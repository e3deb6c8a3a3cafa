"""The backward of K1 and K2 and their dropout mask
(segmminterest_tpu_torch/core/attention.py) against ``jax.vjp`` of the JAX
Pallas kernels run through the interpreter, on the same seeded inputs: the
four stream shapes of a both/both layer scaled down, H=2 heads of 32,
padded query and key rows, B=16 (two batch tiles of 8) and B=6 (one tile of
6), with dropout off and with rate 0.3 and a nonzero seed.

With dropout on, the forward outputs agree to the fp32 tolerance only if
the masks are the same bits: a single differing keep bit moves an output by
O(0.1). Tolerance 2e-5 (forward) and 1e-5 relative to each gradient's
largest entry (backward): the same fp32 products summed in another order,
as tests/test_fused_attention.py holds the TPU kernels to their reference.
The kernels themselves are held against these plain versions on the card
by tests/test_torch_kernels.py and chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.core.attention import (fused_proj_two_block_attention
                                              as jax_k2,
                                              fused_two_block_attention
                                              as jax_k1)
from segmminterest_tpu_torch.core import attention as A

SHAPES = [(8, 8, 12), (12, 8, 12), (8, 8, 1), (1, 8, 1)]
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


def _close_grads(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= GRAD_RTOL, f"gradient {i}: relative error {err:.3g}"


def _drop_kw(drop):
    return dict(dropout_rate=RATE if drop else 0.0, deterministic=not drop)


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("B", [16, 6])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_plain_fwd_bwd_match_jax_vjp(rng, shape, B, drop):
    Lq, L1, L2 = shape
    arrays = [rng.normal(size=(B, L, H, DH)).astype(np.float32)
              for L in (Lq, Lq, L1, L2, L1, L2)]
    masks = _masks(rng, B, Lq, L1, L2)
    g = rng.normal(size=(B, Lq, H, DH)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_k1(
        *a, *map(jnp.asarray, masks), seed=jnp.asarray([SEED], jnp.int32),
        interpret=True, **_drop_kw(drop)), *map(jnp.asarray, arrays))
    ts = [_t(a, True) for a in arrays]
    got = A.fused_two_block_attention(*ts, *map(_t, masks), seed=SEED,
                                      **_drop_kw(drop))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **FWD_TOL)
    got.backward(_t(g))
    _close_grads([t.grad.numpy() for t in ts], vjp(jnp.asarray(g)))


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("B", [16, 6])
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_plain_fwd_bwd_match_jax_vjp(rng, shape, B, drop):
    Lq, L1, L2 = shape
    xs = [rng.normal(size=(B, L, D)).astype(np.float32) for L in shape]
    ws = []
    for _ in range(6):  # flax layout: kernel (in, out), bias (out,)
        ws += [(rng.normal(size=(D, D)) / math.sqrt(D)).astype(np.float32),
               (0.1 * rng.normal(size=D)).astype(np.float32)]
    masks = _masks(rng, B, Lq, L1, L2)
    g = rng.normal(size=(B, Lq, D)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_k2(
        *a, *map(jnp.asarray, masks), num_heads=H,
        seed=jnp.asarray([SEED], jnp.int32), interpret=True, version=1,
        **_drop_kw(drop)), *map(jnp.asarray, xs + ws))
    tx = [_t(x, True) for x in xs]
    # the port takes nn.Linear weights (out, in)
    tw = [_t(w.T if w.ndim == 2 else w, True) for w in ws]
    got = A.fused_proj_two_block_attention(*tx, *tw, *map(_t, masks),
                                           num_heads=H, seed=SEED,
                                           **_drop_kw(drop))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **FWD_TOL)
    got.backward(_t(g))
    grads = [t.grad.numpy() for t in tx] + [
        t.grad.numpy().T if t.ndim == 2 else t.grad.numpy() for t in tw]
    _close_grads(grads, vjp(jnp.asarray(g)))


def _autograd_through_plain(fn, leaves, g):
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
def test_k1_function_equals_autograd_of_plain_forward(rng, drop):
    """K1's autograd.Function on CPU tensors (the plain backward, which
    mirrors _bwd2_kernel) equals torch.autograd through the plain forward."""
    B, Lq, L1, L2 = 8, 7, 5, 6
    arrays = [rng.normal(size=(B, L, H, DH)).astype(np.float32)
              for L in (Lq, Lq, L1, L2, L1, L2)]
    masks = tuple(map(_t, _masks(rng, B, Lq, L1, L2)))
    g = _t(rng.normal(size=(B, Lq, H, DH)).astype(np.float32))
    scale, rate = 1 / math.sqrt(DH), RATE if drop else 0.0
    want = _autograd_through_plain(
        lambda *t: A.two_block_attention_plain(*t, *masks, scale, rate, 7),
        [_t(a, True) for a in arrays], g)
    got = _autograd_through_plain(
        lambda *t: A.fused_two_block_attention(
            *t, *masks, seed=7, **_drop_kw(drop)),
        [_t(a, True) for a in arrays], g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
def test_k2_function_equals_autograd_of_plain_forward(rng, drop):
    B, Lq, L1, L2 = 8, 7, 5, 6
    arrays = [rng.normal(size=(B, L, D)).astype(np.float32)
              for L in (Lq, L1, L2)]
    for _ in range(6):
        arrays += [(rng.normal(size=(D, D)) / 8).astype(np.float32),
                   (0.1 * rng.normal(size=D)).astype(np.float32)]
    masks = tuple(map(_t, _masks(rng, B, Lq, L1, L2)))
    g = _t(rng.normal(size=(B, Lq, D)).astype(np.float32))
    scale, rate = 1 / math.sqrt(DH), RATE if drop else 0.0
    want = _autograd_through_plain(
        lambda *t: A.proj_two_block_attention_plain(*t, *masks, H, scale,
                                                    rate, 7),
        [_t(a, True) for a in arrays], g)
    got = _autograd_through_plain(
        lambda *t: A.fused_proj_two_block_attention(
            *t, *masks, num_heads=H, seed=7, **_drop_kw(drop)),
        [_t(a, True) for a in arrays], g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_dropout_statistics():
    """About `rate` of the logits are dropped; the same seed gives the same
    mask, another seed another one; batch tiles of 8 rows are seeded
    seed + tile, so row r of tile t+1 under seed s equals row r of tile t
    under seed s + 1; the two blocks and the heads draw different bits."""
    B, Lq, Lk = 16, 40, 100
    keep = A.dropout_keep(B, H, Lq, Lk, SEED, 0, RATE, "cpu")
    assert keep.shape == (B, H, Lq, Lk)
    assert abs(1 - keep.float().mean().item() - RATE) < 0.01
    torch.testing.assert_close(
        keep, A.dropout_keep(B, H, Lq, Lk, SEED, 0, RATE, "cpu"))
    other = A.dropout_keep(B, H, Lq, Lk, SEED + 1, 0, RATE, "cpu")
    assert (other != keep).float().mean() > 0.2
    torch.testing.assert_close(keep[8:], other[:8])
    assert (A.dropout_keep(B, H, Lq, Lk, SEED, 1, RATE, "cpu")
            != keep).float().mean() > 0.2
    assert (keep[:, 0] != keep[:, 1]).float().mean() > 0.2
    # one batch tile of all 6 rows when B % 8 != 0
    assert A.pick_block_b(6) == 6 and A.pick_block_b(16) == 8


def test_dropout_gradient_matches_finite_difference(rng):
    """A central finite difference through the same seed matches the
    backward, so forward and backward draw the same mask (as
    tests/test_fused_attention.py:428-459 checks the TPU kernel)."""
    B, Lq, L1, L2 = 8, 5, 8, 7
    xs = [(rng.normal(size=(B, L, D)) * 0.3).astype(np.float32)
          for L in (Lq, L1, L2)]
    ws = []
    for _ in range(6):
        ws += [(rng.normal(size=(D, D)) * 0.3).astype(np.float32),
               (rng.normal(size=D) * 0.3).astype(np.float32)]
    masks = tuple(map(_t, _masks(rng, B, Lq, L1, L2)))
    fixed = [_t(a) for a in xs[1:] + ws]

    def f(xq):
        out = A.fused_proj_two_block_attention(
            xq, *fixed, *masks, num_heads=H, seed=3, dropout_rate=RATE,
            deterministic=False)
        return (out.double() ** 2).sum()

    xq = _t(xs[0], True)
    (grad,) = torch.autograd.grad(f(xq), [xq])
    v = torch.from_numpy(np.random.default_rng(5).normal(
        size=xq.shape).astype(np.float32))
    eps = 1e-2
    with torch.no_grad():
        fd = (f(xq + eps * v) - f(xq - eps * v)) / (2 * eps)
    np.testing.assert_allclose(float((grad * v).sum()), float(fd), rtol=5e-3)


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to nearest on the fp32
    bits, ties away from zero, the low 13 mantissa bits cleared."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(
        torch.float32)


def _tf32_einsum(passes):
    """torch.einsum of two operands on the TF32 tensor cores: one product of
    the rounded operands, or (3 passes, 3xTF32) big = tf32(x) and small =
    tf32(x - big), big.small + small.big + big.big."""
    plain = torch.einsum

    def einsum(spec, a, b):
        a_big, b_big = _tf32(a), _tf32(b)
        if passes == 1:
            return plain(spec, a_big, b_big)
        return (plain(spec, a_big, _tf32(b - b_big))
                + plain(spec, _tf32(a - a_big), b_big)
                + plain(spec, a_big, b_big))
    return einsum


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("shape", [(40, 40, 100), (100, 40, 100),
                                   (40, 40, 1), (1, 40, 1)])
def test_k1b_3xtf32_products_match_fp32(rng, shape, drop, monkeypatch):
    """fp32 K1b runs every product (q k^T, g v^T, p^T g, dl k, dl^T q) on
    the TF32 tensor cores in 3xTF32 (tf32_attention.cuh). The fp32
    backward with each product so formed stays within 1e-5 of itself in
    fp32 at the four stream shapes of a both/both layer, while one TF32
    rounding of the operands misses 1e-4: the reason for three passes, and
    the ground for holding the kernel to its plain version at 1e-4."""
    B, (Lq, L1, L2) = 16, shape
    arrays = [_t(rng.normal(size=(B, L, H, DH)).astype(np.float32))
              for L in (Lq, Lq, L1, L2, L1, L2)]
    masks = tuple(map(_t, _masks(rng, B, Lq, L1, L2)))
    g = _t(rng.normal(size=(B, Lq, H, DH)).astype(np.float32))
    args = (*arrays, *masks, g, 1 / math.sqrt(DH), RATE if drop else 0.0,
            SEED)
    want = A._joint_bwd_plain(*args)
    monkeypatch.setattr(torch, "einsum", _tf32_einsum(3))
    got = A._joint_bwd_plain(*args)
    monkeypatch.setattr(torch, "einsum", _tf32_einsum(1))
    one = A._joint_bwd_plain(*args)
    monkeypatch.undo()

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()
    for name, a, b in zip(("dq1", "dq2", "dk1", "dk2", "dv1", "dv2"), got,
                          want):
        assert rel(a, b) <= 1e-5, f"{name}: relative error {rel(a, b):.3g}"
    assert max(rel(a, b) for a, b in zip(one, want)) > 1e-4
