"""K3, the single-block masked attention of the CrossAtt and SelfAtt
ablations (segmminterest_tpu_torch/core/attention.py fused_masked_attention),
forward and backward, against the JAX Pallas kernel run through the
interpreter and its ``jax.vjp``, on the same seeded inputs: the (Lq, Lk)
stream shapes of both ablations scaled down, H=2 heads of 32 (and one case
of 16), padded and fully padded rows, B=16 (two batch tiles of 8) and B=6
(one tile of 6), with dropout off and with rate 0.3 and a nonzero seed.

With dropout on, the forward outputs agree to the fp32 tolerance only if
the masks are the same bits: one differing keep bit moves an output by
O(0.1). Tolerance 2e-5 (forward) and 1e-5 relative to each gradient's
largest entry (backward): the same fp32 products summed in another order,
as tests/test_torch_attention_bwd.py holds K1 and K2. The CUDA kernels are
held against these plain versions on the card by tests/test_torch_kernels.py
and chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.core.attention import \
    fused_masked_attention as jax_k3
from segmminterest_tpu_torch.core import attention as A

SHAPES = [(8, 12), (12, 8), (8, 1), (1, 8), (8, 8), (12, 12), (1, 1)]
H = 2
SEED, RATE = 12345, 0.3
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_RTOL = 1e-5


def _mask(rng, B, L, empty_row):
    m = np.zeros((B, L), bool)
    for i in range(B):
        m[i, :rng.integers(1, L + 1)] = True
    if empty_row and L > 1:
        m[0] = False  # a fully padded row
    return m


def _inputs(rng, B, Lq, Lk, D):
    q = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Lk, H, D)).astype(np.float32)
    v = rng.normal(size=(B, Lk, H, D)).astype(np.float32)
    # a padded query row, and (where there is more than one key) a padded
    # key row of another batch row
    mq, mk = _mask(rng, B, Lq, True), _mask(rng, B, Lk, False)
    if Lk > 1:
        mk[1] = False
    return (q, k, v), (mq, mk)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _drop_kw(drop):
    return dict(dropout_rate=RATE if drop else 0.0, deterministic=not drop)


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("B", [16, 6])
@pytest.mark.parametrize("shape,D", [(s, 32) for s in SHAPES]
                         + [((12, 8), 16)])
def test_k3_plain_fwd_bwd_match_jax_vjp(rng, shape, D, B, drop):
    Lq, Lk = shape
    arrays, masks = _inputs(rng, B, Lq, Lk, D)
    g = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_k3(
        *a, *map(jnp.asarray, masks), seed=jnp.asarray([SEED], jnp.int32),
        interpret=True, **_drop_kw(drop)), *map(jnp.asarray, arrays))
    ts = [_t(a, True) for a in arrays]
    got = A.fused_masked_attention(*ts, *map(_t, masks), seed=SEED,
                                   **_drop_kw(drop))
    assert got.dtype == torch.float32 and got.shape == (B, Lq, H, D)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **FWD_TOL)
    got.backward(_t(g))
    for i, (a, b) in enumerate(zip([t.grad.numpy() for t in ts],
                                   vjp(jnp.asarray(g)))):
        b = np.asarray(b)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= GRAD_RTOL, f"gradient {i}: relative error {err:.3g}"


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
def test_k3_function_equals_autograd_of_plain_forward(rng, drop):
    """K3's autograd.Function on CPU tensors (the plain backward, which
    mirrors _bwd_kernel) equals torch.autograd through the plain forward."""
    B, Lq, Lk, D = 8, 7, 5, 32
    arrays, masks = _inputs(rng, B, Lq, Lk, D)
    masks = tuple(map(_t, masks))
    g = _t(rng.normal(size=(B, Lq, H, D)).astype(np.float32))
    scale, rate = 1 / math.sqrt(D), RATE if drop else 0.0

    def grads(fn):
        leaves = [_t(a, True) for a in arrays]
        return torch.autograd.grad(fn(*leaves), leaves, g)

    want = grads(lambda *t: A.masked_attention_plain(*t, *masks, scale,
                                                     rate, 7))
    got = grads(lambda *t: A.fused_masked_attention(*t, *masks, seed=7,
                                                    **_drop_kw(drop)))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_k3_padded_rows_and_default_scale(rng):
    """A fully padded query row is the uniform softmax over all keys (not
    zero), a masked logit that dropout drops becomes 0 and takes part in
    the softmax, and the default scale is 1/sqrt(Dv) (attention.py:340)."""
    (q, k, v), (mq, mk) = _inputs(rng, 2, 5, 4, 32)
    mq[0] = False
    got = A.fused_masked_attention(*map(_t, (q, k, v, mq, mk)))
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(
        v[0].mean(0), got[0].shape), atol=1e-6)
    want = A.masked_attention_plain(*map(_t, (q, k, v, mq, mk)),
                                    1 / math.sqrt(32))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # all keys of row 1 masked, dropout at 0.5: dropped logits are 0 and
    # the kept ones -10000 / (1 - rate), so the row attends only the dropped
    mq[:], mk[1] = True, False
    keep = A.dropout_keep(2, H, 5, 4, 3, 0, 0.5, "cpu", salt_stride=1)[1]
    out = A.fused_masked_attention(*map(_t, (q, k, v, mq, mk)), seed=3,
                                   dropout_rate=0.5, deterministic=False)
    w = (~keep).float()
    w = w / w.sum(-1, keepdim=True)
    want = torch.einsum("hqk,khd->qhd", w, _t(v[1]))
    torch.testing.assert_close(out[1], want, rtol=1e-5, atol=1e-6)


def test_dropout_keep_salts():
    """K3's mask is salt h (stride 1): head h of K3 draws K1's block-0 bits
    of head h/2 for even h, and K1/K2's bits with stride 2 are unchanged
    (checked against the JAX package's interpret-mode hash)."""
    from segmminterest_tpu.core.attention import _dropout_keep

    B, Hh, Lq, Lk = 16, 4, 6, 9
    k1 = A.dropout_keep(B, Hh, Lq, Lk, SEED, 1, RATE, "cpu")
    k3 = A.dropout_keep(B, Hh, Lq, Lk, SEED, 0, RATE, "cpu", salt_stride=1)
    for h in range(Hh):
        for tile in range(2):
            rows = slice(8 * tile, 8 * tile + 8)
            seed_val = jnp.asarray(SEED + tile, jnp.int32)
            want1 = np.asarray(_dropout_keep((8, Lq, Lk), RATE,
                                             interpret=True,
                                             seed_val=seed_val,
                                             salt=2 * h + 1))
            want3 = np.asarray(_dropout_keep((8, Lq, Lk), RATE,
                                             interpret=True,
                                             seed_val=seed_val, salt=h))
            np.testing.assert_array_equal(k1[rows, h].numpy(), want1)
            np.testing.assert_array_equal(k3[rows, h].numpy(), want3)
    k1_block0 = A.dropout_keep(B, Hh, Lq, Lk, SEED, 0, RATE, "cpu")
    torch.testing.assert_close(k3[:, 2], k1_block0[:, 1])
    assert abs(1 - k3.float().mean().item() - RATE) < 0.05


def test_k3_cpu_launches_nothing_and_guards(rng):
    """The plain versions run only because the tensors lie on the CPU: no
    kernel is counted; a rate outside [0, 1) and a device that is neither
    CPU nor CUDA raise."""
    arrays, masks = _inputs(rng, 4, 5, 3, 16)
    before = dict(A.LAUNCHES)
    ts = [_t(a, True) for a in arrays]
    A.fused_masked_attention(*ts, *map(_t, masks), dropout_rate=0.1,
                             deterministic=False, seed=1).sum().backward()
    assert A.LAUNCHES == before
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError):
            A.fused_masked_attention(*map(_t, arrays + masks),
                                     dropout_rate=bad, deterministic=False)
    meta = [torch.empty(a.shape, device="meta") for a in arrays]
    with pytest.raises(ValueError):
        A.fused_masked_attention(*meta, *map(_t, masks))


def _split_bf16(x):
    """x = hi + lo: hi = bf16(x), lo = bf16(x - hi), both returned in fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("shape", [(40, 100), (100, 40)])
def test_k3b_bf16_split_products_match_fp32(rng, shape, drop):
    """K3b's bf16 body on the tensor cores takes q, k, v and g as the bf16
    inputs they are, but p and dl are fp32: it splits each into two bf16
    halves and sums both products in fp32, and forms dl from p's halves
    (masked_attention_bwd.cu). The same arithmetic in torch stays within
    1e-4 of the fp32 backward (_masked_bwd_f32) before the output cast, at
    CrossAtt's two feature stream shapes: the ground for keeping the bf16
    gradient tolerance that holds the kernel against its plain version."""
    B, (Lq, Lk), D = 16, shape, 32
    arrays, masks = _inputs(rng, B, Lq, Lk, D)
    g = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    # bf16 inputs, held in fp32
    q, k, v, g = (_t(a).to(torch.bfloat16).float() for a in arrays + (g,))
    mq, mk = map(_t, masks)
    scale, rate = 1 / math.sqrt(D), RATE if drop else 0.0
    want = A._masked_bwd_f32(q, k, v, mq, mk, g, scale, rate, SEED)

    p, pair, keep = A._masked_probs(q, k, mq, mk, scale, rate, SEED)
    p = sum(_split_bf16(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    dl = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    if keep is not None:
        dl = torch.where(keep, dl / A.keep_divisor(rate), 0.0)
    dl = torch.where(pair, dl, 0.0)

    def split_product(spec, x, y):
        hi, lo = _split_bf16(x)
        return torch.einsum(spec, hi, y) + torch.einsum(spec, lo, y)

    got = (split_product("bhqk,bkhd->bqhd", dl, k),
           split_product("bhqk,bqhd->bkhd", dl, q),
           split_product("bhqk,bqhd->bkhd", p, g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= 1e-4, f"{name}: relative error {err:.3g}"
    # one rounding of p and dl instead of the split misses the bar by far
    one = torch.einsum("bhqk,bkhd->bqhd", dl.to(torch.bfloat16).float(), k)
    assert ((one - want[0]).abs().max() / want[0].abs().max()).item() > 1e-4


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
@pytest.mark.parametrize("shape", [(40, 100), (100, 40)])
def test_k3b_3xtf32_products_match_fp32(rng, shape, drop, monkeypatch):
    """fp32 K3b runs every product (q k^T, g v^T, p^T g, dl k, dl^T q) on
    the TF32 tensor cores in 3xTF32 (tf32_attention.cuh). The fp32
    backward (_masked_bwd_f32) with each product so formed stays within
    1e-5 of itself in fp32 at CrossAtt's two feature stream shapes, while
    one TF32 rounding of the operands misses 1e-4: the reason for three
    passes, and the ground for holding the kernel to its plain version at
    1e-4."""
    B, (Lq, Lk), D = 16, shape, 32
    arrays, masks = _inputs(rng, B, Lq, Lk, D)
    g = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    args = (*map(_t, arrays + masks + (g,)), 1 / math.sqrt(D),
            RATE if drop else 0.0, SEED)
    want = A._masked_bwd_f32(*args)
    monkeypatch.setattr(torch, "einsum", _tf32_einsum(3))
    got = A._masked_bwd_f32(*args)
    monkeypatch.setattr(torch, "einsum", _tf32_einsum(1))
    one = A._masked_bwd_f32(*args)
    monkeypatch.undo()

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert rel(a, b) <= 1e-5, f"{name}: relative error {rel(a, b):.3g}"
    assert max(rel(a, b) for a, b in zip(one, want)) > 1e-4
