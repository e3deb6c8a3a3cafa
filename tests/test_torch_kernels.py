"""K1, K2 and K3, forward and backward (K1b, K2b, K7b and K3b), on the card
against their plain PyTorch versions, on the same seeded inputs, at the
flagship width (16 heads of 32, d=512), the four (Lq, L1, L2) stream shapes
of a both/both layer and the (Lq, Lk) shapes of the CrossAtt and SelfAtt
ablations, with padded query and key rows, in fp32 and bf16, with dropout
off and on. Each launch must add one to its kernel's count.

These tests need a CUDA device and skip without one. The file imports
neither JAX nor the JAX package, so it also runs where the card is, which
has no JAX (the shared conftest imports it, hence ``--noconftest``):

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from segmminterest_tpu_torch.core import attention as A

SHAPES = [(40, 40, 100), (100, 40, 100), (40, 40, 1), (1, 40, 1)]
H, DH = 16, 32
SCALE = 1 / math.sqrt(DH)
# fp32: the same products summed in another order (~1e-6 on O(1) outputs);
# bf16: one ulp is 2^-8 relative, and a projection that rounds the other
# way moves an output by a few ulps
TOL = {torch.float32: dict(atol=1e-4, rtol=0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    return torch.device("cuda")


def _masks(rng, B, L, empty_row):
    m = np.zeros((B, L), bool)
    for i in range(B):
        m[i, :rng.integers(1, L + 1)] = True
    if empty_row:
        m[0] = False  # a fully padded row
    return m


def _masks_for(rng, B, Lq, L1, L2):
    return (_masks(rng, B, Lq, True), _masks(rng, B, L1, False),
            _masks(rng, B, L2, Lq > 1))


def _on(dev, arrays, dtype=None):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(1)
    B, (Lq, L1, L2) = 16, shape
    qkv = [rng.normal(size=(B, L, H, DH)).astype(np.float32)
           for L in (Lq, Lq, L1, L2, L1, L2)]
    args = _on(cuda, qkv, dtype) + _on(cuda, _masks_for(rng, B, *shape))
    before = A.LAUNCHES["two_block_attention"]
    got = A.fused_two_block_attention(*args, scale=SCALE)
    assert A.LAUNCHES["two_block_attention"] == before + 1
    want = A.two_block_attention_plain(*args, SCALE)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(2)
    B, (Lq, L1, L2), d = 16, shape, H * DH
    xs = [rng.normal(size=(B, L, d)).astype(np.float32)
          for L in (Lq, L1, L2)]
    ws = []
    for _ in range(6):  # nn.Linear layout (out, in) + bias
        ws += [(rng.normal(size=(d, d)) / math.sqrt(d)).astype(np.float32),
               (0.1 * rng.normal(size=d)).astype(np.float32)]
    args = (_on(cuda, xs, dtype) + _on(cuda, ws, dtype)
            + _on(cuda, _masks_for(rng, B, *shape)))
    before = A.LAUNCHES["proj_two_block_attention"]
    got = A.fused_proj_two_block_attention(*args, num_heads=H, scale=SCALE)
    assert A.LAUNCHES["proj_two_block_attention"] == before + 1
    want = A.proj_two_block_attention_plain(*args, H, SCALE)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# gradients, as max |err| over max |want| per tensor: fp32 sums in another
# order; bf16 recomputes the projections and rounds them to bf16, and a value
# that rounds the other way moves by an ulp (2^-8 relative) into the
# gradients
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _rel_close(got, want, dtype):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), i
        err = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        assert err <= BWD_TOL[dtype], f"output {i}: relative error {err:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_backward_kernel_matches_plain(cuda, shape, dtype, rate):
    """K1f with dropout and K1b against their plain versions; each launch
    counts once."""
    rng = np.random.default_rng(3)
    B, (Lq, L1, L2) = 16, shape
    qkv = _on(cuda, [rng.normal(size=(B, L, H, DH)).astype(np.float32)
                     for L in (Lq, Lq, L1, L2, L1, L2)], dtype)
    masks = _on(cuda, _masks_for(rng, B, *shape))
    g = _on(cuda, [rng.normal(size=(B, Lq, H, DH)).astype(np.float32)],
            dtype)[0]
    leaves = [t.clone().requires_grad_() for t in qkv]
    before = dict(A.LAUNCHES)
    out = A.fused_two_block_attention(*leaves, *masks, scale=SCALE,
                                      dropout_rate=rate, seed=99,
                                      deterministic=rate == 0)
    got = torch.autograd.grad(out, leaves, g)
    assert A.LAUNCHES["two_block_attention"] == \
        before["two_block_attention"] + 1
    assert A.LAUNCHES["two_block_attention_bwd"] == \
        before["two_block_attention_bwd"] + 1
    torch.testing.assert_close(
        out.float(), A.two_block_attention_plain(
            *qkv, *masks, SCALE, rate, 99).float(), **TOL[dtype])
    _rel_close(got, A.two_block_attention_bwd_plain(
        *qkv, *masks, g, SCALE, rate, 99), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("v3", [False, True], ids=["K2b", "K7b"])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_backward_kernel_matches_plain(cuda, shape, dtype, rate, v3,
                                          monkeypatch):
    """K2f with dropout and K2b (or, with SEGMM_ATTN_V3_BWD's switch, K7b's
    qkv pass + torch.matmul) against their plain versions."""
    monkeypatch.setattr(A, "ATTN_V3_BWD", v3)
    rng = np.random.default_rng(4)
    B, (Lq, L1, L2), d = 16, shape, H * DH
    arrays = [rng.normal(size=(B, L, d)).astype(np.float32)
              for L in (Lq, L1, L2)]
    for _ in range(6):
        arrays += [(rng.normal(size=(d, d)) / math.sqrt(d)).astype(
            np.float32), (0.1 * rng.normal(size=d)).astype(np.float32)]
    inputs = _on(cuda, arrays, dtype)
    masks = _on(cuda, _masks_for(rng, B, *shape))
    g = _on(cuda, [rng.normal(size=(B, Lq, d)).astype(np.float32)],
            dtype)[0]
    leaves = [t.clone().requires_grad_() for t in inputs]
    key = ("proj_two_block_attention_qkv_bwd" if v3
           else "proj_two_block_attention_bwd")
    before = A.LAUNCHES[key]
    out = A.fused_proj_two_block_attention(
        *leaves, *masks, num_heads=H, scale=SCALE, dropout_rate=rate,
        seed=99, deterministic=rate == 0)
    got = torch.autograd.grad(out, leaves, g)
    assert A.LAUNCHES[key] == before + 1
    torch.testing.assert_close(
        out.float(), A.proj_two_block_attention_plain(
            *inputs, *masks, H, SCALE, rate, 99).float(), **TOL[dtype])
    _rel_close(got, A.proj_two_block_attention_bwd_plain(
        *inputs, *masks, g, H, SCALE, rate, 99), dtype)


# K3 (single-block masked attention of the CrossAtt / SelfAtt ablations):
# the (Lq, Lk) launch shapes at the flagship width
K3_SHAPES = [(40, 100), (100, 40), (40, 1), (1, 40), (40, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_k3_kernels_match_plain(cuda, shape, dtype, rate):
    """K3f and K3b against their plain versions, padded query and key rows;
    each launch counts once."""
    rng = np.random.default_rng(5)
    B, (Lq, Lk) = 16, shape
    q, k, v = _on(cuda, [rng.normal(size=(B, L, H, DH)).astype(np.float32)
                         for L in (Lq, Lk, Lk)], dtype)
    masks = _on(cuda, (_masks(rng, B, Lq, Lq > 1), _masks(rng, B, Lk, False)))
    g = _on(cuda, [rng.normal(size=(B, Lq, H, DH)).astype(np.float32)],
            dtype)[0]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(A.LAUNCHES)
    out = A.fused_masked_attention(*leaves, *masks, scale=SCALE,
                                   dropout_rate=rate, seed=99,
                                   deterministic=rate == 0)
    got = torch.autograd.grad(out, leaves, g)
    assert A.LAUNCHES["masked_attention"] == before["masked_attention"] + 1
    assert A.LAUNCHES["masked_attention_bwd"] == \
        before["masked_attention_bwd"] + 1
    torch.testing.assert_close(
        out.float(), A.masked_attention_plain(
            q, k, v, *masks, SCALE, rate, 99).float(), **TOL[dtype])
    _rel_close(got, A.masked_attention_bwd_plain(
        q, k, v, *masks, g, SCALE, rate, 99), dtype)


@pytest.mark.cuda
def test_k3_rejects_unsupported_shapes(cuda):
    q = torch.zeros(2, 3, 2, 8, device=cuda)
    m = torch.ones(2, 3, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        A.fused_masked_attention(q, q, q, m, m)   # head dim 8
    q = torch.zeros(2, 129, 2, 32, device=cuda)
    m = torch.ones(2, 129, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        A.fused_masked_attention(q, q, q, m, m)   # longer than 128
