"""K1, K2, K3, K4, K5 and K6, forward and backward (K1b, K2b, K7b, K3b,
K4b, K5b and K6b), on the card against their plain PyTorch versions, on
the same seeded inputs, at the flagship width (16 heads of 32, d=512), the
four (Lq, L1, L2) stream shapes of a both/both layer (K5: its feature
backbone's stream pair; K6: also a shape with its blocks swapped) and the
(Lq, Lk) shapes of the CrossAtt and SelfAtt ablations, with
padded query and key rows, in fp32 and bf16, with dropout off and on. Each
launch must add one to its kernel's count.

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
from segmminterest_tpu_torch.core import dual_kernel as K5
from segmminterest_tpu_torch.core import layer_kernel as K4

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


# K6 (version 2 of K2): the four stream shapes and one whose unaligned L1
# and aligned L2 make the wrapper swap the blocks
V2_SHAPES = SHAPES + [(12, 12, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", V2_SHAPES)
def test_k6_kernels_match_plain(cuda, shape, dtype, rate):
    """K6f and K6b (version=2) against their plain versions, in the blocks'
    order the wrapper runs them in; each launch counts once and K2 does not
    launch."""
    rng = np.random.default_rng(8)
    B, (Lq, L1, L2), d = 16, shape, H * DH
    inputs = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                        for L in (Lq, L1, L2)] + _proj_params(rng, d), dtype)
    masks = _on(cuda, _masks_for(rng, B, *shape))
    g = _on(cuda, [rng.normal(size=(B, Lq, d)).astype(np.float32)],
            dtype)[0]
    leaves = [t.clone().requires_grad_() for t in inputs]
    before = dict(A.LAUNCHES)
    out = A.fused_proj_two_block_attention(
        *leaves, *masks, num_heads=H, scale=SCALE, dropout_rate=rate,
        seed=99, deterministic=rate == 0, version=2)
    got = torch.autograd.grad(out, leaves, g)
    for key, n in (("proj_two_block_attention_v2", 1),
                   ("proj_two_block_attention_v2_bwd", 1),
                   ("proj_two_block_attention", 0),
                   ("proj_two_block_attention_bwd", 0)):
        assert A.LAUNCHES[key] == before[key] + n, key
    mq, m1, m2 = masks
    if L1 % 8:  # the plain versions take the blocks in the kernel's order
        inputs, (m1, m2) = A.swap_blocks(inputs), (m2, m1)
    torch.testing.assert_close(
        out.float(), A.proj_two_block_attention_v2_plain(
            *inputs, mq, m1, m2, H, SCALE, rate, 99).float(), **TOL[dtype])
    want = A.proj_two_block_attention_v2_bwd_plain(*inputs, mq, m1, m2, g, H,
                                                   SCALE, rate, 99)
    _rel_close(got, A.swap_blocks(want) if L1 % 8 else want, dtype)


# K3 (single-block masked attention of the CrossAtt / SelfAtt ablations):
# the (Lq, Lk) launch shapes at the flagship width, the largest shape the
# kernel takes, and (a third entry: q's scale) near-one-hot rows, logits of
# magnitude ~50
K3_SHAPES = [(40, 100), (100, 40), (40, 1), (1, 40), (40, 40), (128, 128),
             pytest.param((40, 100, 50.0), id="near_one_hot")]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_k3_kernels_match_plain(cuda, shape, dtype, rate):
    """K3f and K3b against their plain versions, padded query and key rows;
    each launch counts once."""
    rng = np.random.default_rng(5)
    B, (Lq, Lk), amp = 16, shape[:2], (shape[2:] or (1.0,))[0]
    q, k, v = _on(cuda, [a * rng.normal(size=(B, L, H, DH)).astype(np.float32)
                         for a, L in ((amp, Lq), (1.0, Lk), (1.0, Lk))],
                  dtype)
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
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("Lq,Lk,heads,dh", [(128, 128, 8, 64),
                                            (12, 20, 32, 16)])
def test_k3_bf16_head_dims(cuda, Lq, Lk, heads, dh, rate):
    """K3's bf16 bodies at the other head dims they take, 64 (at the
    largest shape) and 16."""
    B = 16
    rng = np.random.default_rng(6)
    q, k, v, g = _on(cuda, [rng.normal(size=(B, L, heads, dh)).astype(
        np.float32) for L in (Lq, Lk, Lk, Lq)], torch.bfloat16)
    masks = _on(cuda, (_masks(rng, B, Lq, Lq > 1), _masks(rng, B, Lk, False)))
    scale = 1 / math.sqrt(dh)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A.fused_masked_attention(*leaves, *masks, scale=scale,
                                   dropout_rate=rate, seed=17,
                                   deterministic=rate == 0)
    got = torch.autograd.grad(out, leaves, g)
    torch.testing.assert_close(
        out.float(), A.masked_attention_plain(
            q, k, v, *masks, scale, rate, 17).float(),
        **TOL[torch.bfloat16])
    _rel_close(got, A.masked_attention_bwd_plain(
        q, k, v, *masks, g, scale, rate, 17), torch.bfloat16)


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


def _proj_params(rng, d, n=6):
    out = []
    for _ in range(n):  # nn.Linear layout (out, in) + bias
        out += [(rng.normal(size=(d, d)) / math.sqrt(d)).astype(np.float32),
                (0.1 * rng.normal(size=d)).astype(np.float32)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [(40, 100), (12, 9)])
def test_k5_kernels_match_plain(cuda, lengths, dtype, rate):
    """K5f and K5b (both streams of a layer in one launch) against their
    plain versions; each launch counts once."""
    rng = np.random.default_rng(6)
    B, (Lv, Lu), d = 16, lengths, H * DH
    xv, xu = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                        for L in (Lv, Lu)], dtype)
    ws = _on(cuda, _proj_params(rng, d, 12), dtype)
    mv, mu = _on(cuda, (_masks(rng, B, Lv, False), _masks(rng, B, Lu, True)))
    gv, gu = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                        for L in (Lv, Lu)], dtype)
    leaves = [t.clone().requires_grad_() for t in [xv, xu] + ws]
    pairs = lambda ts: [(ts[i], ts[i + 1]) for i in range(0, 12, 2)]  # noqa
    before = dict(A.LAUNCHES)
    ov, ou = K5.fused_dual_stream_attention(
        leaves[0], leaves[1], pairs(leaves[2:14]), pairs(leaves[14:]), mv, mu,
        num_heads=H, scale=SCALE, dropout_rate=rate, seed=99,
        deterministic=rate == 0)
    got = torch.autograd.grad((ov, ou), leaves, (gv, gu))
    assert A.LAUNCHES["dual_stream_attention"] == \
        before["dual_stream_attention"] + 1
    assert A.LAUNCHES["dual_stream_attention_bwd"] == \
        before["dual_stream_attention_bwd"] + 1
    wv, wu = K5.dual_stream_attention_plain(xv, xu, ws[:12], ws[12:], mv, mu,
                                            H, SCALE, rate, 99)
    torch.testing.assert_close(ov.float(), wv.float(), **TOL[dtype])
    torch.testing.assert_close(ou.float(), wu.float(), **TOL[dtype])
    _rel_close(got, K5.dual_stream_attention_bwd_plain(
        xv, xu, ws[:12], ws[12:], mv, mu, gv, gu, H, SCALE, rate, 99), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,ff", [(s, H * DH) for s in SHAPES]
                         + [(SHAPES[0], H * DH // 2)])
def test_k4_kernels_match_plain(cuda, shape, ff, dtype, rate):
    """K4f and K4b (a whole layer stream) against their plain versions, the
    two LayerNorms with parameters of their own and one MLP narrower than
    d; each launch counts once."""
    rng = np.random.default_rng(7)
    B, (Lq, L1, L2), d = 16, shape, H * DH
    xs = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                    for L in shape], dtype)
    qkv = _on(cuda, _proj_params(rng, d), dtype)

    def dense(n_out, n_in):  # nn.Linear layout (out, in) + bias
        return _on(cuda, [
            (rng.normal(size=(n_out, n_in)) / math.sqrt(n_in)).astype(
                np.float32), (0.1 * rng.normal(size=n_out)).astype(np.float32)
        ], dtype)

    def ln():  # fp32 (scale, bias)
        return _on(cuda, [(1 + 0.1 * rng.normal(size=d)).astype(np.float32),
                          (0.1 * rng.normal(size=d)).astype(np.float32)])

    ep = dense(d, d) + ln() + dense(ff, d) + dense(d, ff) + ln()
    masks = _on(cuda, _masks_for(rng, B, *shape))
    g = _on(cuda, [rng.normal(size=(B, Lq, d)).astype(np.float32)], dtype)[0]
    leaves = [t.clone().requires_grad_() for t in xs + qkv + ep]
    before = dict(A.LAUNCHES)
    out = K4.fused_layer_stream(
        *leaves[:3], [(leaves[3 + i], leaves[4 + i]) for i in range(0, 12, 2)],
        leaves[15:], *masks, num_heads=H, scale=SCALE, dropout_rate=rate,
        seed=99, deterministic=rate == 0)
    got = torch.autograd.grad(out, leaves, g)
    assert A.LAUNCHES["layer_stream"] == before["layer_stream"] + 1
    assert A.LAUNCHES["layer_stream_bwd"] == before["layer_stream_bwd"] + 1
    # against the largest output, as the gradients: in bf16 a y1 that rounds
    # the other way before LN2 moves an output by an ulp of y1's size
    _rel_close([out], [K4.layer_stream_plain(*xs, qkv, ep, *masks, H, SCALE,
                                             rate, 99)], dtype)
    _rel_close(got, K4.layer_stream_bwd_plain(*xs, qkv, ep, *masks, g, H,
                                              SCALE, rate, 99), dtype)
