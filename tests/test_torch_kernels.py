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

import ctypes
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


# K1b: the stream shapes and (a fourth entry: q's scale) near-one-hot rows,
# logits of magnitude ~50
K1_BWD_SHAPES = SHAPES + [pytest.param((40, 40, 100, 50.0),
                                       id="near_one_hot")]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K1_BWD_SHAPES)
def test_k1_backward_kernel_matches_plain(cuda, shape, dtype, rate):
    """K1f with dropout and K1b against their plain versions; each launch
    counts once."""
    rng = np.random.default_rng(3)
    B, (Lq, L1, L2), amp = 16, shape[:3], (shape[3:] or (1.0,))[0]
    qkv = _on(cuda, [a * rng.normal(size=(B, L, H, DH)).astype(np.float32)
                     for a, L in ((amp, Lq), (amp, Lq), (1.0, L1), (1.0, L2),
                                  (1.0, L1), (1.0, L2))], dtype)
    masks = _on(cuda, _masks_for(rng, B, Lq, L1, L2))
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


# bf16 K2's tensor-core bodies (k2_body "mma"): lengths up to 128,
# block 2 starting mid 16-key tile (L1 = 40, 5, 128 + 8 alignment) and on
# one (L1 = 9), and (a fourth entry: the query weights' scale) near-one-hot
# rows, logits of magnitude ~50; mask_q's row 0 fully padded throughout
K2_MMA_SHAPES = [(128, 40, 128), (40, 128, 128), (128, 128, 1), (7, 5, 13),
                 (3, 9, 128), pytest.param((40, 40, 100, 50.0),
                                           id="near_one_hot")]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("shape", K2_MMA_SHAPES)
def test_k2_mma_bodies_match_plain(cuda, shape, dh, rate):
    """bf16 K2f and K2b at head dims 16, 32 and 64 (d = 256) against their
    plain versions; each launch counts once."""
    rng = np.random.default_rng(9)
    B, (Lq, L1, L2), amp = 8, shape[:3], (shape[3:] or (1.0,))[0]
    d, heads = 256, 256 // dh
    arrays = ([rng.normal(size=(B, L, d)).astype(np.float32)
               for L in (Lq, L1, L2)] + _proj_params(rng, d))
    arrays[3] = amp * arrays[3]  # wq1
    arrays[5] = amp * arrays[5]  # wq2
    inputs = _on(cuda, arrays, torch.bfloat16)
    masks = _on(cuda, _masks_for(rng, B, Lq, L1, L2))
    g = _on(cuda, [rng.normal(size=(B, Lq, d)).astype(np.float32)],
            torch.bfloat16)[0]
    leaves = [t.clone().requires_grad_() for t in inputs]
    before = dict(A.LAUNCHES)
    scale = 1 / math.sqrt(dh)
    out = A.fused_proj_two_block_attention(
        *leaves, *masks, num_heads=heads, scale=scale, dropout_rate=rate,
        seed=17, deterministic=rate == 0)
    got = torch.autograd.grad(out, leaves, g)
    for key in ("proj_two_block_attention", "proj_two_block_attention_bwd"):
        assert A.LAUNCHES[key] == before[key] + 1, key
    torch.testing.assert_close(
        out.float(), A.proj_two_block_attention_plain(
            *inputs, *masks, heads, scale, rate, 17).float(),
        **TOL[torch.bfloat16])
    _rel_close(got, A.proj_two_block_attention_bwd_plain(
        *inputs, *masks, g, heads, scale, rate, 17), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
def test_k2b_weight_grads_bit_equal_across_calls(cuda, rate):
    """bf16 K2b sums dW and db in row chunks added in order, without
    atomics: two calls on the same inputs give the same bits."""
    rng = np.random.default_rng(10)
    B, (Lq, L1, L2), d = 64, SHAPES[0], H * DH
    inputs = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                        for L in (Lq, L1, L2)] + _proj_params(rng, d),
                 torch.bfloat16)
    masks = _on(cuda, _masks_for(rng, B, Lq, L1, L2))
    g = _on(cuda, [rng.normal(size=(B, Lq, d)).astype(np.float32)],
            torch.bfloat16)[0]
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = A.fused_proj_two_block_attention(
        *leaves, *masks, num_heads=H, scale=SCALE, dropout_rate=rate,
        seed=5, deterministic=rate == 0)
    first = torch.autograd.grad(out, leaves, g, retain_graph=True)
    second = torch.autograd.grad(out, leaves, g)
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), f"gradient {i} differs between calls"


@pytest.mark.cuda
def test_k2_mma_shared_memory_matches_the_rule(cuda):
    """The bf16 core's shared memory on the path each shape takes
    (k2_core_smem_bytes: k2_core_fwd_smem_bytes / k2_core_bwd_smem_bytes in
    one chunk, k2_chunked_smem_bytes past it) is the wrapper's Python
    formula."""
    for lib, symbol, bwd in (
            ("proj_two_block_attention",
             "segmm_proj_two_block_attention_smem_bytes", False),
            ("proj_two_block_attention_bwd",
             "segmm_proj_two_block_attention_bwd_smem_bytes", True)):
        smem = A._fn(lib, symbol, ctypes.c_size_t, [ctypes.c_int] * 5)
        for shape in SHAPES + [(128, 128, 128), (7, 5, 13), (3, 9, 128)]:
            for dh in (16, 32, 64):
                assert smem(1, *shape, dh) == A.k2_core_smem_bytes(*shape,
                                                                   dh, bwd)


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


# bf16 K6b on K2b's bodies: lengths up to 128, head dims 16, 32 and 64
# (d = 256), blocks aligned or not (the key indexing of K6's dropout over
# the padded axis)
K6_MMA_SHAPES = [(40, 40, 100), (7, 128, 5), (12, 13, 9), (128, 16, 128),
                 (1, 40, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("shape", K6_MMA_SHAPES)
def test_k6b_mma_body_matches_plain(cuda, shape, dh, rate):
    """bf16 K6b (K2b's projection GEMM, core with K6's dropout keys, chain)
    through its wrapper, blocks in the order given (an unaligned L1
    included, which the entry point would swap), against
    proj_two_block_attention_v2_bwd_plain; it counts once and launches no
    K2b."""
    assert A.k6_body(torch.bfloat16) == "mma"
    assert A.k6_body(torch.float32) == "tf32"
    rng = np.random.default_rng(12)
    B, (Lq, L1, L2), d = 8, shape, 256
    heads, scale = d // dh, 1 / math.sqrt(dh)
    inputs = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                        for L in (Lq, L1, L2)] + _proj_params(rng, d),
                 torch.bfloat16)
    masks = _on(cuda, _masks_for(rng, B, Lq, L1, L2))
    g = _on(cuda, [rng.normal(size=(B, Lq, d)).astype(np.float32)],
            torch.bfloat16)[0]
    before = dict(A.LAUNCHES)
    got = A._k6_backward_cuda(*inputs[:3], inputs[3:], masks, g, heads,
                              scale, rate, 31)
    assert A.LAUNCHES["proj_two_block_attention_v2_bwd"] == \
        before["proj_two_block_attention_v2_bwd"] + 1
    assert A.LAUNCHES["proj_two_block_attention_bwd"] == \
        before["proj_two_block_attention_bwd"]
    _rel_close(got, A.proj_two_block_attention_v2_bwd_plain(
        *inputs, *masks, g, heads, scale, rate, 31), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
def test_k6b_and_k5b_weight_grads_bit_equal_across_calls(cuda, rate):
    """bf16 K6b and K5b sum dW and db in row chunks added in order, without
    atomics: two calls on the same inputs give the same bits."""
    rng = np.random.default_rng(13)
    B, (Lq, L1, L2), d = 64, SHAPES[0], H * DH
    inputs = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                        for L in (Lq, L1, L2)] + _proj_params(rng, d),
                 torch.bfloat16)
    masks = _on(cuda, _masks_for(rng, B, Lq, L1, L2))
    g = _on(cuda, [rng.normal(size=(B, Lq, d)).astype(np.float32)],
            torch.bfloat16)[0]
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = A.fused_proj_two_block_attention(
        *leaves, *masks, num_heads=H, scale=SCALE, dropout_rate=rate,
        seed=5, deterministic=rate == 0, version=2)
    first = torch.autograd.grad(out, leaves, g, retain_graph=True)
    second = torch.autograd.grad(out, leaves, g)
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), f"K6b gradient {i} differs between calls"
    Lv, Lu = 40, 100
    xv, xu = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                        for L in (Lv, Lu)], torch.bfloat16)
    ws = _on(cuda, _proj_params(rng, d, 12), torch.bfloat16)
    mv, mu = _on(cuda, (_masks(rng, B, Lv, False), _masks(rng, B, Lu, True)))
    gs = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                    for L in (Lv, Lu)], torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in [xv, xu] + ws]
    pairs = lambda ts: [(ts[i], ts[i + 1]) for i in range(0, 12, 2)]  # noqa
    out = K5.fused_dual_stream_attention(
        leaves[0], leaves[1], pairs(leaves[2:14]), pairs(leaves[14:]), mv, mu,
        num_heads=H, scale=SCALE, dropout_rate=rate, seed=5,
        deterministic=rate == 0)
    first = torch.autograd.grad(out, leaves, gs, retain_graph=True)
    second = torch.autograd.grad(out, leaves, gs)
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), f"K5b gradient {i} differs between calls"


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("lengths", [(40, 100), (100, 40), (128, 7)])
def test_k5b_mma_body_matches_plain(cuda, lengths, dh, rate):
    """bf16 K5b (both streams' projections in one grouped GEMM, both cores
    in one launch, dx over six pairs, 12 dW in row chunks) at head dims 16
    and 64 (d = 256) against dual_stream_attention_bwd_plain."""
    assert K5.k5_body(torch.bfloat16) == "mma"
    assert K5.k5_body(torch.float32) == "tf32"
    rng = np.random.default_rng(14)
    B, (Lv, Lu), d = 8, lengths, 256
    heads, scale = d // dh, 1 / math.sqrt(dh)
    xv, xu = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                        for L in (Lv, Lu)], torch.bfloat16)
    ws = _on(cuda, _proj_params(rng, d, 12), torch.bfloat16)
    mv, mu = _on(cuda, (_masks(rng, B, Lv, False), _masks(rng, B, Lu, True)))
    gv, gu = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                        for L in (Lv, Lu)], torch.bfloat16)
    before = A.LAUNCHES["dual_stream_attention_bwd"]
    got = K5._k5_backward_cuda(xv, xu, ws[:12], ws[12:], mv, mu, gv, gu,
                               heads, scale, rate, 23)
    assert A.LAUNCHES["dual_stream_attention_bwd"] == before + 1
    _rel_close(got, K5.dual_stream_attention_bwd_plain(
        xv, xu, ws[:12], ws[12:], mv, mu, gv, gu, heads, scale, rate, 23),
        torch.bfloat16)


@pytest.mark.cuda
def test_k5b_and_k6b_shared_memory_match_the_rule(cuda):
    """bf16 K6b's and K5b's core blocks take K2b's shared memory on the
    path each shape takes (``k2_core_smem_bytes``: one chunk, or the
    key-chunk path's block, as at (128, 128, 128) and head dim 64), K5b the
    larger of its two streams'."""
    smem6 = A._fn("proj_two_block_attention_v2_bwd",
                  "segmm_proj_two_block_attention_v2_bwd_smem_bytes",
                  ctypes.c_size_t, [ctypes.c_int] * 5)
    smem5 = A._fn("dual_stream_attention_bwd",
                  "segmm_dual_stream_attention_bwd_smem_bytes",
                  ctypes.c_size_t, [ctypes.c_int] * 4)
    for dh in (16, 32, 64):
        for shape in SHAPES + [(128, 128, 128), (7, 5, 13)]:
            assert smem6(1, *shape, dh) == A.k2_core_smem_bytes(*shape, dh,
                                                                True)
        for Lv, Lu in ((40, 100), (128, 7)):
            assert smem5(1, Lv, Lu, dh) == max(
                A.k2_core_smem_bytes(Lv, Lv, Lu, dh, True),
                A.k2_core_smem_bytes(Lu, Lv, Lu, dh, True))
    assert not A.k2_core_whole(128, 128, 128, 64, True)


# K3 (single-block masked attention of the CrossAtt / SelfAtt ablations):
# the (Lq, Lk) launch shapes at the flagship width, the largest shape the
# kernel takes, and (a third entry: q's scale) near-one-hot rows, logits of
# magnitude ~50
K3_SHAPES = [(40, 100), (100, 40), (40, 1), (1, 40), (40, 40), (128, 128),
             pytest.param((40, 100, 50.0), id="near_one_hot")]


def _k3_onehot_hold(dev, rate):
    """fp32 K3 on near-one-hot rows as chip_smoke.py holds it
    (``k3_onehot``, ``k3_onehot_hold``): its ONEHOT_DRAWS draws at (40,
    100), B=64, each from a generator of its own seeded ONEHOT_SEED + i;
    K3f against the function in fp64 (``_masked_f64``) at TOL[float32],
    K3b against its plain version at BWD_TOL. Against the fp32 plain
    version K3f cannot be held at 1e-4 there: the kernel is 7.63e-5 and
    the plain version 6.72e-5 from the function in fp64, and the two differ
    by up to 1.34e-4 (the logits' rounding, ~50 x an fp32 ulp, grows
    through exp)."""
    import chip_smoke as CS
    rows = [r for r in CS.k3_onehot(A, dev, torch.float32)
            if r["rate"] == (rate and CS.DROP_RATE)]
    assert len(rows) == CS.ONEHOT_DRAWS
    assert TOL[torch.float32]["atol"] == CS.TOL[torch.float32][0]
    CS.k3_onehot_hold(rows, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_k3_kernels_match_plain(cuda, shape, dtype, rate):
    """K3f and K3b against their plain versions, padded query and key rows;
    each launch counts once. fp32 on near-one-hot rows: K3f against the
    function in fp64 over chip_smoke.py's 32 draws (``_k3_onehot_hold``)."""
    if len(shape) > 2 and dtype == torch.float32:
        _k3_onehot_hold(cuda, rate)
        return
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


# fp32 K1b and K3b at head dims 64 and 16 (off the flagship's 32: their
# largest register tile only), and K1b at head dims 64 and 32 at the largest
# stream shapes its shared memory takes: (kernel, lengths, heads, head dim)
FP32_BWD_HEAD_DIMS = [("K1b", (100, 40, 100), 8, 64),
                      ("K1b", (40, 40, 100), 32, 16),
                      ("K1b", (128, 100, 100), 16, 32),
                      ("K3b", (128, 128), 8, 64), ("K3b", (12, 20), 32, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("kernel,lengths,heads,dh", FP32_BWD_HEAD_DIMS)
def test_fp32_backward_head_dims(cuda, kernel, lengths, heads, dh, rate):
    """fp32 K1b and K3b (3xTF32) against their plain versions at the other
    head dims they take; each launch counts once."""
    B, scale = 16, 1 / math.sqrt(dh)
    rng = np.random.default_rng(7)
    Lq = lengths[0]
    if kernel == "K1b":
        L = (Lq, Lq, lengths[1], lengths[2], lengths[1], lengths[2])
        masks = _on(cuda, _masks_for(rng, B, *lengths))
        fused, plain = (A.fused_two_block_attention,
                        A.two_block_attention_bwd_plain)
        lib = "two_block_attention_bwd"
    else:
        L = (Lq, lengths[1], lengths[1])
        masks = _on(cuda, (_masks(rng, B, Lq, Lq > 1),
                           _masks(rng, B, lengths[1], False)))
        fused, plain = A.fused_masked_attention, A.masked_attention_bwd_plain
        lib = "masked_attention_bwd"
    x = _on(cuda, [rng.normal(size=(B, n, heads, dh)).astype(np.float32)
                   for n in L + (Lq,)])
    inputs, g = x[:-1], x[-1]
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = fused(*leaves, *masks, scale=scale, dropout_rate=rate, seed=23,
                deterministic=rate == 0)
    before = A.LAUNCHES[lib]
    got = torch.autograd.grad(out, leaves, g)
    assert A.LAUNCHES[lib] == before + 1
    _rel_close(got, plain(*inputs, *masks, g, scale, rate, 23),
               torch.float32)


# fp32 K1f and K3f on the TF32 tensor cores (3xTF32) at head dims 16, 32
# and 64, Lq = 1 and the largest shapes, each batch row 0 with a fully
# padded query row; K1f also at head dim 128, which its shape rule sends to
# the tensor-core body too (in query windows past one block's shared
# memory): (kernel, lengths, heads, head dim, body)
FP32_FWD_CASES = [("K1f", (40, 40, 100), 32, 16, "tf32"),
                  ("K1f", (100, 40, 100), 16, 32, "tf32"),
                  ("K1f", (1, 40, 1), 16, 32, "tf32"),
                  ("K1f", (40, 40, 1), 16, 32, "tf32"),
                  ("K1f", (100, 40, 100), 8, 64, "tf32"),
                  ("K1f", (128, 128, 128), 8, 64, "tf32"),
                  ("K1f", (40, 40, 100), 4, 128, "tf32"),
                  ("K3f", (40, 100), 32, 16, "tf32"),
                  ("K3f", (1, 40), 16, 32, "tf32"),
                  ("K3f", (128, 128), 8, 64, "tf32")]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("kernel,lengths,heads,dh,body", FP32_FWD_CASES)
def test_fp32_forward_bodies(cuda, kernel, lengths, heads, dh, body, rate):
    """fp32 K1f and K3f against their plain versions at 1e-4 on the body
    the wrapper chooses; each launch counts once."""
    B, scale = 16, 1 / math.sqrt(dh)
    rng = np.random.default_rng(8)
    Lq = lengths[0]
    if kernel == "K1f":
        assert A.k1_body(torch.float32, *lengths, dh) == body
        L = (Lq, Lq, lengths[1], lengths[2], lengths[1], lengths[2])
        masks = _on(cuda, _masks_for(rng, B, *lengths))
        fused, plain = A.fused_two_block_attention, A.two_block_attention_plain
        lib = "two_block_attention"
    else:
        L = (Lq, lengths[1], lengths[1])
        masks = _on(cuda, (_masks(rng, B, Lq, True),
                           _masks(rng, B, lengths[1], False)))
        fused, plain = A.fused_masked_attention, A.masked_attention_plain
        lib = "masked_attention"
    inputs = _on(cuda, [rng.normal(size=(B, n, heads, dh)).astype(np.float32)
                        for n in L])
    before = A.LAUNCHES[lib]
    got = fused(*inputs, *masks, scale=scale, dropout_rate=rate, seed=31,
                deterministic=rate == 0)
    assert A.LAUNCHES[lib] == before + 1
    torch.testing.assert_close(got, plain(*inputs, *masks, scale, rate, 31),
                               **TOL[torch.float32])


@pytest.mark.cuda
def test_k1f_tf32_shared_memory_matches_the_rule(cuda):
    """The C body's shared memory (tf32_fwd_smem_bytes) is the wrapper's
    Python formula, which the shape rule reads."""
    smem = A._fn("two_block_attention", "segmm_two_block_attention_smem_bytes",
                 ctypes.c_size_t, [ctypes.c_int] * 5)
    for shape in ((40, 40, 100), (100, 40, 100), (1, 40, 1), (300, 128, 128),
                  (7, 13, 250)):
        for D in (4, 16, 20, 32, 36, 64, 96, 128):
            w = A.tf32_window(shape[0], shape[1:], D, False)
            assert smem(1, *shape, D) == A.tf32_smem_bytes(
                w or shape[0], shape[1:], D, False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1b_rejects_shapes_past_shared_memory(cuda, dtype):
    """K1b at head dim 128 over two blocks of 128 keys, where no query
    window of the fp32 one-chunk body's tiles and P fits one block's shared
    memory (and bf16's one-chunk tiles do not either): both run on their
    core's key-chunk path and match their plain versions, dropout on."""
    rng = np.random.default_rng(12)
    B, H, D, L = 2, 2, 128, 128
    assert not A.tf32_whole(L, (L, L), D, True)
    assert not A.k2_core_whole(L, L, L, D, True)
    qkv = _on(cuda, [rng.normal(size=(B, L, H, D)).astype(np.float32)
                     for _ in range(6)], dtype)
    masks = _on(cuda, _masks_for(rng, B, L, L, L))
    g = _on(cuda, [rng.normal(size=(B, L, H, D)).astype(np.float32)],
            dtype)[0]
    before = A.LAUNCHES["two_block_attention_bwd"]
    got = A._k1_backward_cuda(*qkv, *masks, g, 0.125, 0.1, 5)
    assert A.LAUNCHES["two_block_attention_bwd"] == before + 1
    _rel_close(got, A.two_block_attention_bwd_plain(*qkv, *masks, g, 0.125,
                                                    0.1, 5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_rejects_unsupported_shapes(cuda, dtype):
    """K3 refuses head dim 8; a stream longer than 128 runs on its core's
    key-chunk path (fp32: the 3xTF32 core's, bf16: the two-block core's)
    and matches the plain version."""
    q = torch.zeros(2, 3, 2, 8, device=cuda, dtype=dtype)
    m = torch.ones(2, 3, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        A.fused_masked_attention(q, q, q, m, m)   # head dim 8
    rng = np.random.default_rng(13)
    q, k, v = _on(cuda, [rng.normal(size=(2, 129, 2, 32)).astype(np.float32)
                         for _ in range(3)], dtype)
    mq, mk = _on(cuda, (_masks(rng, 2, 129, True), _masks(rng, 2, 129, False)))
    torch.testing.assert_close(
        A.fused_masked_attention(q, k, v, mq, mk).float(),
        A.masked_attention_plain(q, k, v, mq, mk, 1 / math.sqrt(32)).float(),
        **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K6", "K3", "K4", "K5"])
def test_long_streams_and_wide_layers_match_plain(cuda, kernel, dtype, rate):
    """Each kernel past its core's one-chunk shapes (streams (200, 150,
    300) and (1, 300, 7), K3 (200, 300), (1, 300), (128, 128); head dims 32
    and 128; K2 with K7b) and K4 also at d = ff = 1024, against its plain
    version, as chip_smoke.py's phase kernels holds them
    (``_long_kernels``, which raises on a disagreement, a kernel that did
    not launch, or K1b's or K3b's gradients that differ between two
    calls)."""
    import chip_smoke as CS
    worst = CS._long_kernels(A, cuda, dtypes=(dtype,), rates=(rate,),
                             kernels=(kernel,))
    assert worst and all(math.isfinite(v) for v in worst.values())


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dh", [16, 64])
def test_k1_bf16_core_head_dims(cuda, dh, shape, rate):
    """bf16 K1f and K1b on the two-block core at head dims 16 and 64 (32 is
    the tests above, 48, 96 and 128 test_wide_k1_matches_plain) at the
    four stream shapes: against their plain versions, the dropout bits the
    plain version's (a dropped logit the other way moves the output far
    past the tolerance), one launch each, on the core's kernels."""
    rng = np.random.default_rng(21)
    B, (Lq, L1, L2), heads = 8, shape, 4
    assert A.k1_body(torch.bfloat16, Lq, L1, L2, dh, True) == "mma"
    qkv = _on(cuda, [rng.normal(size=(B, L, heads, dh)).astype(np.float32)
                     for L in (Lq, Lq, L1, L2, L1, L2)], torch.bfloat16)
    masks = _on(cuda, _masks_for(rng, B, Lq, L1, L2))
    g = _on(cuda, [rng.normal(size=(B, Lq, heads, dh)).astype(np.float32)],
            torch.bfloat16)[0]
    scale = 1 / math.sqrt(dh)
    leaves = [t.clone().requires_grad_() for t in qkv]
    before = dict(A.LAUNCHES)
    out = A.fused_two_block_attention(*leaves, *masks, scale=scale,
                                      dropout_rate=rate, seed=77,
                                      deterministic=rate == 0)
    got = torch.autograd.grad(out, leaves, g)
    for key in ("two_block_attention", "two_block_attention_bwd"):
        assert A.LAUNCHES[key] == before[key] + 1
    torch.testing.assert_close(
        out.float(), A.two_block_attention_plain(
            *qkv, *masks, scale, rate, 77).float(), **TOL[torch.bfloat16])
    _rel_close(got, A.two_block_attention_bwd_plain(
        *qkv, *masks, g, scale, rate, 77), torch.bfloat16)


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
    xs, qkv, ep, masks, g = _k4_inputs(cuda, rng, B, shape, d, ff, dtype)
    leaves = [t.clone().requires_grad_() for t in xs + qkv + ep]
    before = dict(A.LAUNCHES)
    out = _k4_call(leaves, masks, H, rate)
    got = torch.autograd.grad(out, leaves, g)
    assert A.LAUNCHES["layer_stream"] == before["layer_stream"] + 1
    assert A.LAUNCHES["layer_stream_bwd"] == before["layer_stream_bwd"] + 1
    # against the largest output, as the gradients: in bf16 a y1 that rounds
    # the other way before LN2 moves an output by an ulp of y1's size
    _rel_close([out], [K4.layer_stream_plain(*xs, qkv, ep, *masks, H, SCALE,
                                             rate, 99)], dtype)
    _rel_close(got, K4.layer_stream_bwd_plain(*xs, qkv, ep, *masks, g, H,
                                              SCALE, rate, 99), dtype)


def _k4_inputs(dev, rng, B, shape, d, ff, dtype):
    """xq, x1, x2; the twelve projection parameters; the ten epilogue ones
    (nn.Linear layout, the LayerNorms' fp32); the masks; the upstream
    gradient."""
    xs = _on(dev, [rng.normal(size=(B, L, d)).astype(np.float32)
                   for L in shape], dtype)
    qkv = _on(dev, _proj_params(rng, d), dtype)

    def dense(n_out, n_in):  # nn.Linear layout (out, in) + bias
        return _on(dev, [
            (rng.normal(size=(n_out, n_in)) / math.sqrt(n_in)).astype(
                np.float32), (0.1 * rng.normal(size=n_out)).astype(np.float32)
        ], dtype)

    def ln():  # fp32 (scale, bias)
        return _on(dev, [(1 + 0.1 * rng.normal(size=d)).astype(np.float32),
                         (0.1 * rng.normal(size=d)).astype(np.float32)])

    ep = dense(d, d) + ln() + dense(ff, d) + dense(d, ff) + ln()
    masks = _on(dev, _masks_for(rng, B, *shape))
    g = _on(dev, [rng.normal(size=(B, shape[0], d)).astype(np.float32)],
            dtype)[0]
    return xs, qkv, ep, masks, g


def _k4_call(t, masks, heads, rate):
    return K4.fused_layer_stream(
        *t[:3], [(t[3 + i], t[4 + i]) for i in range(0, 12, 2)], t[15:],
        *masks, num_heads=heads, scale=SCALE, dropout_rate=rate, seed=99,
        deterministic=rate == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("shape,heads", [(SHAPES[1], 8), (SHAPES[2], 4)])
def test_k4_bf16_narrow_model_and_repeatable_grads(cuda, shape, heads,
                                                   rate):
    """bf16 K4's tensor-core bodies at d = 256 and 128, narrower than the
    epilogue's 512 columns (the warps past d hold no column), 24 batch rows
    (the last 64-row block part empty), against the plain versions; two
    K4b calls give bit-equal gradients (dW, db and the LayerNorm gradients
    are sums in ordered row chunks)."""
    assert K4.k4_body(torch.bfloat16) == "mma"
    rng = np.random.default_rng(11)
    B, d, dtype = 24, heads * DH, torch.bfloat16
    xs, qkv, ep, masks, g = _k4_inputs(cuda, rng, B, shape, d, d, dtype)
    leaves = [t.clone().requires_grad_() for t in xs + qkv + ep]
    out = _k4_call(leaves, masks, heads, rate)
    got = torch.autograd.grad(out, leaves, g, retain_graph=True)
    again = torch.autograd.grad(out, leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _rel_close([out], [K4.layer_stream_plain(*xs, qkv, ep, *masks, heads,
                                             SCALE, rate, 99)], dtype)
    _rel_close(got, K4.layer_stream_bwd_plain(*xs, qkv, ep, *masks, g,
                                              heads, SCALE, rate, 99), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("shape", K6_MMA_SHAPES)
def test_k6f_mma_body_matches_plain(cuda, shape, dh, rate):
    """bf16 K6f (K2f's projection GEMM and core with K6's dropout keys)
    through its wrapper, blocks in the order given (an unaligned L1
    included, which the entry point would swap), against
    proj_two_block_attention_v2_plain; it counts once and launches no K2f."""
    assert A.k6_body(torch.bfloat16) == "mma"
    rng = np.random.default_rng(13)
    B, (Lq, L1, L2), d = 8, shape, 256 if dh < 128 else 512
    heads, scale = d // dh, 1 / math.sqrt(dh)
    inputs = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                        for L in (Lq, L1, L2)] + _proj_params(rng, d),
                 torch.bfloat16)
    masks = _on(cuda, _masks_for(rng, B, Lq, L1, L2))
    before = dict(A.LAUNCHES)
    got = A._k6_forward_cuda(*inputs[:3], inputs[3:], masks, heads, scale,
                             rate, 31)
    assert A.LAUNCHES["proj_two_block_attention_v2"] == \
        before["proj_two_block_attention_v2"] + 1
    assert A.LAUNCHES["proj_two_block_attention"] == \
        before["proj_two_block_attention"]
    torch.testing.assert_close(
        got.float(), A.proj_two_block_attention_v2_plain(
            *inputs, *masks, heads, scale, rate, 31).float(),
        **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["eval", "dropout"])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("lengths", [(40, 100), (100, 40), (128, 7)])
def test_k5f_mma_body_matches_plain(cuda, lengths, dh, rate):
    """bf16 K5f (both streams' six projections as one GEMM, both streams'
    cores in one launch, the user stream salted from head H) against
    dual_stream_attention_plain; it counts once."""
    assert K5.k5_body(torch.bfloat16) == "mma"
    rng = np.random.default_rng(14)
    B, (Lv, Lu), d = 8, lengths, 256 if dh < 128 else 512
    heads, scale = d // dh, 1 / math.sqrt(dh)
    xv, xu = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                        for L in (Lv, Lu)], torch.bfloat16)
    ws = _on(cuda, _proj_params(rng, d, 12), torch.bfloat16)
    mv, mu = _on(cuda, (_masks(rng, B, Lv, False), _masks(rng, B, Lu, True)))
    before = A.LAUNCHES["dual_stream_attention"]
    got = K5._k5_forward_cuda(xv, xu, ws[:12], ws[12:], mv, mu, heads, scale,
                              rate, 37)
    assert A.LAUNCHES["dual_stream_attention"] == before + 1
    want = K5.dual_stream_attention_plain(xv, xu, ws[:12], ws[12:], mv, mu,
                                          heads, scale, rate, 37)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(),
                                   **TOL[torch.bfloat16])


# Head dims past the flagship's 32, the widened bodies: d_model 768 with 16
# and 8 heads (48, 96) and d_model 512 with 4 (128, skip_train --nhead 4)
WIDE_D = {48: 768, 96: 768, 128: 512}


def _wide_rate_ids(rate):
    return "dropout" if rate else "eval"


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=_wide_rate_ids)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dh", list(WIDE_D))
def test_wide_k1_matches_plain(cuda, dh, shape, dtype, rate):
    """K1f and K1b at head dims 48, 96 and 128 on the body k1_body names
    (fp32: the tensor-core one, in query windows where one block's tiles
    exceed shared memory; bf16 past its CUDA-core body's shared memory:
    the fp32 one on fp32 copies); each launch counts once."""
    rng = np.random.default_rng(15)
    B, (Lq, L1, L2), heads = 8, shape, WIDE_D[dh] // dh
    scale = 1 / math.sqrt(dh)
    qkv = _on(cuda, [rng.normal(size=(B, L, heads, dh)).astype(np.float32)
                     for L in (Lq, Lq, L1, L2, L1, L2)], dtype)
    masks = _on(cuda, _masks_for(rng, B, Lq, L1, L2))
    g = _on(cuda, [rng.normal(size=(B, Lq, heads, dh)).astype(np.float32)],
            dtype)[0]
    leaves = [t.clone().requires_grad_() for t in qkv]
    before = dict(A.LAUNCHES)
    out = A.fused_two_block_attention(*leaves, *masks, scale=scale,
                                      dropout_rate=rate, seed=5,
                                      deterministic=rate == 0)
    got = torch.autograd.grad(out, leaves, g)
    for k in ("two_block_attention", "two_block_attention_bwd"):
        assert A.LAUNCHES[k] == before[k] + 1
    torch.testing.assert_close(out.float(), A.two_block_attention_plain(
        *qkv, *masks, scale, rate, 5).float(), **TOL[dtype])
    _rel_close(got, A.two_block_attention_bwd_plain(
        *qkv, *masks, g, scale, rate, 5), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=_wide_rate_ids)
@pytest.mark.parametrize("version", [1, 2], ids=["K2", "K6"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dh", list(WIDE_D))
def test_wide_k2_and_k6_match_plain(cuda, dh, shape, dtype, version, rate):
    """K2f / K2b and K6f / K6b at head dims 48, 96 and 128: bf16 on the
    tensor-core pieces (the backward core staging its operands in turns
    past 64), fp32 on the CUDA-core bodies at 48 and past them on the
    projections and K1's tensor-core body ("tf32")."""
    rng = np.random.default_rng(16)
    B, (Lq, L1, L2), d = 8, shape, WIDE_D[dh]
    heads, scale = d // dh, 1 / math.sqrt(dh)
    inputs = _on(cuda, [rng.normal(size=(B, L, d)).astype(np.float32)
                        for L in (Lq, L1, L2)] + _proj_params(rng, d), dtype)
    masks = _on(cuda, _masks_for(rng, B, Lq, L1, L2))
    g = _on(cuda, [rng.normal(size=(B, Lq, d)).astype(np.float32)],
            dtype)[0]
    keys = (("proj_two_block_attention", "proj_two_block_attention_bwd")
            if version == 1 else ("proj_two_block_attention_v2",
                                  "proj_two_block_attention_v2_bwd"))
    leaves = [t.clone().requires_grad_() for t in inputs]
    before = dict(A.LAUNCHES)
    out = A.fused_proj_two_block_attention(
        *leaves, *masks, num_heads=heads, scale=scale, dropout_rate=rate,
        seed=7, deterministic=rate == 0, version=version)
    got = torch.autograd.grad(out, leaves, g)
    for k in keys:
        assert A.LAUNCHES[k] == before[k] + 1
    plain, plain_bwd = ((A.proj_two_block_attention_plain,
                         A.proj_two_block_attention_bwd_plain)
                        if version == 1 else
                        (A.proj_two_block_attention_v2_plain,
                         A.proj_two_block_attention_v2_bwd_plain))
    torch.testing.assert_close(out.float(), plain(
        *inputs, *masks, heads, scale, rate, 7).float(), **TOL[dtype])
    _rel_close(got, plain_bwd(*inputs, *masks, g, heads, scale, rate, 7),
               dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=_wide_rate_ids)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(40, 100), (100, 40), (100, 100),
                                   (40, 1), (1, 40)])
@pytest.mark.parametrize("dh", list(WIDE_D))
def test_wide_k3_matches_plain(cuda, dh, shape, dtype, rate):
    """K3f and K3b at head dims 48, 96 and 128 at CrossAtt's and SelfAtt's
    shapes (fp32 in query windows where one block's tiles exceed shared
    memory)."""
    rng = np.random.default_rng(17)
    B, (Lq, Lk), heads = 8, shape, WIDE_D[dh] // dh
    scale = 1 / math.sqrt(dh)
    q, k, v, g = _on(cuda, [rng.normal(size=(B, L, heads, dh)).astype(
        np.float32) for L in (Lq, Lk, Lk, Lq)], dtype)
    masks = _on(cuda, (_masks(rng, B, Lq, Lq > 1), _masks(rng, B, Lk, False)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(A.LAUNCHES)
    out = A.fused_masked_attention(*leaves, *masks, scale=scale,
                                   dropout_rate=rate, seed=9,
                                   deterministic=rate == 0)
    got = torch.autograd.grad(out, leaves, g)
    for key in ("masked_attention", "masked_attention_bwd"):
        assert A.LAUNCHES[key] == before[key] + 1
    torch.testing.assert_close(out.float(), A.masked_attention_plain(
        q, k, v, *masks, scale, rate, 9).float(), **TOL[dtype])
    _rel_close(got, A.masked_attention_bwd_plain(
        q, k, v, *masks, g, scale, rate, 9), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=_wide_rate_ids)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", [(40, 100), (100, 40)])
@pytest.mark.parametrize("dh", list(WIDE_D))
def test_wide_k5_matches_plain(cuda, dh, lengths, dtype, rate):
    """K5f and K5b at head dims 48, 96 and 128 (fp32 past 64: each stream
    on K2's "tf32" body, then the first body's chain)."""
    rng = np.random.default_rng(18)
    B, (Lv, Lu), d = 8, lengths, WIDE_D[dh]
    heads, scale = d // dh, 1 / math.sqrt(dh)
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
        leaves[0], leaves[1], pairs(leaves[2:14]), pairs(leaves[14:]), mv,
        mu, num_heads=heads, scale=scale, dropout_rate=rate, seed=11,
        deterministic=rate == 0)
    got = torch.autograd.grad((ov, ou), leaves, (gv, gu))
    for k in ("dual_stream_attention", "dual_stream_attention_bwd"):
        assert A.LAUNCHES[k] == before[k] + 1
    wv, wu = K5.dual_stream_attention_plain(xv, xu, ws[:12], ws[12:], mv, mu,
                                            heads, scale, rate, 11)
    torch.testing.assert_close(ov.float(), wv.float(), **TOL[dtype])
    torch.testing.assert_close(ou.float(), wu.float(), **TOL[dtype])
    _rel_close(got, K5.dual_stream_attention_bwd_plain(
        xv, xu, ws[:12], ws[12:], mv, mu, gv, gu, heads, scale, rate, 11),
        dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=_wide_rate_ids)
@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("dtype,dh,d", [
    (torch.bfloat16, 128, 512), (torch.bfloat16, 48, 768),
    (torch.bfloat16, 96, 768), (torch.float32, 128, 512),
    (torch.float32, 96, 384), (torch.float32, 48, 384)],
    ids=lambda v: str(v).replace("torch.", ""))
def test_wide_k4_matches_plain(cuda, dtype, dh, d, shape, rate):
    """K4f and K4b at head dims 48, 96 and 128, bf16 also at d = ff = 768
    (the epilogue's 32-row blocks), fp32 at 96 and 128 on K2's "tf32" body
    around its CUDA-core epilogue and chain (fp32 at d 384: its row-tile
    epilogue takes no d = 768)."""
    rng = np.random.default_rng(19)
    B, heads = 8, d // dh
    xs, qkv, ep, masks, g = _k4_inputs(cuda, rng, B, shape, d, d, dtype)
    leaves = [t.clone().requires_grad_() for t in xs + qkv + ep]
    before = dict(A.LAUNCHES)
    out = _k4_call(leaves, masks, heads, rate)
    got = torch.autograd.grad(out, leaves, g)
    for k in ("layer_stream", "layer_stream_bwd"):
        assert A.LAUNCHES[k] == before[k] + 1
    _rel_close([out], [K4.layer_stream_plain(*xs, qkv, ep, *masks, heads,
                                             SCALE, rate, 99)], dtype)
    _rel_close(got, K4.layer_stream_bwd_plain(*xs, qkv, ep, *masks, g,
                                              heads, SCALE, rate, 99), dtype)


# skip_train --nhead 4 (head dim 128): one layer of the model per route,
# fp32, dropout off, a step's forward and backward on the card (the
# routes' kernels) against the CPU (their plain versions)
NHEAD4_ROUTES = {"k1": dict(fused_attention=True),
                 "k2": dict(fused_attention=True, fuse_qkv=True),
                 "k6": dict(fused_attention=True, fuse_qkv=True),
                 "k3-CrossAtt": dict(fused_attention=True,
                                     ablation="CrossAtt"),
                 "k5-fuse_dual": dict(fused_attention=True, fuse_dual=True),
                 "k4-fuse_layer": dict(fuse_layer=True)}
NHEAD4_KERNELS = {"k1": "two_block_attention_bwd",
                  "k2": "proj_two_block_attention_bwd",
                  "k6": "proj_two_block_attention_v2_bwd",
                  "k3-CrossAtt": "masked_attention_bwd",
                  "k5-fuse_dual": "dual_stream_attention_bwd",
                  "k4-fuse_layer": "layer_stream_bwd"}
# a leaf whose CPU gradient stays below this share of the model's largest
# gradient is rounding noise on both devices
NOISE_GRAD = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(NHEAD4_ROUTES))
def test_nhead4_layer_step_on_the_card_matches_the_cpu(cuda, route,
                                                       monkeypatch):
    """The model at d_model 512 with 4 heads, one layer run (two built: it
    reads the last one's input), both modalities (streams of 40 and 100
    segments), B=4: the loss and every parameter's gradient of a step on
    the card within BWD_TOL[fp32] of the CPU's, each relative to its own
    largest CPU value; the route's backward kernel launched on the card.
    A leaf whose CPU gradient stays below NOISE_GRAD of the model's largest
    is rounding noise on both devices and is not held (a key projection's
    bias: zero in exact arithmetic, since the softmax does not see it,
    ~4e-9 on the CPU); the skipped leaves are printed with their norms."""
    from segmminterest_tpu_torch.models.interest import SegInterestModel
    monkeypatch.setattr(A, "ATTN_V2", route == "k6")
    rng = np.random.default_rng(20)
    B, F, LU = 4, 48, 100
    kw = dict(d_model=512, num_heads=4, num_layers=2, ff_dim=512,
              n_users=20, n_items=30, fusion_heads=2, feat_dim=F,
              dropout=0.0, **NHEAD4_ROUTES[route])
    torch.manual_seed(0)
    cpu = SegInterestModel(**kw).train()
    card = SegInterestModel(**kw).train()
    card.load_state_dict(cpu.state_dict())
    card.to(cuda)
    um = np.arange(LU)[None] < rng.integers(1, LU + 1, B)[:, None]
    vm = np.arange(40)[None] < rng.integers(1, 41, B)[:, None]
    args = (rng.normal(size=(B, LU, F)).astype(np.float32),
            rng.integers(1, 21, B).astype(np.int32), um,
            rng.normal(size=(B, 40, F)).astype(np.float32),
            rng.integers(1, 31, B).astype(np.int32), vm)
    w = torch.from_numpy(rng.normal(size=(B, 40)).astype(np.float32))
    grads, losses = {}, {}
    for name, model, dev in (("cpu", cpu, torch.device("cpu")),
                             ("cuda", card, cuda)):
        A.reset_launch_counts()
        loss = (model(*(torch.from_numpy(a).to(dev) for a in args))
                * w.to(dev)).sum()
        loss.backward()
        losses[name] = loss.item()
        grads[name] = {n: p.grad.float().cpu()
                       for n, p in model.named_parameters()
                       if p.grad is not None}
        launched = A.LAUNCHES[NHEAD4_KERNELS[route]]
        assert launched > 0 if name == "cuda" else launched == 0
    assert abs(losses["cuda"] - losses["cpu"]) <= \
        BWD_TOL[torch.float32] * abs(losses["cpu"])
    assert set(grads["cuda"]) == set(grads["cpu"])
    largest = max(g.abs().max().item() for g in grads["cpu"].values())
    bad, skipped = [], []
    for n, want in sorted(grads["cpu"].items()):
        got = grads["cuda"][n]
        assert torch.isfinite(got).all(), n
        top = want.abs().max().item()
        if top < NOISE_GRAD * largest:
            skipped.append(f"{n} (cpu {want.norm():.3g}, card "
                           f"{got.norm():.3g})")
            continue
        err = (got - want).abs().max().item() / top
        if err > BWD_TOL[torch.float32]:
            bad.append(f"{n}: {err:.3g} of its largest {top:.3g}")
    print(f"{route}: leaves not held (below {NOISE_GRAD} of the largest "
          f"gradient {largest:.3g}): {skipped}")
    assert not bad, bad
