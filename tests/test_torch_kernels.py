"""K1 and K2 on the card against their plain PyTorch versions, on the same
seeded inputs, at the flagship width (16 heads of 32, d=512) and the four
(Lq, L1, L2) stream shapes of a both/both layer, with padded query and key
rows, in fp32 and bf16. Each launch must add one to its kernel's count.

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
