"""K1 and K2 (segmminterest_tpu_torch/core/attention.py) against the JAX
Pallas kernels run through the interpreter, on the same seeded inputs, at
the four (Lq, L1, L2) stream shapes of a both/both layer, with padded query
and key rows. fp32 tolerance 2e-5, as tests/test_fused_attention.py holds
the TPU kernels to their reference: the same products summed in another
order. The kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.core.attention import (fused_proj_two_block_attention
                                              as jax_k2,
                                              fused_two_block_attention
                                              as jax_k1)
from segmminterest_tpu_torch.core import attention as A

SHAPES = [(40, 40, 100), (100, 40, 100), (40, 40, 1), (1, 40, 1)]
TOL = dict(atol=2e-5, rtol=2e-5)


def _masks(rng, B, L, empty_row):
    m = np.zeros((B, L), bool)
    for i in range(B):
        m[i, :rng.integers(1, L + 1)] = True
    if empty_row:
        m[0] = False  # a fully padded row
    return m


def _k1_inputs(rng, B, Lq, L1, L2, H=2, Dh=32):
    def r(L):
        return rng.normal(size=(B, L, H, Dh)).astype(np.float32)
    arrays = (r(Lq), r(Lq), r(L1), r(L2), r(L1), r(L2))
    masks = (_masks(rng, B, Lq, True), _masks(rng, B, L1, False),
             _masks(rng, B, L2, Lq > 1))
    return arrays, masks


def _k2_inputs(rng, B, Lq, L1, L2, d=64):
    def x(L):
        return rng.normal(size=(B, L, d)).astype(np.float32)
    ws = []
    for _ in range(6):
        ws += [(rng.normal(size=(d, d)) / math.sqrt(d)).astype(np.float32),
               (0.1 * rng.normal(size=d)).astype(np.float32)]
    masks = (_masks(rng, B, Lq, True), _masks(rng, B, L1, False),
             _masks(rng, B, L2, Lq > 1))
    return (x(Lq), x(L1), x(L2)), ws, masks


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_plain_matches_jax_kernel(rng, shape):
    arrays, masks = _k1_inputs(rng, 3, *shape)
    want = jax_k1(*map(jnp.asarray, arrays + masks), interpret=True)
    got = A.fused_two_block_attention(*map(_t, arrays + masks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_plain_matches_jax_kernel(rng, shape):
    xs, ws, masks = _k2_inputs(rng, 3, *shape)
    want = jax_k2(*map(jnp.asarray, xs + tuple(ws) + masks), num_heads=2,
                  interpret=True, version=1)
    # the port takes nn.Linear weights (out, in); flax kernels are (in, out)
    ws_t = [_t(w.T) if w.ndim == 2 else _t(w) for w in ws]
    got = A.fused_proj_two_block_attention(
        *map(_t, xs), *ws_t, *map(_t, masks), num_heads=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_padded_query_row_is_uniform(rng):
    """A fully padded query row is the uniform softmax over all L1+L2 keys,
    not zero (tests/test_fused_attention.py:91 for the TPU kernel)."""
    arrays, masks = _k1_inputs(rng, 2, 5, 4, 3)
    got = A.fused_two_block_attention(*map(_t, arrays + masks))
    v = np.concatenate([arrays[4], arrays[5]], axis=1)
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(
        v[0].mean(0), got[0].shape), atol=1e-6)


def test_forward_only_guards(rng):
    """The wrappers are no longer forward only: training-mode dropout runs
    and inputs that require grad get gradients (K1b on the card, the plain
    backward here). What stays guarded is a dropout rate outside [0, 1)."""
    arrays, masks = _k1_inputs(rng, 2, 5, 4, 3)
    ts = [_t(a) for a in arrays]
    out = A.fused_two_block_attention(*ts, *map(_t, masks), dropout_rate=0.1,
                                      deterministic=False, seed=3)
    assert torch.isfinite(out).all()
    ts[0].requires_grad_(True)
    A.fused_two_block_attention(*ts, *map(_t, masks)).sum().backward()
    assert ts[0].grad is not None and torch.isfinite(ts[0].grad).all()
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError):
            A.fused_two_block_attention(*ts, *map(_t, masks),
                                        dropout_rate=bad, deterministic=False)


def test_cpu_tensors_launch_nothing(rng):
    """The plain versions run only because the tensors lie on the CPU: no
    kernel is counted, and any other device that is not CUDA raises."""
    arrays, masks = _k1_inputs(rng, 2, 5, 4, 3)
    xs, ws, xmasks = _k2_inputs(rng, 2, 5, 4, 3)
    before = dict(A.LAUNCHES)
    A.fused_two_block_attention(*map(_t, arrays + masks))
    A.fused_proj_two_block_attention(*map(_t, xs + tuple(ws) + xmasks),
                                     num_heads=2)
    assert A.LAUNCHES == before
    meta = [torch.empty(a.shape, device="meta") for a in arrays]
    with pytest.raises(ValueError):
        A.fused_two_block_attention(*meta, *map(_t, masks))
