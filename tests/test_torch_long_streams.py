"""The port at stream lengths past the card core's one-chunk shapes and at a
layer width past the bf16 epilogue's: on the CPU the wrappers run their
plain versions, which hold the function that the key-chunk path
(core/csrc/two_block_chunked.cu) computes on the card. Each is held
against the JAX Pallas kernel run through the interpreter and its
``jax.vjp`` (the JAX kernels take whole arrays as blocks, so any length),
on the same seeded inputs, 2 heads of 16, B=2:

* K1 at streams (200, 150, 300) and (1, 300, 7) and K3 at (200, 300) and
  (1, 300), dropout off and on; K2 (version 1) and K4 at the first with
  dropout and the second without; forward and every gradient, with the
  tolerances of tests/test_torch_attention_bwd.py, test_torch_masked_
  attention.py and test_torch_layer_kernel.py;
* K4 at d = ff = 1024 (8 heads of 128) at a short stream, with dropout;
* every shape rule takes lengths up to 600 in both dtypes (K1, K2 through
  ``_check_k2`` and so K4, K5, K6, K3 through ``k3_takes``) and names the
  key-chunk path where the one-chunk body does not fit, at every head dim
  the cores take; K4's epilogue takes every width up to 1024.

The kernels themselves are held against these plain versions at long
streams on the card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.core import layer_kernel as JLK
from segmminterest_tpu.core.attention import (fused_masked_attention
                                              as jax_k3,
                                              fused_proj_two_block_attention
                                              as jax_k2,
                                              fused_two_block_attention
                                              as jax_k1)
from segmminterest_tpu_torch.core import attention as A
from segmminterest_tpu_torch.core import layer_kernel as LK

H, DH = 2, 16
D = H * DH
B = 2
SEED, RATE = 2024, 0.3
LONG = [(200, 150, 300), (1, 300, 7)]
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_RTOL = 1e-5
# test_torch_layer_kernel.py's, for K4
K4_FWD_TOL = dict(rtol=2e-4, atol=2e-5)
K4_GRAD_TOL = dict(rtol=6e-4, atol=6e-4)


def _mask(rng, L, empty_row):
    m = np.zeros((B, L), bool)
    for i in range(B):
        m[i, :rng.integers(1, L + 1)] = True
    if empty_row and L > 1:
        m[0] = False  # a fully padded row
    return m


def _masks(rng, Lq, L1, L2):
    return _mask(rng, Lq, True), _mask(rng, L1, False), _mask(rng, L2, True)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _drop_kw(drop):
    return dict(dropout_rate=RATE if drop else 0.0, deterministic=not drop)


def _close_grads(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= GRAD_RTOL, f"gradient {i}: relative error {err:.3g}"


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("shape", LONG)
def test_k1_long_streams_match_jax_vjp(rng, shape, drop):
    Lq, L1, L2 = shape
    arrays = [rng.normal(size=(B, L, H, DH)).astype(np.float32)
              for L in (Lq, Lq, L1, L2, L1, L2)]
    masks = _masks(rng, *shape)
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


@pytest.mark.parametrize("shape,drop", [(LONG[0], True), (LONG[1], False)],
                         ids=["long-dropout", "one-query-eval"])
def test_k2_long_streams_match_jax_vjp(rng, shape, drop):
    Lq, L1, L2 = shape
    xs = [rng.normal(size=(B, L, D)).astype(np.float32) for L in shape]
    ws = []
    for _ in range(6):  # flax layout: kernel (in, out), bias (out,)
        ws += [(rng.normal(size=(D, D)) / math.sqrt(D)).astype(np.float32),
               (0.1 * rng.normal(size=D)).astype(np.float32)]
    masks = _masks(rng, *shape)
    g = rng.normal(size=(B, Lq, D)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_k2(
        *a, *map(jnp.asarray, masks), num_heads=H,
        seed=jnp.asarray([SEED], jnp.int32), interpret=True, version=1,
        **_drop_kw(drop)), *map(jnp.asarray, xs + ws))
    tx = [_t(x, True) for x in xs]
    tw = [_t(w.T if w.ndim == 2 else w, True) for w in ws]
    got = A.fused_proj_two_block_attention(*tx, *tw, *map(_t, masks),
                                           num_heads=H, seed=SEED, version=1,
                                           **_drop_kw(drop))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **FWD_TOL)
    got.backward(_t(g))
    grads = [t.grad.numpy() for t in tx] + [
        t.grad.numpy().T if t.ndim == 2 else t.grad.numpy() for t in tw]
    _close_grads(grads, vjp(jnp.asarray(g)))


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("shape", [(200, 300), (1, 300)])
def test_k3_long_streams_match_jax_vjp(rng, shape, drop):
    Lq, Lk = shape
    arrays = [rng.normal(size=(B, L, H, DH)).astype(np.float32)
              for L in (Lq, Lk, Lk)]
    masks = (_mask(rng, Lq, True), _mask(rng, Lk, False))
    g = rng.normal(size=(B, Lq, H, DH)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_k3(
        *a, *map(jnp.asarray, masks), seed=jnp.asarray([SEED], jnp.int32),
        interpret=True, **_drop_kw(drop)), *map(jnp.asarray, arrays))
    ts = [_t(a, True) for a in arrays]
    got = A.fused_masked_attention(*ts, *map(_t, masks), seed=SEED,
                                   **_drop_kw(drop))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **FWD_TOL)
    got.backward(_t(g))
    _close_grads([t.grad.numpy() for t in ts], vjp(jnp.asarray(g)))


def _k4_case(rng, Lq, L1, L2, d, ff):
    """Inputs in flax layout, as tests/test_torch_layer_kernel.py draws
    them."""
    mk = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)  # noqa
    xq, x1, x2 = mk(B, Lq, d), mk(B, L1, d), mk(B, L2, d)
    qkv = [(mk(d, d), mk(d)) for _ in range(6)]
    ep = [mk(d, d), mk(d), mk(d) + 1.0, mk(d), mk(d, ff), mk(ff), mk(ff, d),
          mk(d), mk(d) + 1.0, mk(d)]
    masks = list(_masks(rng, Lq, L1, L2))
    return xq, x1, x2, qkv, ep, masks


@pytest.mark.parametrize("shape,d,heads,drop", [
    (LONG[0], D, H, True), (LONG[1], D, H, False),
    ((4, 4, 3), 1024, 8, True)], ids=["long-dropout", "one-query-eval",
                                      "d1024-dropout"])
def test_k4_long_streams_and_wide_layers_match_jax_vjp(rng, shape, d, heads,
                                                       drop):
    """K4 at the long streams (d = ff = 32) and at d = ff = 1024 (past the
    bf16 epilogue's 768 and the fp32 one's 512 on the card)."""
    Lq, L1, L2 = shape
    xq, x1, x2, qkv, ep, masks = _k4_case(rng, Lq, L1, L2, d, d)
    g = rng.normal(size=(B, Lq, d)).astype(np.float32)
    jq = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in qkv)
    out, vjp = jax.vjp(
        lambda xq, x1, x2, qkv, ep: JLK.fused_layer_stream(
            xq, x1, x2, qkv, ep, *map(jnp.asarray, masks), num_heads=heads,
            seed=jnp.asarray([SEED], jnp.int32), interpret=True,
            **_drop_kw(drop)),
        jnp.asarray(xq), jnp.asarray(x1), jnp.asarray(x2), jq,
        tuple(map(jnp.asarray, ep)))
    jd = vjp(jnp.asarray(g))
    tx = [_t(a, True) for a in (xq, x1, x2)]
    pq = [(_t(w.T, True), _t(b, True)) for w, b in qkv]
    pe = [_t(p.T if p.ndim == 2 else p, True) for p in ep]
    got = LK.fused_layer_stream(*tx, pq, pe, *map(_t, masks), num_heads=heads,
                                seed=SEED, **_drop_kw(drop))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **K4_FWD_TOL)
    got.backward(_t(g))
    for t, want in zip(tx, jd[:3]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   **K4_GRAD_TOL)
    for (w, b), (jw, jb) in zip(pq, jd[3]):
        np.testing.assert_allclose(w.grad.numpy().T, np.asarray(jw),
                                   **K4_GRAD_TOL)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(jb),
                                   **K4_GRAD_TOL)
    for p, want in zip(pe, jd[4]):
        gp = p.grad.numpy()
        np.testing.assert_allclose(gp.T if gp.ndim == 2 else gp,
                                   np.asarray(want), **K4_GRAD_TOL)


# --- the rules at every length ---------------------------------------------

RULE_LENGTHS = (1, 100, 129, 300, 600)


def _k2_tensors(dtype, Lq, L1, L2, d):
    xs = tuple(torch.zeros(2, L, d, dtype=dtype) for L in (Lq, L1, L2))
    ws = tuple(t for _ in range(6) for t in (torch.zeros(d, d, dtype=dtype),
                                             torch.zeros(d, dtype=dtype)))
    masks = tuple(torch.ones(2, L, dtype=torch.bool) for L in (Lq, L1, L2))
    return xs + ws, masks


@pytest.mark.parametrize("Dh", A.K2_HEAD_DIMS)
def test_bf16_rules_take_every_length(Dh):
    """bf16 K1 and K2 (whose check K4, K5 and K6 share) take every length
    up to 600 in both directions, on the core in one chunk where
    ``k2_core_whole`` says so (its register tile and one block's shared
    memory hold the shape) and on the key-chunk path elsewhere, whose
    block fits shared memory at every head dim; bf16 K3 takes every length
    too, on its own body up to 128 where that fits, else on the core."""
    for bwd in (False, True):
        for g32 in (False, True) if bwd else (False,):
            assert A.k2_chunked_smem_bytes(Dh, bwd, g32) <= A.MAX_SMEM_BYTES
    chunked = 0
    d = 4 * Dh
    for Lq in RULE_LENGTHS:
        for L1 in RULE_LENGTHS:
            for L2 in RULE_LENGTHS:
                for bwd in (False, True):
                    assert A.k1_body(torch.bfloat16, Lq, L1, L2, Dh,
                                     bwd) == "mma"
                    whole = A.k2_core_whole(Lq, L1, L2, Dh, bwd)
                    chunked += not whole
                    if whole:
                        assert A._pad16(A._pad8(L1) + L2) // 16 <= \
                            A.K2_CORE_TILES[Dh]
                        assert A.k2_core_smem_bytes(Lq, L1, L2, Dh, bwd) == \
                            A.k2_mma_smem_bytes(Lq, L1, L2, Dh, bwd)
                    assert A.k2_core_smem_bytes(Lq, L1, L2, Dh, bwd) <= \
                        A.MAX_SMEM_BYTES
            ts, masks = _k2_tensors(torch.bfloat16, Lq, L1, Lq, d)
            assert A._check_k2(ts, masks, 4)[-1] == Dh
            for bwd in (False, True):
                body = A.k3_takes(torch.bfloat16, Lq, L1, Dh, bwd)
                assert body == ("mma" if max(Lq, L1) <= A.K3_MAX_LEN and
                                A.k3_mma_smem_bytes(Lq, L1, Dh, bwd)
                                <= A.MAX_SMEM_BYTES else "core")
    assert chunked > 0
    # the model's streams stay in one chunk
    for shape in ((40, 40, 100), (100, 40, 100), (40, 40, 1), (1, 40, 1)):
        assert A.k2_core_whole(*shape, Dh, True, g_fp32=True)


@pytest.mark.parametrize("D", [16, 32, 64, 96, 128])
def test_fp32_rules_and_k4_widths_take_every_length(D):
    """fp32 K1 and K3 (and so fp32 K2, K4, K5, K6 through K1's rule) take
    every length up to 600 on the 3xTF32 core, in one chunk where
    ``tf32_whole`` says so (the register tile, a query window in one block,
    lengths up to 128 for K1b and K3) and on its key-chunk path elsewhere;
    K4's epilogue takes every width up to 1024 in both dtypes, with as
    many rows a block as fit (fp32 past 512, bf16 past 768: the row-tile
    epilogue)."""
    chunked = 0
    for Lq in RULE_LENGTHS:
        for L1 in RULE_LENGTHS:
            for bwd in (False, True):
                assert A.k3_takes(torch.float32, Lq, L1, D, bwd) == "tf32"
                for L2 in RULE_LENGTHS:
                    assert A.k1_body(torch.float32, Lq, L1, L2, D,
                                     bwd) == "tf32"
                    whole = A.tf32_whole(Lq, (L1, L2), D, bwd)
                    chunked += not whole
                    if whole:
                        assert A.tf32_window(Lq, (L1, L2), D, bwd) > 0
                        assert bwd is False or max(Lq, L1, L2) <= 128
    assert chunked > 0
    for w in (32, 256, 512, 544, 768, 800, 1024):
        for dt in (torch.float32, torch.bfloat16):
            for bwd in (False, True):
                rows = LK.k4_epilogue_rows(dt, w, w, bwd)
                if dt == torch.bfloat16 and w <= LK.K4_MMA_MAX_WIDTH:
                    assert rows == LK.k4_mma_rows(w, w)
                    continue
                assert rows in ((LK.K4_BWD_ROWS if bwd else LK.K4_FWD_ROWS),
                                *LK.K4_NARROW_ROWS)
                assert LK.k4_rowtile_smem_bytes(dt, w, w, rows, bwd) <= \
                    A.MAX_SMEM_BYTES
                if w <= 512 and dt == torch.float32:
                    assert rows == (LK.K4_BWD_ROWS if bwd else LK.K4_FWD_ROWS)
