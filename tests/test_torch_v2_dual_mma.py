"""The arithmetic of bf16 K6b and K5b on K2b's tensor-core pieces
(segmminterest_tpu_torch/core/csrc/proj_two_block_attention_v2_bwd.cu,
dual_stream_attention_bwd.cu over proj_gemm.cuh and two_block_mma.cuh),
emulated on the CPU, and the wrappers' rules around them.

* The core's dropout keys. K2's core lays both key blocks on one padded
  axis (block 2 from c1 = pad8(L1)). K6's mode (kConcatKeys) hashes block
  2's column j as key L1 + (j - c1) with salt h; unpacked, its bits are
  ``dropout_keep`` over the concatenated keys with salt h, as K6's plain
  version draws them. K5's user stream counts its salts from head H (K2's
  mode, 2 (H + h) + block); its bits are ``dropout_keep`` with
  ``head_offset=num_heads``. The hash is written here again from the JAX
  kernel's formula (attention.py:114-123), apart from the port's.
* K6b through K2's layout: the projections with the (d, d) weights as they
  are, the joint backward with K6's keep bits, K2b's chain: at fp32 within
  1e-6 of ``proj_two_block_attention_v2_bwd_plain`` (dxq as dq1 . Wq1 +
  dq2 . Wq2, dWq1 and dWq2 with nothing de-interleaved).
* K5b's job lists: dxv and dxu each one accumulator over six products,
  the 12 dW over their sources, dy in three bf16 parts: within 1e-6 of the
  exact (fp64) products of the same job lists, and so of
  ``dual_stream_attention_bwd_plain``, whose own fp32 sums sit within 2e-6
  of exact (the same split of the check as K2b's chain,
  tests/test_torch_proj_attention.py).
* ``k6_body`` and ``k5_body`` pick by dtype; the wrappers hand the bf16
  bodies their workspaces and dW's row chunks; K5b's chunk rule covers
  every row within the kernel's table.
"""

import contextlib
import ctypes
import math

import numpy as np
import pytest
import torch

from segmminterest_tpu_torch.core import attention as A
from segmminterest_tpu_torch.core import dual_kernel as K5

H, DH = 2, 32
D = H * DH
SEED, RATE = 4321, 0.1
# (Lq, L1, L2): the stream shapes of a both/both layer, and blocks that are
# not multiples of 8
SHAPES = [(40, 40, 100), (100, 40, 100), (40, 40, 1), (1, 40, 1),
          (7, 13, 9), (12, 12, 40)]


def _hash_keep(B, Lq, keys, salts, seed, rate):
    """The JAX kernel's interpret-mode keep bit (attention.py:114-123) for
    batch rows 0..B-1, query rows 0..Lq-1, the key indices ``keys`` (K,)
    and one salt a head ``salts`` (H,): (B, H, Lq, K) bool, in uint32
    numpy arithmetic."""
    u32 = np.uint32
    bt = 8 if B % 8 == 0 else B
    b = np.arange(B, dtype=np.uint64)
    with np.errstate(over="ignore"):
        row = ((b % bt) * 2654435761 % 2 ** 32).astype(u32)
        col = (np.arange(Lq, dtype=np.uint64) * 40503 % 2 ** 32).astype(u32)
        key = (np.asarray(keys, np.uint64) * 69069 % 2 ** 32).astype(u32)
        sv = ((seed + b // bt) % 2 ** 32 * 2246822519 % 2 ** 32).astype(u32)
        st = (np.asarray(salts, np.uint64) * 3266489917 % 2 ** 32).astype(u32)
        h = ((row[:, None, None, None] ^ col[None, None, :, None]
              ^ key[None, None, None, :])
             + sv[:, None, None, None] + st[None, :, None, None])
        h = (h ^ (h >> u32(15))) * u32(2246822519)
        h = h ^ (h >> u32(13))
    u = (h >> u32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))
    return u >= np.float32(rate)


def _core_keep(B, Lq, L1, L2, seed, rate, concat, head0=0):
    """The keep bits bf16 K2b's core draws (two_block_mma.cuh k2_key /
    k2_keep_bits) on its padded key axis of pad16(c1 + L2) columns, c1 =
    pad8(L1): column j < c1 is block 1's key j, j >= c1 block 2's key
    j - c1; nothing past a block's length. K2's mode hashes the key within
    its block with salt 2 (head0 + h) + block; K6's (``concat``) hashes
    block 2's key as L1 + (j - c1), every key with salt h. Returns the
    (B, H, Lq, L1) and (B, H, Lq, L2) bits of the two blocks, read back
    off the axis."""
    c1 = (L1 + 7) // 8 * 8
    n = (c1 + L2 + 15) // 16 * 16
    axis = np.zeros((B, H, Lq, n), bool)
    for j in range(n):
        second = j >= c1
        jj = j - c1 if second else j
        if jj >= (L2 if second else L1):
            continue
        if concat:
            hj, salts = (L1 + jj if second else jj), np.arange(H)
        else:
            hj, salts = jj, 2 * (head0 + np.arange(H)) + int(second)
        axis[..., j] = _hash_keep(B, Lq, [hj], salts, seed, rate)[..., 0]
    return (torch.from_numpy(axis[..., :L1].copy()),
            torch.from_numpy(axis[..., c1:c1 + L2].copy()))


@pytest.mark.parametrize("shape", [(40, 40, 100), (7, 13, 9), (3, 5, 128)])
@pytest.mark.parametrize("B", [8, 3])
def test_k6_concat_keys_are_dropout_keep_over_the_concatenated_keys(shape,
                                                                    B):
    """K6's mode on the padded axis, unpacked, is dropout_keep over the
    concatenated keys with salt h (what K6's plain version draws), with L1
    a multiple of 8 and not; K2's mode is K2's bits."""
    Lq, L1, L2 = shape
    k1, k2 = _core_keep(B, Lq, L1, L2, SEED, RATE, concat=True)
    want = A.dropout_keep(B, H, Lq, L1 + L2, SEED, 0, RATE, "cpu",
                          salt_stride=1)
    assert torch.equal(k1, want[..., :L1])
    assert torch.equal(k2, want[..., L1:])
    b1, b2 = _core_keep(B, Lq, L1, L2, SEED, RATE, concat=False)
    q = torch.zeros(B, Lq, H, DH)
    w1, w2 = A._keeps(q, L1, L2, RATE, SEED)
    assert torch.equal(b1, w1) and torch.equal(b2, w2)
    # the two modes draw other bits
    assert not torch.equal(k2, b2)


@pytest.mark.parametrize("shape", [(40, 40, 100), (100, 13, 9)])
def test_k5_user_stream_salts_are_head_offset_h(shape):
    """K5's user stream (salts from head H) on the padded axis equals
    dropout_keep with head_offset=num_heads, block by block."""
    B, (Lq, L1, L2) = 8, shape
    b1, b2 = _core_keep(B, Lq, L1, L2, SEED, RATE, concat=False, head0=H)
    for blk, L, got in ((0, L1, b1), (1, L2, b2)):
        want = A.dropout_keep(B, H, Lq, L, SEED, blk, RATE, "cpu",
                              head_offset=H)
        assert torch.equal(got, want)


def _bf16_values(a):
    """fp32 tensors holding bf16 values, as the kernels' x and W are."""
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float()


def _params(rng, n):
    ws = []
    for _ in range(n):
        ws += [_bf16_values((rng.normal(size=(D, D)) / math.sqrt(D)).astype(
                   np.float32)),
               _bf16_values((0.1 * rng.normal(size=D)).astype(np.float32))]
    return ws


def _mask(rng, B, L, empty):
    m = np.zeros((B, L), bool)
    for i in range(B):
        m[i, :rng.integers(1, L + 1)] = True
    if empty:
        m[0] = False
    return torch.from_numpy(m)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("shape", SHAPES)
def test_k6b_through_k2_layout_matches_v2_plain(rng, shape, drop):
    """At fp32, K6b as its bf16 body computes it (K2's projections of the
    (d, d) weights, the joint backward with the core's K6-mode keep bits,
    K2b's chain) gives K6b's fifteen gradients within 1e-6 of
    proj_two_block_attention_v2_bwd_plain, which forms, multiplies and
    de-interleaves the interleaved weights."""
    B, (Lq, L1, L2) = 8, shape
    xs = [_bf16_values(rng.normal(size=(B, L, D)).astype(np.float32))
          for L in (Lq, L1, L2)]
    ws = _params(rng, 6)
    masks = [_mask(rng, B, Lq, True), _mask(rng, B, L1, False),
             _mask(rng, B, L2, Lq > 1)]
    g = torch.from_numpy(rng.normal(size=(B, Lq, D)).astype(np.float32))
    rate, scale = (RATE if drop else 0.0), 1 / math.sqrt(DH)
    keeps = (_core_keep(B, Lq, L1, L2, SEED, rate, concat=True) if drop
             else (None, None))
    grads = A._joint_bwd_plain(*A._projections(*xs, ws, H), *masks,
                               A._heads(g, H), scale, rate, SEED,
                               keeps=keeps)
    dys = [t.reshape(B, t.shape[1], D) for t in grads]
    got = A._chain_grads(*xs, ws, dys)
    want = A.proj_two_block_attention_v2_bwd_plain(*xs, *ws, *masks, g, H,
                                                   scale, rate, SEED)
    names = ["dxq", "dx1", "dx2"] + [f"{n}{w}" for w in
                                     ("q1", "q2", "k1", "k2", "v1", "v2")
                                     for n in ("dW", "db")]
    for name, a, b in zip(names, got, want):
        assert _rel(a, b) <= 1e-6, f"{name}: relative error {_rel(a, b):.3g}"


def _split3(x):
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    return hi, mid, (x - hi - mid).bfloat16().float()


def _mm3(pairs, parts=_split3):
    """sum_p a_p . b_p with each fp32 a_p in three bf16 parts, lo . b first,
    every product into one fp32 sum (one product over the parts laid side
    by side along k), in the pairs' order, as chain_dx_kernel's and
    chain_dw_kernel's accumulator takes them; with ``parts`` the identity
    in fp64, the exact sum."""
    a = torch.cat([t for x, _ in pairs for t in parts(x)[::-1]], -1)
    b = torch.cat([y for _, y in pairs for _ in parts(y[:1])], 0)
    return a @ b


# K5b's job lists as dual_stream_attention_bwd.cu builds them: per stream
# (a video, b user) the gradients' index in q1 q2 k1 k2 v1 v2 order
DX_PAIRS = {"dxv": [("a", 0), ("a", 1), ("a", 2), ("a", 4), ("b", 2),
                    ("b", 4)],
            "dxu": [("b", 0), ("b", 1), ("a", 3), ("a", 5), ("b", 3),
                    ("b", 5)]}
DW_SRC = {"a": "vvvuvu", "b": "uuvuvu"}


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("lengths", [(40, 100), (100, 40), (9, 13)])
def test_k5b_job_lists_match_plain(rng, lengths, drop):
    """dxv and dxu as one accumulator over the six pairs of K5b's dx jobs,
    and the 12 dW and db over their jobs' sources, each product from dy's
    three bf16 parts: within 1e-6 (relative to each output's largest
    entry) of the same job lists' exact sums, which
    dual_stream_attention_bwd_plain's fp32 sums meet within 2e-6."""
    B, (Lv, Lu) = 8, lengths
    xv, xu = (_bf16_values(rng.normal(size=(B, L, D)).astype(np.float32))
              for L in (Lv, Lu))
    ws = {"a": _params(rng, 6), "b": _params(rng, 6)}
    mv, mu = _mask(rng, B, Lv, False), _mask(rng, B, Lu, True)
    gv, gu = (torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32))
              for L in (Lv, Lu))
    rate, scale = (RATE if drop else 0.0), 1 / math.sqrt(DH)
    dys = {"a": A.proj_qkv_grads_plain(xv, xv, xu, ws["a"], (mv, mv, mu), gv,
                                       H, scale, rate, SEED),
           "b": A.proj_qkv_grads_plain(xu, xv, xu, ws["b"], (mu, mv, mu), gu,
                                       H, scale, rate, SEED, head_offset=H)}
    x = {"v": xv, "u": xu}

    def jobs(cast, parts):
        out = [_mm3([(cast(dys[s][i]), cast(ws[s][2 * i]))
                     for s, i in DX_PAIRS[n]], parts)
               for n in ("dxv", "dxu")]
        for s in "ab":
            for i in range(6):
                dy = cast(dys[s][i].reshape(-1, D))
                out += [_mm3([(dy.t(), cast(x[DW_SRC[s][i]].reshape(-1, D)))],
                             parts), dy.sum(0)]
        return out
    got = jobs(lambda t: t, _split3)
    exact = jobs(torch.Tensor.double, lambda t: (t,))
    want = K5.dual_stream_attention_bwd_plain(xv, xu, ws["a"], ws["b"], mv,
                                              mu, gv, gu, H, scale, rate,
                                              SEED)
    names = ["dxv", "dxu"] + [f"{s} {n}{w}" for s in "ab"
                              for w in ("q1", "q2", "k1", "k2", "v1", "v2")
                              for n in ("dW", "db")]
    for name, a, e, p in zip(names, got, exact, want):
        err, floor = _rel(a.double(), e), _rel(p.double(), e)
        assert floor <= 2e-6, f"{name}: the fp32 plain is {floor:.3g} off"
        assert err <= 1e-6, \
            f"{name}: relative error {err:.3g} (fp32 plain {floor:.3g})"


def test_k6_and_k5_bodies_by_dtype():
    assert A.k6_body(torch.bfloat16) == "mma"
    assert A.k6_body(torch.float32) == "tf32"
    assert K5.k5_body(torch.bfloat16) == "mma"
    assert K5.k5_body(torch.float32) == "tf32"


@pytest.mark.parametrize("B", [1, 7, 16, 1024, 65535])
def test_k5_dw_chunks_cover_every_row(B):
    for Lv, Lu in ((40, 100), (100, 40), (2, 2), (128, 128), (3, 128)):
        chunk = K5.k5_dw_chunk(B, Lv, Lu)
        counts = K5.k5_dw_chunks(B, Lv, Lu, chunk)
        assert chunk % 32 == 0 and chunk > 0
        assert len(counts) == 12
        assert sum(counts) <= A.K2_DW_MAX_CHUNKS
        for n, M in zip(counts, K5.k5_dw_rows(B, Lv, Lu)):
            assert (n - 1) * chunk < M <= n * chunk


def test_k5_workspace_layout():
    xv = torch.zeros(3, 5, D, dtype=torch.bfloat16)
    xu = torch.zeros(3, 7, D, dtype=torch.bfloat16)
    work = K5.k5_workspace(xv, xu)
    assert [tuple(w.shape) for w in work] == [
        (3, L, 2 * D) for L in (5, 5, 7, 7, 5, 7)]
    assert all(w.dtype == torch.bfloat16 and w.is_contiguous()
               for w in work)


class _FakeLib:
    """Stands in for the kernels' C functions: records each call's
    arguments and reports success."""

    def __init__(self):
        self.calls = {}

    def __call__(self, lib, symbol, restype, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), symbol
            self.calls[symbol] = args
            return 1024 if restype is ctypes.c_size_t else 0
        return fn


def _n_ptrs(arr):
    return ctypes.sizeof(arr) // ctypes.sizeof(ctypes.c_void_p)


@pytest.fixture
def fake(monkeypatch):
    fake = _FakeLib()
    monkeypatch.setattr(A, "_fn", fake)
    monkeypatch.setattr(A, "_stream_ptr", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return fake


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6b_wrapper_hands_each_body_its_operands(fake, dtype):
    """bf16: the weights as they are (15 pointers), the six K2 gradients,
    a three-tensor workspace, dW's row chunk; the gradients come back in
    K2's layout. fp32: K2's fp32 route with K6's keys (K1b's tensor-core
    body with concat), then K2b's chain, on the weights as they are."""
    B, (Lq, L1, L2) = 4, SHAPES[0]
    xs = [torch.randn(B, L, D, dtype=dtype) for L in (Lq, L1, L2)]
    ws = []
    for _ in range(6):
        ws += [torch.randn(D, D, dtype=dtype), torch.randn(D, dtype=dtype)]
    masks = [torch.ones(B, L, dtype=torch.bool) for L in (Lq, L1, L2)]
    g = torch.randn(B, Lq, D, dtype=dtype)
    grads = A._k6_backward_cuda(*xs, ws, masks, g, H, 0.1, 0.0, 0)
    assert len(grads) == 15
    assert [tuple(t.shape) for t in grads[3:]] == [
        tuple(w.shape) for w in ws]
    if dtype == torch.bfloat16:
        call = fake.calls["segmm_proj_two_block_attention_v2_bwd_mma"]
        assert _n_ptrs(call[0]) == 15
        assert _n_ptrs(call[5]) == 6 and _n_ptrs(call[6]) == 3
        assert _n_ptrs(call[8]) == 12
        assert call[-2] == A.k2_dw_chunk(B, Lq, L1, L2)
        assert "segmm_proj_two_block_attention_v2_bwd" not in fake.calls
    else:
        k1b = fake.calls["segmm_two_block_attention_bwd"]
        assert k1b[0] == 0 and k1b[-2] == 1  # fp32, K6's concatenated keys
        chain = fake.calls["segmm_proj_two_block_attention_chain_bwd"]
        assert chain[0] == 0 and _n_ptrs(chain[1]) == 15
        assert "segmm_proj_two_block_attention_v2_bwd_mma" not in fake.calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5b_wrapper_hands_each_body_its_operands(fake, dtype):
    """bf16: six workspaces, twelve gradients, dW's row chunk of
    k5_dw_chunk; fp32: each stream's qkv pass by K2's fp32 route (the user
    stream's salts from head H), then the chain's entry with twelve
    gradients and K2_DW_SPLITS."""
    B, Lv, Lu = 4, 40, 100
    xv, xu = (torch.randn(B, L, D, dtype=dtype) for L in (Lv, Lu))
    ws = []
    for _ in range(12):
        ws += [torch.randn(D, D, dtype=dtype), torch.randn(D, dtype=dtype)]
    mv, mu = (torch.ones(B, L, dtype=torch.bool) for L in (Lv, Lu))
    gv, gu = (torch.randn(B, L, D, dtype=dtype) for L in (Lv, Lu))
    grads = K5._k5_backward_cuda(xv, xu, ws[:12], ws[12:], mv, mu, gv, gu, H,
                                 0.1, 0.0, 0)
    assert len(grads) == 26
    if dtype == torch.bfloat16:
        call = fake.calls["segmm_dual_stream_attention_bwd_mma"]
        assert _n_ptrs(call[0]) == 26
        assert _n_ptrs(call[5]) == 12 and _n_ptrs(call[6]) == 6
        assert _n_ptrs(call[7]) == 2 and _n_ptrs(call[8]) == 24
        assert call[-2] == K5.k5_dw_chunk(B, Lv, Lu)
    else:
        k1b = fake.calls["segmm_two_block_attention_bwd"]
        assert k1b[0] == 0 and k1b[-3] == H  # the last call: the user stream
        call = fake.calls["segmm_dual_stream_attention_chain_bwd"]
        assert _n_ptrs(call[0]) == 26 and _n_ptrs(call[1]) == 12
        assert _n_ptrs(call[2]) == 2 and _n_ptrs(call[3]) == 24
        assert call[-2] == A.K2_DW_SPLITS
        assert "segmm_dual_stream_attention_bwd_mma" not in fake.calls
