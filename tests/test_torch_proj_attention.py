"""The arithmetic of bf16 K2f and K2b's tensor-core bodies
(segmminterest_tpu_torch/core/csrc/proj_gemm.cuh, two_block_mma.cuh),
emulated on the CPU, and the wrapper's rules around them.

* The chain (dx = dy . W, dW = dy^T x) runs on the bf16 tensor cores with
  dy split into three bf16 parts (hi, mid, lo); x and W are bf16 values,
  exact in bf16, so three products into one fp32 sum give the fp32 product.
  Emulated at the four stream shapes of a both/both layer, dx and dW stay
  within 1e-6 of the exact chain, as the plain fp32 ``_chain_grads``
  does, while one bf16 rounding of dy misses 1e-4: the reason for three
  parts.
* The core backward keeps p and dl as bf16 hi and lo halves; emulated, it
  reproduces ``_joint_bwd_plain`` within 1e-4 (and so within the 3e-2
  that tests/test_torch_kernels.py holds bf16 K2b to on the card).
* ``k2_body`` picks the bodies by dtype; the wrappers hand the bf16 bodies
  their workspace and dW's row chunks, and run fp32 as the projections,
  K1's 3xTF32 body and the CUDA-core chain; the bf16
  core's shared memory takes every shape the CUDA-core bf16 bodies
  (proj_attention.cuh) took; dW's chunks cover every row and stay within the kernel's table.
"""

import contextlib
import ctypes
import math

import numpy as np
import pytest
import torch

from segmminterest_tpu_torch.core import attention as A

SHAPES = [(40, 40, 100), (100, 40, 100), (40, 40, 1), (1, 40, 1)]
H, DH = 2, 32
D = H * DH
SEED, RATE = 12345, 0.1


def _bf16_values(a):
    """fp32 tensors holding bf16 values, as K2b's x and W are."""
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float()


def _split3(x):
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    return hi, mid, (x - hi - mid).bfloat16().float()


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _chain_split(xq, x1, x2, ws, dys, parts):
    """_chain_grads with each product dy . W and dy^T x formed from dy's
    parts into one fp32 sum, smallest part first, as the kernels accumulate
    lo . W, mid . W and hi . W into one accumulator: one fp32 product over
    the parts laid side by side along k."""
    def mm(a, b):
        ps = parts(a)[::-1]
        return torch.cat(ps, -1) @ torch.cat([b] * len(ps), 0)
    wq1, _, wq2, _, wk1, _, wk2, _, wv1, _, wv2, _ = ws
    dq1, dq2, dk1, dk2, dv1, dv2 = dys
    out = [mm(dq1, wq1) + mm(dq2, wq2), mm(dk1, wk1) + mm(dv1, wv1),
           mm(dk2, wk2) + mm(dv2, wv2)]
    for x, dy in ((xq, dq1), (xq, dq2), (x1, dk1), (x2, dk2), (x1, dv1),
                  (x2, dv2)):
        dyf = dy.reshape(-1, dy.shape[-1])
        out += [mm(dyf.t(), x.reshape(-1, x.shape[-1])), dyf.sum(0)]
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_k2b_split3_chain_matches_fp32(rng, shape):
    """dx and dW from dy's three bf16 parts stay within 1e-6 (relative to
    each output's largest entry) of the exact chain (fp64), as the plain
    fp32 ``_chain_grads`` does, at the four stream shapes; one bf16
    rounding of dy misses 1e-4. (Against ``_chain_grads`` itself the
    distance is the two fp32 sums' rounding, up to ~1.2e-6 on these
    inputs.)"""
    B, (Lq, L1, L2) = 8, shape
    xs = [_bf16_values(rng.normal(size=(B, L, D)).astype(np.float32))
          for L in (Lq, L1, L2)]
    ws = []
    for _ in range(6):
        ws += [_bf16_values((rng.normal(size=(D, D)) / math.sqrt(D)).astype(
                   np.float32)),
               _bf16_values((0.1 * rng.normal(size=D)).astype(np.float32))]
    # dy as the qkv pass writes it: fp32, spread over several decades
    dys = [torch.from_numpy((rng.normal(size=(B, L, D))
                             * np.exp(rng.normal(size=(B, L, D)))
                             ).astype(np.float32))
           for L in (Lq, Lq, L1, L2, L1, L2)]
    exact = _chain_split(*(x.double() for x in xs), [w.double() for w in ws],
                         [dy.double() for dy in dys], lambda x: (x,))
    plain = A._chain_grads(*xs, ws, dys)
    got = _chain_split(*xs, ws, dys, _split3)
    one = _chain_split(*xs, ws, dys, lambda x: (x.bfloat16().float(),))
    names = ["dxq", "dx1", "dx2"] + [f"{n}{w}" for w in
                                     ("q1", "q2", "k1", "k2", "v1", "v2")
                                     for n in ("dW", "db")]
    for name, a, p, e in zip(names, got, plain, exact):
        err, floor = _rel(a.double(), e), _rel(p.double(), e)
        assert floor <= 2e-6, f"{name}: the fp32 chain is {floor:.3g} off"
        assert err <= 1e-6, \
            f"{name}: relative error {err:.3g} (fp32 chain {floor:.3g})"
    # db is a plain fp32 sum in the kernel too: only the products lose
    assert max(_rel(a.double(), e) for n, a, e in zip(names, one, exact)
               if not n.startswith("db")) > 1e-4


def _hilo(x):
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def _core_bwd_hilo(q1, q2, k1, k2, v1, v2, mq, m1, m2, g, scale, rate, seed):
    """The bf16 core backward's arithmetic: p in fp32 kept as hi + lo, dv
    and dl from it, dl kept as hi + lo for dq and dk (two_block_mma.cuh)."""
    pair1, pair2 = A._pair_mask(mq, m1), A._pair_mask(mq, m2)
    keep1, keep2 = A._keeps(q1, k1.shape[1], k2.shape[1], rate, seed)
    p1, p2 = A._joint_probs(A._logits(q1, k1), A._logits(q2, k2), pair1,
                            pair2, scale, keep1, keep2,
                            A.keep_divisor(rate))
    p1, p2 = _hilo(p1), _hilo(p2)
    dv1 = torch.einsum("bhqk,bqhd->bkhd", p1, g)
    dv2 = torch.einsum("bhqk,bqhd->bkhd", p2, g)
    dp1 = torch.einsum("bqhd,bkhd->bhqk", g, v1)
    dp2 = torch.einsum("bqhd,bkhd->bhqk", g, v2)
    s = (dp1 * p1).sum(-1, keepdim=True) + (dp2 * p2).sum(-1, keepdim=True)
    dl = []
    for p, dp, keep, pair in ((p1, dp1, keep1, pair1), (p2, dp2, keep2,
                                                         pair2)):
        x = p * (dp - s) * scale
        if keep is not None:
            x = torch.where(keep, x / A.keep_divisor(rate), 0.0)
        dl.append(_hilo(torch.where(pair, x, 0.0)))
    return (torch.einsum("bhqk,bkhd->bqhd", dl[0], k1),
            torch.einsum("bhqk,bkhd->bqhd", dl[1], k2),
            torch.einsum("bhqk,bqhd->bkhd", dl[0], q1),
            torch.einsum("bhqk,bqhd->bkhd", dl[1], q2), dv1, dv2)


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("shape", SHAPES)
def test_k2b_core_hilo_matches_plain(rng, shape, drop):
    """p and dl as bf16 hi + lo halves (q, k, v, g bf16 values, as the
    projections write them): every gradient within 1e-4 of the fp32
    backward, inside the 3e-2 the card tests hold bf16 K2b to."""
    B, (Lq, L1, L2) = 8, shape
    qkv = [_bf16_values(rng.normal(size=(B, L, H, DH)).astype(np.float32))
           for L in (Lq, Lq, L1, L2, L1, L2)]
    masks = []
    for L, empty in ((Lq, True), (L1, False), (L2, Lq > 1)):
        m = np.zeros((B, L), bool)
        for i in range(B):
            m[i, :rng.integers(1, L + 1)] = True
        if empty:
            m[0] = False
        masks.append(torch.from_numpy(m))
    g = _bf16_values(rng.normal(size=(B, Lq, H, DH)).astype(np.float32))
    rate = RATE if drop else 0.0
    args = (*qkv, *masks, g, 1 / math.sqrt(DH), rate, SEED)
    want = A._joint_bwd_plain(*args)
    got = _core_bwd_hilo(*args)
    for name, a, b in zip(("dq1", "dq2", "dk1", "dk2", "dv1", "dv2"), got,
                          want):
        assert _rel(a, b) <= 1e-4, f"{name}: relative error {_rel(a, b):.3g}"


def test_k2_body_by_dtype():
    assert A.k2_body(torch.bfloat16) == "mma"
    assert A.k2_body(torch.float32) == "tf32"


def _old_bf16_smem(Lq, L1, L2, dh, backward):
    """Shared memory of the CUDA-core bf16 K2 blocks (k2_smem_bytes,
    k2b_smem_bytes in csrc/proj_attention.cuh)."""
    lmax = max(Lq, L1, L2)
    mp = (lmax + 15) // 16 * 16
    stage = max(2 * 2 * (mp + 2 * dh) * 40, 4 * mp * (2 * dh + 4))
    ds, pad4 = dh + 4, (lambda n: (n + 3) // 4 * 4)
    prob_row = pad4(L1) + pad4(L2)
    if backward:
        return (stage + 4 * (3 * Lq + 2 * L1 + 2 * L2) * ds
                + 4 * pad4(Lq + L1 + L2) + 4 * Lq * prob_row)
    return (stage + 4 * (2 * Lq + 2 * L1 + 2 * L2) * ds
            + 4 * pad4(Lq + L1 + L2) + 4 * 8 * 2 * prob_row)


@pytest.mark.parametrize("backward", [False, True], ids=["K2f", "K2b"])
@pytest.mark.parametrize("dh", A.K2_HEAD_DIMS)
def test_k2_mma_smem_takes_every_shape_the_old_body_took(dh, backward):
    lengths = (1, 7, 8, 9, 40, 63, 64, 100, 127, 128)
    took = fits = 0
    for Lq in lengths:
        for L1 in lengths:
            for L2 in lengths:
                old = _old_bf16_smem(Lq, L1, L2, dh, backward)
                new = A.k2_mma_smem_bytes(Lq, L1, L2, dh, backward)
                if old <= A.MAX_SMEM_BYTES:
                    took += 1
                    assert new <= A.MAX_SMEM_BYTES, (Lq, L1, L2, new)
                fits += new <= A.MAX_SMEM_BYTES
    assert fits >= took > 0
    # the model's launches at the flagship head dim
    if dh == 32:
        for shape in SHAPES:
            assert A.k2_mma_smem_bytes(*shape, dh, backward) <= 128 * 1024


@pytest.mark.parametrize("B", [1, 7, 16, 1024, 65535])
def test_k2_dw_chunks_cover_every_row(B):
    for Lq, L1, L2 in SHAPES + [(1, 1, 1), (128, 128, 128), (3, 128, 5)]:
        chunk = A.k2_dw_chunk(B, Lq, L1, L2)
        counts = A.k2_dw_chunks(B, Lq, L1, L2, chunk)
        assert chunk % 32 == 0 and chunk > 0
        assert sum(counts) <= A.K2_DW_MAX_CHUNKS
        for n, L in zip(counts, (Lq, Lq, L1, L2, L1, L2)):
            assert (n - 1) * chunk < B * L <= n * chunk


class _FakeLib:
    """Stands in for the kernels' C functions: records each call's
    arguments and reports success."""

    def __init__(self):
        self.calls = {}

    def __call__(self, lib, symbol, restype, argtypes):
        def fn(*args):
            self.calls[symbol] = args
            return 1024 if restype is ctypes.c_size_t else 0
        return fn


def _n_ptrs(arr):
    return ctypes.sizeof(arr) // ctypes.sizeof(ctypes.c_void_p)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_wrappers_hand_each_body_its_operands(rng, dtype, monkeypatch):
    """bf16: K2f and K2b's qkv pass get a three-tensor workspace, K2b's
    chain dW's row chunk and a scratch of its chunks; fp32: the pair
    projections, then K1f's and K1b's tensor-core body (never K2's bf16
    entries), and the chain K2_DW_SPLITS chunks a weight."""
    fake = _FakeLib()
    monkeypatch.setattr(A, "_fn", fake)
    monkeypatch.setattr(A, "_stream_ptr", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(A, "ATTN_V3_BWD", False)
    B, (Lq, L1, L2) = 4, SHAPES[0]
    xs = [torch.randn(B, L, D, dtype=dtype) for L in (Lq, L1, L2)]
    ws = []
    for _ in range(6):
        ws += [torch.randn(D, D, dtype=dtype), torch.randn(D, dtype=dtype)]
    masks = [torch.ones(B, L, dtype=torch.bool) for L in (Lq, L1, L2)]
    g = torch.randn(B, Lq, D, dtype=dtype)
    A._k2_forward_cuda(*xs, ws, masks, H, 0.1, 0.0, 0)
    grads = A._k2_backward_cuda(*xs, ws, masks, g, H, 0.1, 0.0, 0)
    assert len(grads) == 15
    chain = fake.calls["segmm_proj_two_block_attention_chain_bwd"]
    mma = dtype == torch.bfloat16
    assert chain[0] == (1 if mma else 0)
    chunk = chain[-2]
    if mma:
        fwd = fake.calls["segmm_proj_two_block_attention_fwd"]
        qkv = fake.calls["segmm_proj_two_block_attention_qkv_bwd"]
        assert fwd[0] == qkv[0] == 1
        assert _n_ptrs(fwd[6]) == _n_ptrs(qkv[7]) == 3
        assert chunk == A.k2_dw_chunk(B, Lq, L1, L2)
    else:
        assert "segmm_proj_two_block_attention_fwd" not in fake.calls
        assert "segmm_proj_two_block_attention_qkv_bwd" not in fake.calls
        pairs = fake.calls["segmm_project_pairs_f32"]
        assert pairs[4] == 3 and _n_ptrs(pairs[2]) == 6
        k1f = fake.calls["segmm_two_block_attention_fwd"]
        k1b = fake.calls["segmm_two_block_attention_bwd"]
        # fp32 on the 3xTF32 core: K1f's entry takes fp32 alone, K1b's
        # dtype 0
        assert k1f[10:16] == (B, Lq, L1, L2, H, D // H) and k1b[0] == 0
        assert chunk == 0 and chain[-3] == A.K2_DW_SPLITS


def test_k2_workspace_layout():
    xs = [torch.zeros(3, L, D, dtype=torch.bfloat16) for L in (5, 7, 2)]
    work = A.k2_workspace(*xs)
    assert [tuple(w.shape) for w in work] == [(3, 5, 2 * D), (3, 7, 2 * D),
                                              (3, 2, 2 * D)]
    assert all(w.dtype == torch.bfloat16 and w.is_contiguous()
               for w in work)
