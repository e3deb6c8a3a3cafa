"""The arithmetic of bf16 K4f and K4b's tensor-core bodies
(segmminterest_tpu_torch/core/csrc/layer_mma.cuh, two_block_mma.cuh,
proj_gemm.cuh), emulated on the CPU, and the wrapper's rules around them.

* The epilogue backward's products with an fp32 operand (the dgrad
  products dm . W_m2, du . W_m1, dh . W_ff and the three dW) run on the
  bf16 tensor cores with that operand split into three bf16 parts (hi,
  mid, lo); W, att, y1 and g are bf16 values, exact in bf16. Emulated at
  the four stream shapes (and an MLP of d / 2), with dropout off and on,
  every output of the epilogue backward stays as close to the exact
  (fp64-product) result as the fp32 plain version's does, while one bf16
  rounding of the fp32 operand lands over ten times further off. The
  fp32 plain version is the one that tests/test_torch_layer_kernel.py
  holds against the JAX interpret-mode kernel.
* K4b's attention backward takes g = d_att in fp32 (the TPU kernel's
  fp32 ``sdatt``): the core stages it as bf16 hi and lo halves, as it
  keeps p and dl. Emulated, every gradient stays within 1e-4 of the fp32
  core backward (the plain version's), and one bf16 rounding of g misses
  1e-4.
* ``k4_body`` picks the bodies by dtype; the wrappers hand the bf16
  bodies their workspaces and dW's row chunk, the fp32 ones neither; the
  nine weights' chunks cover every row and stay within the kernel's table;
  the bf16 bodies' shared memory takes every shape the CUDA-core bf16
  bodies before them took.
"""

import contextlib
import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmminterest_tpu.core import layer_kernel as JLK
from segmminterest_tpu_torch.core import attention as A
from segmminterest_tpu_torch.core import layer_kernel as LK

SHAPES = [(40, 40, 100), (100, 40, 100), (40, 40, 1), (1, 40, 1)]
H, DH = 2, 32
D = H * DH
SEED, RATE = 24680, 0.1


def _bf16(a):
    """bf16 tensors from numpy, as the kernels' bf16 operands."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16()


def _split3(x):
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    return hi, mid, (x - hi - mid).bfloat16().float()


def _hilo(x):
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


# a @ b for the products with an fp32 left operand, four ways
_MM = {
    "exact": lambda a, b: a.double() @ b.double(),
    "fp32": lambda a, b: a.float() @ b.float(),
    # the kernels: lo . b, mid . b, hi . b into one fp32 sum (one product
    # over the parts side by side along k)
    "split3": lambda a, b: torch.cat(_split3(a.float())[::-1], -1)
    @ torch.cat([b.float()] * 3, 0),
    "one_rounding": lambda a, b: a.float().bfloat16().float() @ b.float(),
}


def _epilogue_bwd(xq, att, ep, g, rate, mm):
    """K4b's epilogue backward in layer_stream_bwd_plain's order
    (layer_kernel.py:265-289) with each product of an fp32 operand, dgrad
    dy . W and dW = dy^T x, through mm; the forward recomputed by the plain
    version (bf16 roundings). Returns d_att, dr1 and the epilogue's
    gradients, unrounded."""
    wff, bff, ln1s, ln1b, wm1, bm1, wm2, bm2, ln2s, ln2b = ep
    e = LK.epilogue_fwd(xq, att, ep, H, rate, SEED)
    keep_h, keep_g, keep_m = e["keeps"]
    div = A.keep_divisor(rate)
    d, ff = xq.shape[-1], wm1.shape[0]

    def flat(t, w):
        return t.reshape(-1, w)

    def wgrad(x, dy):
        dyf = flat(dy, dy.shape[-1])
        return mm(dyf.t(), flat(x, x.shape[-1])), dyf.sum(0)

    def drop(x, keep):
        return x if keep is None else torch.where(keep, x / div, 0.0)

    g2 = g.float()
    out = dict(dln2s=flat(g2 * e["xhat2"], d).sum(0), dln2b=flat(g2, d).sum(0))
    dr2 = LK.layer_norm_bwd(g2, e["xhat2"], e["inv2"], ln2s)
    dm = drop(dr2, keep_m)
    out["dwm2"], out["dbm2"] = wgrad(e["gact"], dm)
    dgd = drop(mm(flat(dm, d), wm2).reshape(*dm.shape[:-1], ff), keep_g)
    du = dgd * LK.gelu_grad_f32(e["u"].float())
    out["dwm1"], out["dbm1"] = wgrad(e["y1"], du)
    dy1 = dr2 + mm(flat(du, ff), wm1).reshape(dr2.shape)
    out["dln1s"] = flat(dy1 * e["xhat1"], d).sum(0)
    out["dln1b"] = flat(dy1, d).sum(0)
    dr1 = LK.layer_norm_bwd(dy1, e["xhat1"], e["inv1"], ln1s)
    dh = drop(dr1, keep_h)
    out["dwff"], out["dbff"] = wgrad(att, dh)
    out["datt"] = mm(flat(dh, d), wff).reshape(dh.shape)
    out["dr1"] = dr1
    return out


def _epilogue_case(rng, Lq, ff, B=4):
    xq = _bf16(rng.normal(size=(B, Lq, D)))
    att = _bf16(rng.normal(size=(B, Lq, D)) * 0.5)
    g = _bf16(rng.normal(size=(B, Lq, D)))

    def dense(n_out, n_in):
        return [_bf16(rng.normal(size=(n_out, n_in)) / math.sqrt(n_in)),
                _bf16(0.1 * rng.normal(size=n_out))]

    def ln():
        return [torch.from_numpy((1 + 0.1 * rng.normal(size=D)).astype(
                    np.float32)),
                torch.from_numpy((0.1 * rng.normal(size=D)).astype(
                    np.float32))]

    ep = dense(D, D) + ln() + dense(ff, D) + dense(D, ff) + ln()
    return xq, att, ep, g


@pytest.mark.parametrize("drop", [False, True], ids=["eval", "dropout"])
@pytest.mark.parametrize("shape,ff", [(s, D) for s in SHAPES]
                         + [(SHAPES[0], D // 2)])
def test_k4b_split3_epilogue_matches_fp32(rng, shape, ff, drop):
    """Every output of the epilogue backward with its fp32 operands in
    three bf16 parts lies as close to the exact products' result as the
    fp32 plain version's (within 2x of its distance, plus 1e-7), and one
    bf16 rounding lies over ten times further off than three parts."""
    xq, att, ep, g = _epilogue_case(rng, shape[0], ff)
    rate = RATE if drop else 0.0
    got = {k: _epilogue_bwd(xq, att, ep, g, rate, mm)
           for k, mm in _MM.items()}
    worst = {k: 0.0 for k in _MM}
    for name, want in got["exact"].items():
        errs = {k: _rel(got[k][name], want) for k in _MM}
        assert errs["split3"] <= 2 * errs["fp32"] + 1e-7, (name, errs)
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
    assert worst["one_rounding"] > 10 * worst["split3"], worst


def test_k4b_fp32_plain_epilogue_matches_jax(rng):
    """The fp32 plain epilogue backward (the emulation's yardstick) against
    the JAX kernel's pieces (_epilogue_fwd, _ln_bwd, _gelu_grad_f32) on the
    same inputs, dropout off."""
    xq, att, ep, g = _epilogue_case(rng, 12, D)
    xq, att, g = xq.float(), att.float(), g.float()
    ep = [t.float() for t in ep]
    got = _epilogue_bwd(xq, att, ep, g, 0.0, _MM["fp32"])
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    # the JAX kernel's weights are (in, out)
    jep = [j(t.t()) if t.ndim == 2 else j(t) for t in ep]
    e = JLK._epilogue_fwd(j(xq), j(att), *jep, dropout_rate=0.0, drop=False,
                          interpret=True, seed_val=SEED, num_heads=H)
    dr2 = JLK._ln_bwd(j(g), e["xhat2"], e["inv2"], jep[8])
    du = (dr2 @ jep[6].T) * JLK._gelu_grad_f32(e["u"])
    dr1 = JLK._ln_bwd(dr2 + du @ jep[4].T, e["xhat1"], e["inv1"], jep[2])
    np.testing.assert_allclose(got["dr1"].numpy(), np.asarray(dr1),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["datt"].numpy(),
                               np.asarray(dr1 @ jep[0].T), rtol=2e-4,
                               atol=2e-5)


def _core_bwd(q1, q2, k1, k2, v1, v2, mq, m1, m2, g, scale, rate, seed,
              g_parts):
    """The bf16 core backward's arithmetic (two_block_mma.cuh): p in fp32
    kept as hi + lo, dl too; g as g_parts(g) (its hi + lo halves for an
    fp32 g)."""
    pair1, pair2 = A._pair_mask(mq, m1), A._pair_mask(mq, m2)
    keep1, keep2 = A._keeps(q1, k1.shape[1], k2.shape[1], rate, seed)
    p1, p2 = A._joint_probs(A._logits(q1, k1), A._logits(q2, k2), pair1,
                            pair2, scale, keep1, keep2,
                            A.keep_divisor(rate))
    p1, p2, g = _hilo(p1), _hilo(p2), g_parts(g)
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
def test_k4b_core_fp32_g_split_matches_plain(rng, shape, drop):
    """g = d_att in fp32 as bf16 hi + lo halves (q, k, v bf16 values):
    every gradient within 1e-4 of the fp32 core backward; g rounded once
    to bf16 misses 1e-4."""
    B, (Lq, L1, L2) = 8, shape
    qkv = [_bf16(rng.normal(size=(B, L, H, DH))).float()
           for L in (Lq, Lq, L1, L2, L1, L2)]
    masks = []
    for L, empty in ((Lq, True), (L1, False), (L2, Lq > 1)):
        m = np.zeros((B, L), bool)
        for i in range(B):
            m[i, :rng.integers(1, L + 1)] = True
        if empty:
            m[0] = False
        masks.append(torch.from_numpy(m))
    # d_att as the epilogue writes it: fp32, spread over several decades
    g = torch.from_numpy((rng.normal(size=(B, Lq, H, DH))
                          * np.exp(rng.normal(size=(B, Lq, H, DH)))
                          ).astype(np.float32))
    rate = RATE if drop else 0.0
    args = (*qkv, *masks, g, 1 / math.sqrt(DH), rate, SEED)
    want = A._joint_bwd_plain(*args)
    got = _core_bwd(*args, _hilo)
    once = _core_bwd(*args, lambda x: x.bfloat16().float())
    names = ("dq1", "dq2", "dk1", "dk2", "dv1", "dv2")
    for name, a, b in zip(names, got, want):
        assert _rel(a, b) <= 1e-4, f"{name}: relative error {_rel(a, b):.3g}"
    assert max(_rel(a, b) for a, b in zip(once, want)) > 1e-4


def test_k4_body_by_dtype():
    assert LK.k4_body(torch.bfloat16) == "mma"
    assert LK.k4_body(torch.float32) == "tf32"


@pytest.mark.parametrize("B", [1, 7, 16, 1024, 65535])
def test_k4_dw_chunks_cover_every_row(B):
    for Lq, L1, L2 in SHAPES + [(1, 1, 1), (128, 128, 128), (3, 128, 5)]:
        chunk = LK.k4_dw_chunk(B, Lq, L1, L2)
        counts = LK.k4_dw_chunks(B, Lq, L1, L2, chunk)
        assert chunk % 32 == 0 and chunk > 0
        assert len(counts) == 9
        assert sum(counts) <= A.K2_DW_MAX_CHUNKS
        for n, M in zip(counts, LK.k4_dw_rows(B, Lq, L1, L2)):
            assert (n - 1) * chunk < M <= n * chunk


def _old_k2_bf16_smem(Lq, L1, L2, dh, backward):
    """Shared memory of the CUDA-core bf16 K2 blocks (k2_smem_bytes,
    k2b_smem_bytes in csrc/proj_attention.cuh) that bf16 K4 ran before its
    tensor-core bodies."""
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


def _old_epilogue_bf16_smem(d, ff, backward):
    """Shared memory of the CUDA-core bodies' bf16 epilogue kernels
    (EpFwdLayout and EpBwdLayout<bf16>, layer_stream*.cu, with their wmma
    weight stage)."""
    a128 = lambda n: (n + 127) // 128 * 128  # noqa: E731
    w = max(d, ff)
    stage = max(2 * 2 * 128 * 40, 4 * 32 * 129, 4 * 32 * 132)
    if not backward:
        g = a128(2 * 32 * (w + 8))
        c = g + a128(2 * 32 * (ff + 8))
        st = c + a128(4 * 32 * (w + 4))
        return st + a128(stage) + 2 * 4 * 32
    y1 = a128(max(2 * 16 * (w + 8), 4 * 16 * (w + 4)))
    c = y1 + a128(2 * 16 * (d + 8))
    r2 = c + a128(4 * 16 * (w + 4))
    st = r2 + a128(4 * 16 * (d + 4))
    return st + a128(stage) + 4 * 4 * 16


@pytest.mark.parametrize("ff", [D * 8, D * 4], ids=["ff=d", "ff=d/2"])
@pytest.mark.parametrize("backward", [False, True], ids=["K4f", "K4b"])
@pytest.mark.parametrize("dh", A.K2_HEAD_DIMS)
def test_k4_mma_smem_takes_every_shape_the_old_body_took(dh, backward, ff):
    d = 512
    lengths = (1, 7, 8, 9, 40, 63, 64, 100, 127, 128)
    took = fits = 0
    for Lq in lengths:
        for L1 in lengths:
            for L2 in lengths:
                old = max(_old_k2_bf16_smem(Lq, L1, L2, dh, False),
                          _old_epilogue_bf16_smem(d, ff, backward))
                if backward:
                    old = max(old, _old_k2_bf16_smem(Lq, L1, L2, dh, True))
                new = LK.k4_mma_smem_bytes(Lq, L1, L2, dh, backward)
                if old <= A.MAX_SMEM_BYTES:
                    took += 1
                    assert new <= A.MAX_SMEM_BYTES, (Lq, L1, L2, new)
                fits += new <= A.MAX_SMEM_BYTES
    assert fits >= took > 0


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


@pytest.mark.parametrize("ff", [D, D // 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k4_wrappers_hand_each_body_its_operands(dtype, ff, monkeypatch):
    """bf16: K4f gets att, y1, g and K2's three-tensor workspace; K4b the
    fp32 body's fifteen buffers with 64-row LayerNorm partials, the
    workspace, dW's row chunk and a scratch of the nine weights' chunks.
    fp32: att alone (K2's fp32 route's); K4b fifteen buffers with 16-row
    partials, then the chain's own launch, K2_DW_SPLITS chunks a
    weight."""
    fake = _FakeLib()
    monkeypatch.setattr(A, "_fn", fake)
    monkeypatch.setattr(A, "_stream_ptr", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    B, (Lq, L1, L2) = 5, SHAPES[0]
    xs = [torch.randn(B, L, D, dtype=dtype) for L in (Lq, L1, L2)]
    qkv = []
    for _ in range(6):
        qkv += [torch.randn(D, D, dtype=dtype), torch.randn(D, dtype=dtype)]
    ln = [torch.ones(D), torch.zeros(D)]
    ep = [torch.randn(D, D, dtype=dtype), torch.randn(D, dtype=dtype)] + ln \
        + [torch.randn(ff, D, dtype=dtype), torch.randn(ff, dtype=dtype),
           torch.randn(D, ff, dtype=dtype), torch.randn(D, dtype=dtype)] + ln
    masks = [torch.ones(B, L, dtype=torch.bool) for L in (Lq, L1, L2)]
    g = torch.randn(B, Lq, D, dtype=dtype)
    allocated = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: allocated.append(
        (a, k)) or real_empty(*a, **k))
    LK._k4_forward_cuda(*xs, qkv, ep, masks, H, 0.1, 0.0, 0)
    grads = LK._k4_backward_cuda(*xs, qkv, ep, masks, g, H, 0.1, 0.0, 0)
    assert len(grads) == 25
    fwd = fake.calls["segmm_layer_stream_fwd"]
    bwd = fake.calls["segmm_layer_stream_bwd"]
    mma = dtype == torch.bfloat16
    assert fwd[0] == bwd[0] == (1 if mma else 0)
    assert _n_ptrs(fwd[5]) == (6 if mma else 1)
    assert _n_ptrs(bwd[6]) == (18 if mma else 15)
    splits, chunk = bwd[17], bwd[18]
    assert ("segmm_layer_stream_chain_bwd" in fake.calls) == (not mma)
    if not mma:
        chain = fake.calls["segmm_layer_stream_chain_bwd"]
        assert _n_ptrs(chain[1]) == 15 and chain[-2] == splits
    rows = LK.K4_MMA_ROWS if mma else LK.K4_BWD_ROWS
    nblk = -(-B * Lq // rows)
    assert any(a == (nblk, 4, D) for a, _ in allocated)
    if mma:
        assert chunk == LK.k4_dw_chunk(B, Lq, L1, L2)
        parts = sum(n * (o * i + o) for n, (o, i) in zip(
            LK.k4_dw_chunks(B, Lq, L1, L2, chunk), LK.k4_dw_shapes(D, ff)))
    else:
        assert chunk == 0 and splits == A.K2_DW_SPLITS
        parts = splits * (7 * (D * D + D) + 2 * D * ff + ff + D)
    assert any(a == (parts,) for a, _ in allocated)


def test_k4_mma_refuses_widths_past_its_registers():
    """The bf16 tensor-core epilogue holds a block's full rows, so widths
    past 768 take the row-tile epilogue in bf16 instead, fewer rows a block
    as the width grows; only a width whose block of two full rows exceeds
    shared memory raises before any launch."""
    d, ff = 512, 1024
    xs = [torch.zeros(2, 4, d, dtype=torch.bfloat16) for _ in range(3)]
    qkv = [torch.zeros(d, d, dtype=torch.bfloat16),
           torch.zeros(d, dtype=torch.bfloat16)] * 6
    ep = [torch.zeros(d, d, dtype=torch.bfloat16),
          torch.zeros(d, dtype=torch.bfloat16), torch.ones(d),
          torch.zeros(d), torch.zeros(ff, d, dtype=torch.bfloat16),
          torch.zeros(ff, dtype=torch.bfloat16),
          torch.zeros(d, ff, dtype=torch.bfloat16),
          torch.zeros(d, dtype=torch.bfloat16), torch.ones(d),
          torch.zeros(d)]
    masks = [torch.ones(2, 4, dtype=torch.bool)] * 3
    assert LK._check_k4(*xs, qkv, ep, masks, 16)[-1] == ff
    assert [LK.k4_epilogue_rows(torch.bfloat16, d, ff, bwd)
            for bwd in (False, True)] == [8, 16]
    assert LK.k4_epilogue_rows(torch.bfloat16, 512, 512, True) == 64
    assert LK.k4_epilogue_rows(torch.float32, 512, 512, True) == 16
    assert LK.k4_epilogue_rows(torch.float32, 8192, 8192, True) == 0
    with pytest.raises(ValueError, match="shared memory"):
        LK._check_k4(*[torch.zeros(2, 4, 8192, dtype=torch.bfloat16)] * 3,
                     [torch.zeros(8192, 8192, dtype=torch.bfloat16),
                      torch.zeros(8192, dtype=torch.bfloat16)] * 6,
                     [torch.zeros(8192, 8192, dtype=torch.bfloat16),
                      torch.zeros(8192, dtype=torch.bfloat16),
                      torch.ones(8192), torch.zeros(8192),
                      torch.zeros(8192, 8192, dtype=torch.bfloat16),
                      torch.zeros(8192, dtype=torch.bfloat16),
                      torch.zeros(8192, 8192, dtype=torch.bfloat16),
                      torch.zeros(8192, dtype=torch.bfloat16),
                      torch.ones(8192), torch.zeros(8192)], masks, 64)
