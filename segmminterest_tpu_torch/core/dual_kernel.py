"""Dual-stream fused attention, K5 (port of
``segmminterest_tpu/core/dual_kernel.py``): BOTH projection-fused
two-block attention streams of one SegFormerX layer in one launch, forward
(K5f) and backward (K5b); the epilogue (out-projection, FFN, LayerNorms)
stays outside, as in the JAX package.

    video stream: q1 = vid.Wq_v2v over k1 = vid.Wk_v2v (block 1)
                  q2 = vid.Wq_t2v over k2 = usr.Wk_t2v (block 2), one softmax
    user stream:  q1 = usr.Wq_v2t over k1 = vid.Wk_v2t
                  q2 = usr.Wq_t2t over k2 = usr.Wk_t2t, one softmax

Each stream is K2's math exactly (core/attention.py). Both streams share
one seed; the user stream's dropout salts start at head H (``2(H + h) +
block``, dual_kernel.py:100-101), so the two streams draw different bits.
The backward sums the input gradients as ``_ds_bwd_kernel`` does
(:151-160): the video input feeds the video stream's queries and block-1
keys and values and the user stream's block-1 keys and values, the user
input the rest.

bf16 K5 runs on K2's tensor-core pieces (``k5_body``): both streams' six
projections as one grouped GEMM, then both streams' cores in one launch
(forward and backward); K5b then dxv and dxu each over its six products
and the 12 dW in ``k5_dw_chunk`` row chunks. fp32 K5 runs K2's fp32 route
on each stream (the user stream salted from head H), K5b then its chain
on the CUDA cores (``segmm_dual_stream_attention_chain_bwd``).

Weights in nn.Linear layout (out, in), biases (d,), 12 per stream in the
order wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2. The
wrapper launches the CUDA kernels (core/csrc/dual_stream_attention*.cu)
for CUDA tensors and runs the plain versions only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from . import attention as A

# bf16 K5b's weight gradients: the 12 weights' rows in chunks of
# k5_dw_chunk rows, about this many chunks in all (its dW kernel's table
# holds A.K2_DW_MAX_CHUNKS)
K5_DW_CHUNKS = 48


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _stream_inputs(xv, xu, mask_v, mask_u):
    """(xq, x1, x2, masks) of the video and the user stream."""
    return ((xv, xv, xu, (mask_v, mask_v, mask_u)),
            (xu, xv, xu, (mask_u, mask_v, mask_u)))


def dual_stream_attention_plain(xv, xu, wsa, wsb, mask_v, mask_u,
                                num_heads: int, scale: float,
                                rate: float = 0.0, seed: int = 0):
    """K5f's plain version: K2's plain version on each stream, one seed,
    the user stream salted from head H. xv (B, Lv, d), xu (B, Lu, d),
    wsa / wsb the 12 weights and biases of each stream -> (ov, ou)."""
    (va, sa), (vb, sb) = [((xq, x1, x2), m) for xq, x1, x2, m
                          in _stream_inputs(xv, xu, mask_v, mask_u)]
    ov = A.proj_two_block_attention_plain(*va, *wsa, *sa, num_heads, scale,
                                          rate, seed)
    ou = A.proj_two_block_attention_plain(*vb, *wsb, *sb, num_heads, scale,
                                          rate, seed, head_offset=num_heads)
    return ov, ou


def dual_stream_attention_bwd_plain(xv, xu, wsa, wsb, mask_v, mask_u, gv, gu,
                                    num_heads: int, scale: float,
                                    rate: float = 0.0, seed: int = 0):
    """K5b's plain version (``_ds_bwd_kernel``, dual_kernel.py:104-180):
    each stream's fp32 dq..dv as K2b's qkv pass computes them, then dxv and
    dxu as sums of six products each in the kernel's order, and the 12 dW
    and 12 db (each cast to its weight's dtype). Returns
    (dxv, dxu, *dwa (12), *dwb (12))."""
    (sa, sb) = _stream_inputs(xv, xu, mask_v, mask_u)
    daq1, daq2, dak1, dak2, dav1, dav2 = A.proj_qkv_grads_plain(
        *sa[:3], wsa, sa[3], gv, num_heads, scale, rate, seed)
    dbq1, dbq2, dbk1, dbk2, dbv1, dbv2 = A.proj_qkv_grads_plain(
        *sb[:3], wsb, sb[3], gu, num_heads, scale, rate, seed,
        head_offset=num_heads)
    dg = A.dgrad
    dxv = (dg(daq1, wsa[0]) + dg(daq2, wsa[2]) + dg(dak1, wsa[4])
           + dg(dav1, wsa[8]) + dg(dbk1, wsb[4]) + dg(dbv1, wsb[8]))
    dxu = (dg(dbq1, wsb[0]) + dg(dbq2, wsb[2]) + dg(dak2, wsa[6])
           + dg(dav2, wsa[10]) + dg(dbk2, wsb[6]) + dg(dbv2, wsb[10]))
    grads = [dxv.to(xv.dtype), dxu.to(xu.dtype)]
    for ws, dys, xs in ((wsa, (daq1, daq2, dak1, dak2, dav1, dav2),
                         (xv, xv, xv, xu, xv, xu)),
                        (wsb, (dbq1, dbq2, dbk1, dbk2, dbv1, dbv2),
                         (xu, xu, xv, xu, xv, xu))):
        for i, (dy, x) in enumerate(zip(dys, xs)):
            grads += A.wgrad(x, dy, ws[2 * i], ws[2 * i + 1])
    return tuple(grads)


# ---------------------------------------------------------------------------
# launching the kernels
# ---------------------------------------------------------------------------

def _check_k5(xv, xu, wsa, wsb, mask_v, mask_u, num_heads, g=(None, None)):
    """K5 takes what K2 takes, on each of its two streams."""
    for (xq, x1, x2, masks), ws, gq in zip(
            _stream_inputs(xv, xu, mask_v, mask_u), (wsa, wsb), g):
        A._check_k2((xq, x1, x2) + tuple(ws), masks, num_heads, gq)
    B, Lv, d = xv.shape
    return B, Lv, xu.shape[1], d, d // num_heads


def k5_body(dtype) -> str:
    """Which bodies K5f and K5b run, by dtype, never on a failure:
    ``"mma"`` for bf16 (K2's projection GEMM over both streams' six
    sources, both streams' cores in one tensor-core launch; K5b's chain dx
    over six pairs and the 12 dW in three bf16 parts), ``"tf32"`` for fp32
    (K2's fp32 route on each stream, the user stream salted from head H;
    K5b then the CUDA-core chain)."""
    return A.k2_body(dtype)


def k5_dw_rows(B: int, Lv: int, Lu: int):
    """Rows of each of bf16 K5b's 12 weight gradients: the video stream's
    q1 q2 k1 k2 v1 v2 (from xv xv xv xu xv xu), then the user stream's
    (from xu xu xv xu xv xu)."""
    return [B * L for L in (Lv, Lv, Lv, Lu, Lv, Lu, Lu, Lu, Lv, Lu, Lv, Lu)]


def k5_dw_chunk(B: int, Lv: int, Lu: int) -> int:
    """Rows per chunk of bf16 K5b's weight gradients: about K5_DW_CHUNKS
    chunks over the 12 weights' rows, a multiple of the products' 32-row
    step, each weight's chunks summed in order (as ``k2_dw_chunk``)."""
    rows = sum(k5_dw_rows(B, Lv, Lu))
    chunk = -(-rows // K5_DW_CHUNKS)
    return max(32, -(-chunk // 32) * 32)


def k5_dw_chunks(B: int, Lv: int, Lu: int, chunk: int):
    """Chunks of each of the 12 weights at `chunk` rows."""
    return [-(-M // chunk) for M in k5_dw_rows(B, Lv, Lu)]


def k5_workspace(xv, xu):
    """bf16 K5's transient projections, (B, L, 2d) each: the video
    stream's q1|q2 (xv), k1|v1 (xv), k2|v2 (xu), then the user stream's
    q1|q2 (xu), k1|v1 (xv), k2|v2 (xu)."""
    B, _, d = xv.shape
    return [torch.empty(B, x.shape[1], 2 * d, dtype=torch.bfloat16,
                        device=x.device) for x in (xv, xv, xu, xu, xv, xu)]


def _k5_forward_cuda(xv, xu, wsa, wsb, mask_v, mask_u, num_heads, scale,
                     rate, seed):
    B, Lv, Lu, d, dh = _check_k5(xv, xu, wsa, wsb, mask_v, mask_u, num_heads)
    if k5_body(xv.dtype) == "tf32":
        A.LAUNCHES["dual_stream_attention"] += 1
        return tuple(A._k2_tf32_forward(xq, x1, x2, ws, masks, num_heads,
                                        scale, rate, seed, salt_h0=h0)
                     for (xq, x1, x2, masks), ws, h0 in zip(
                         _stream_inputs(xv, xu, mask_v, mask_u), (wsa, wsb),
                         (0, num_heads)))
    return _k5_forward_mma(xv, xu, wsa, wsb, mask_v, mask_u, num_heads,
                           scale, rate, seed)


def _k5_forward_mma(xv, xu, wsa, wsb, mask_v, mask_u, num_heads, scale,
                    rate, seed):
    """bf16 K5f: both streams' six projections as one grouped GEMM into
    ``k5_workspace``, then both streams' cores in one launch
    (csrc/dual_stream_attention.cu, two launches)."""
    B, Lv, d = xv.shape
    Lu = xu.shape[1]
    fn = A._fn("dual_stream_attention", "segmm_dual_stream_attention_fwd_mma",
               ctypes.c_int, [ctypes.POINTER(ctypes.c_void_p)]
               + [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_void_p)]
               + [ctypes.c_int] * 5 + [ctypes.c_float] + A._DROP_ARGS
               + [ctypes.c_void_p])
    mv, mu = A._masks_i32(mask_v, mask_u)
    ov, ou = torch.empty_like(xv), torch.empty_like(xu)
    work = k5_workspace(xv, xu)
    with torch.cuda.device(xv.device):
        code = fn(A._ptrs((xv, xu, *wsa, *wsb)), mv.data_ptr(), mu.data_ptr(),
                  ov.data_ptr(), ou.data_ptr(), A._ptrs(work), B, Lv, Lu, d,
                  num_heads, float(scale), *A._drop_args(rate, seed),
                  A._stream_ptr(xv.device))
    A._raise_on_cuda_error(code, "dual_stream_attention")
    A.LAUNCHES["dual_stream_attention"] += 1
    return ov, ou


def _k5_backward_cuda(xv, xu, wsa, wsb, mask_v, mask_u, gv, gu, num_heads,
                      scale, rate, seed):
    """K5b. bf16: ``_k5_backward_mma``. fp32: each stream's qkv pass by
    K2's fp32 route (the user stream salted from head H) into fp32
    workspaces, then the chain: dxv and dxu (six products each) and the 12
    dW and 12 db over the batch in row chunks added in order."""
    B, Lv, Lu, d, dh = _check_k5(xv, xu, wsa, wsb, mask_v, mask_u, num_heads,
                                 (gv, gu))
    if k5_body(xv.dtype) == "mma":
        return _k5_backward_mma(xv, xu, wsa, wsb, mask_v, mask_u, gv, gu,
                                num_heads, scale, rate, seed)
    fn = A._fn("dual_stream_attention_bwd",
               "segmm_dual_stream_attention_chain_bwd", ctypes.c_int,
               [ctypes.POINTER(ctypes.c_void_p)] * 4 + [ctypes.c_void_p]
               + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    dev, f32 = xv.device, torch.float32
    # per stream: dq1, dq2 (its Lq), dk1 (Lv), dk2 (Lu), dv1, dv2
    dys = [t for (xq, x1, x2, masks), ws, gq, h0 in zip(
        _stream_inputs(xv, xu, mask_v, mask_u), (wsa, wsb), (gv, gu),
        (0, num_heads)) for t in A._k2_tf32_qkv_grads(
            xq, x1, x2, ws, masks, gq.contiguous(), num_heads, scale, rate,
            seed, salt_h0=h0)]
    dx = [torch.empty_like(xv), torch.empty_like(xu)]
    dw = [torch.empty(d, d, dtype=f32, device=dev) for _ in range(12)]
    db = [torch.empty(d, dtype=f32, device=dev) for _ in range(12)]
    scratch = torch.empty(12 * A.K2_DW_SPLITS * (d * d + d), dtype=f32,
                          device=dev)
    with torch.cuda.device(dev):
        code = fn(A._ptrs((xv, xu, *wsa, *wsb)), A._ptrs(dys), A._ptrs(dx),
                  A._ptrs(dw + db), scratch.data_ptr(), B, Lv, Lu, d,
                  A.K2_DW_SPLITS, A._stream_ptr(dev))
    A._raise_on_cuda_error(code, "dual_stream_attention_chain_bwd")
    A.LAUNCHES["dual_stream_attention_bwd"] += 1
    ws = tuple(wsa) + tuple(wsb)
    grads = list(dx)
    for i in range(12):
        grads += [dw[i].to(ws[2 * i].dtype), db[i].to(ws[2 * i + 1].dtype)]
    return tuple(grads)


def _k5_backward_mma(xv, xu, wsa, wsb, mask_v, mask_u, gv, gu, num_heads,
                     scale, rate, seed):
    """bf16 K5b: the six projections, both cores, dx and the 12 dW, db
    (csrc/dual_stream_attention_bwd.cu, five launches)."""
    B, Lv, d = xv.shape
    Lu = xu.shape[1]
    f32 = dict(dtype=torch.float32, device=xv.device)
    dys = [torch.empty(B, L, d, **f32)
           for Lq in (Lv, Lu) for L in (Lq, Lq, Lv, Lu, Lv, Lu)]
    dx = [torch.empty_like(xv), torch.empty_like(xu)]
    dw = [torch.empty(d, d, **f32) for _ in range(12)]
    db = [torch.empty(d, **f32) for _ in range(12)]
    chunk = k5_dw_chunk(B, Lv, Lu)
    nchunks = sum(k5_dw_chunks(B, Lv, Lu, chunk))
    if nchunks > A.K2_DW_MAX_CHUNKS:
        raise ValueError(f"{nchunks} dW chunks exceed the kernel's "
                         f"{A.K2_DW_MAX_CHUNKS}")
    scratch = torch.empty(nchunks * (d * d + d), **f32)
    work = k5_workspace(xv, xu)
    fn = A._fn("dual_stream_attention_bwd",
               "segmm_dual_stream_attention_bwd_mma", ctypes.c_int,
               [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_void_p] * 4
               + [ctypes.POINTER(ctypes.c_void_p)] * 4 + [ctypes.c_void_p]
               + [ctypes.c_int] * 5 + [ctypes.c_float] + A._DROP_ARGS
               + [ctypes.c_int, ctypes.c_void_p])
    mv, mu = A._masks_i32(mask_v, mask_u)
    with torch.cuda.device(xv.device):
        code = fn(A._ptrs((xv, xu, *wsa, *wsb)), mv.data_ptr(),
                  mu.data_ptr(), gv.data_ptr(), gu.data_ptr(), A._ptrs(dys),
                  A._ptrs(work), A._ptrs(dx), A._ptrs(dw + db),
                  scratch.data_ptr(), B, Lv, Lu, d, num_heads, float(scale),
                  *A._drop_args(rate, seed), chunk, A._stream_ptr(xv.device))
    A._raise_on_cuda_error(code, "dual_stream_attention_bwd")
    A.LAUNCHES["dual_stream_attention_bwd"] += 1
    ws = tuple(wsa) + tuple(wsb)
    grads = list(dx)
    for i in range(12):
        grads += [dw[i].to(ws[2 * i].dtype), db[i].to(ws[2 * i + 1].dtype)]
    return tuple(grads)


# ---------------------------------------------------------------------------
# autograd and the public entry point
# ---------------------------------------------------------------------------

class _DualStreamAttention(torch.autograd.Function):
    """K5f forward and K5b backward (``_fused_dual`` custom VJP,
    dual_kernel.py:284-315): saves the inputs, masks and seed."""

    @staticmethod
    def forward(ctx, xv, xu, *rest):
        wsa, wsb = rest[:12], rest[12:24]
        mask_v, mask_u, num_heads, scale, rate, seed = rest[24:]
        ctx.save_for_backward(xv, xu, *wsa, *wsb, mask_v, mask_u)
        ctx.hyper = (num_heads, scale, rate, seed)
        if A._device_kind(xv) == "cpu":
            return dual_stream_attention_plain(xv, xu, wsa, wsb, mask_v,
                                               mask_u, num_heads, scale, rate,
                                               seed)
        return _k5_forward_cuda(xv, xu, wsa, wsb, mask_v, mask_u, num_heads,
                                scale, rate, seed)

    @staticmethod
    def backward(ctx, gv, gu):
        s = ctx.saved_tensors
        xv, xu, wsa, wsb, mask_v, mask_u = (s[0], s[1], s[2:14], s[14:26],
                                            s[26], s[27])
        gv, gu = gv.contiguous(), gu.contiguous()
        if gv.device.type == "cpu":
            grads = dual_stream_attention_bwd_plain(
                xv, xu, wsa, wsb, mask_v, mask_u, gv, gu, *ctx.hyper)
        else:
            grads = _k5_backward_cuda(xv, xu, wsa, wsb, mask_v, mask_u, gv,
                                      gu, *ctx.hyper)
        return tuple(grads) + (None,) * 6


def fused_dual_stream_attention(vid, usr, qkv_vid: Sequence, qkv_usr: Sequence,
                                vid_mask, usr_mask, *, num_heads: int,
                                dropout_rate: float = 0.0, seed: int = 0,
                                deterministic: bool = True,
                                scale: Optional[float] = None):
    """Both layer streams' projection-fused two-block attention in one
    launch (K5). ``qkv_vid`` / ``qkv_usr``: six (weight, bias) pairs each,
    nn.Linear layout, in block order (q1, q2, k1, k2, v1, v2); the video
    stream's blocks are keyed by (v2v, t2v), the user stream's by (v2t,
    t2t). vid (B, Lv, d), usr (B, Lu, d), masks (B, L) -> (vid_out, usr_out).
    Differentiable (K5b); with ``deterministic=False`` the dropout mask of
    ``seed`` applies to both streams."""
    d = vid.shape[-1]
    if d % num_heads:
        raise ValueError(f"d={d} is not a multiple of num_heads={num_heads}")
    if scale is None:
        scale = 1.0 / math.sqrt(d // num_heads)
    flat = [t for pairs in (qkv_vid, qkv_usr) for p in pairs for t in p]
    if len(flat) != 24:
        raise ValueError("qkv_vid and qkv_usr take six (weight, bias) pairs "
                         "each")
    return _DualStreamAttention.apply(
        vid, usr, *flat, vid_mask, usr_mask, int(num_heads), float(scale),
        A._rate(dropout_rate, deterministic), int(seed))
