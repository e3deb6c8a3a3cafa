"""Layer-fused stream, K4 (port of ``segmminterest_tpu/core/layer_kernel.py``):
one whole SegFormerX encoder-layer stream, forward (K4f) and backward (K4b).

    att = K2's projection-fused two-block attention        (q from xq,
          block 1 keys/values from x1, block 2 from x2, one softmax)
    h   = att . W_ff^T + b_ff ; dropout                    (salt 2H)
    y1  = LN1(xq + h)
    u   = y1 . W_m1^T + b_m1 ; g = gelu(u) ; dropout       (salt 2H + 1)
    m   = g . W_m2^T + b_m2 ; dropout                      (salt 2H + 2)
    y2  = LN2(y1 + m)

The plain versions here mirror the kernel, not the composed model path:
the exact GELU is the Abramowitz-Stegun erf polynomial (layer_kernel.py:
58-80), the LayerNorm takes the fast variance E[r^2] - mu^2 with eps 1e-12
in fp32 (:83-99), each Dense rounds as ``_proj`` does (the fp32 dot cast
to the compute dtype, then the bias added in it), and the epilogue's
dropout masks are the attention mask's hash over (row within the batch
tile, query row, feature) with seed ``seed + tile`` (:109-137). A dropped
value divides by ``1 - rate`` in the compute dtype, as the JAX package's
weakly typed scalar does (bf16(0.9) in bf16).

The backward recomputes the forward from the layer inputs (only they are
saved) and runs ``_fl_bwd_kernel``'s order (:178-307): LN2 backward, W_m2,
the GELU derivative, W_m1, LN1 backward, W_ff, then the attention backward
with g = d_att in fp32 and the LN1 residual gradient added into dxq.

Weights in nn.Linear layout (out, in): qkv the 12 weights and biases of K2
(wq1, bq1, ..., wv2, bv2); ep = (w_ff, b_ff, ln1_s, ln1_b, w_m1 (ff, d),
b_m1, w_m2 (d, ff), b_m2, ln2_s, ln2_b) with the LayerNorm parameters in
fp32 whatever the compute dtype. The wrapper launches the CUDA kernels
(core/csrc/layer_stream*.cu) for CUDA tensors and runs the plain versions
only for CPU tensors. bf16 runs the tensor-core bodies (K2's projection
GEMM and two-block core, the epilogue on mma.sync over 64-row blocks, K2's
three-part chain for dx and the nine dW), fp32 K2's fp32 route for the
attention (the projections and K1's 3xTF32 core) around the row-tile
epilogue, its backward and the chain on the CUDA cores (``k4_body``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from . import attention as A

LN_EPS = 1e-12
# rows of (B * Lq) one block of the row-tile epilogue takes
# (layer_epilogue.cuh: kEpFwdRows, kEpBwdRows where a block's full rows fit
# its shared memory, as at every width up to 512; else kEpNarrowRows, else
# kEpNarrowestRows), and of bf16's tensor-core epilogue (kLmRows,
# layer_mma.cuh: 64 where d and ff are at most K4_MMA_NARROW, else 32); the
# backward's LayerNorm-parameter partial sums are one row of four d-vectors
# per block
K4_FWD_ROWS = 32
K4_BWD_ROWS = 16
K4_NARROW_ROWS = (8, 2)
K4_MMA_ROWS = 64
# the bf16 tensor-core epilogue holds a block's full rows of d and of ff in
# registers: 64 rows of widths up to 512, 32 of widths up to 768; past
# that bf16 K4 runs the row-tile epilogue (k4_epilogue_rows)
K4_MMA_NARROW = 512
K4_MMA_MAX_WIDTH = 768
# the row-tile epilogue's weight stage (ep_stage_bytes): 32 deep, 128
# columns, fp32, transposed (stride 129) or as is (stride 132)
_EP_STAGE_BYTES = 4 * 32 * 132
# bf16 K4b's nine weights' rows in chunks of k4_dw_chunk rows, about this
# many chunks in all, added in chunk order (K2's kernel, whose table holds
# attention.K2_DW_MAX_CHUNKS)
K4_DW_CHUNKS = 48

_ERF_P = 0.3275911
_ERF_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_INV_SQRT2 = float(1.0 / math.sqrt(2.0))
_INV_SQRT2PI = float(1.0 / math.sqrt(2.0 * math.pi))


def erf_poly(x):
    """erf by Abramowitz-Stegun 7.1.26 (max abs error 1.5e-7), in x's
    dtype."""
    ax = x.abs()
    t = 1.0 / (1.0 + _ERF_P * ax)
    poly = t * (_ERF_A[0] + t * (_ERF_A[1] + t * (
        _ERF_A[2] + t * (_ERF_A[3] + t * _ERF_A[4]))))
    e = 1.0 - poly * torch.exp(-ax * ax)
    return torch.where(x < 0, -e, e)


def gelu_f32(x):
    """The kernel's exact GELU on fp32 x (layer_kernel.py:73-74)."""
    return 0.5 * x * (1.0 + erf_poly(x * _INV_SQRT2))


def gelu_grad_f32(x):
    """Its derivative, cdf + x pdf (layer_kernel.py:77-80)."""
    cdf = 0.5 * (1.0 + erf_poly(x * _INV_SQRT2))
    pdf = torch.exp(-0.5 * x * x) * _INV_SQRT2PI
    return cdf + x * pdf


def layer_norm_fwd(r, s, b):
    """fp32 LayerNorm with the fast variance: (y, xhat, inv_sigma)."""
    mu = r.mean(-1, keepdim=True)
    var = (r * r).mean(-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var + LN_EPS)
    xhat = (r - mu) * inv
    return xhat * s.float() + b.float(), xhat, inv


def layer_norm_bwd(dy, xhat, inv, s):
    """d(input) of y = xhat s + b given dy (all fp32)."""
    dxhat = dy * s.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return inv * (dxhat - m1 - xhat * m2)


def _epi_drop(x, keep, rate):
    """keep ? x / (1 - rate) : 0 with the divisor in x's dtype."""
    div = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / div, torch.zeros_like(x))


def epilogue_fwd(xq, att, ep, num_heads: int, rate: float = 0.0,
                 seed: int = 0):
    """The epilogue (layer_kernel.py:109-137) on att (B, Lq, d): y2 in fp32
    and what the backward needs."""
    wff, bff, ln1s, ln1b, wm1, bm1, wm2, bm2, ln2s, ln2b = ep
    B, Lq, d = xq.shape
    ff = wm1.shape[0]
    keeps = [None] * 3
    if rate > 0:
        keeps = [A.feature_dropout_keep(B, Lq, w, seed, 2 * num_heads + i,
                                        rate, xq.device)
                 for i, w in enumerate((d, ff, d))]
    h = A._proj(att, wff, bff)
    if keeps[0] is not None:
        h = _epi_drop(h, keeps[0], rate)
    r1 = (xq + h).float()
    y1f, xhat1, inv1 = layer_norm_fwd(r1, ln1s, ln1b)
    y1 = y1f.to(xq.dtype)
    u = A._proj(y1, wm1, bm1)
    gact = gelu_f32(u.float()).to(xq.dtype)
    if keeps[1] is not None:
        gact = _epi_drop(gact, keeps[1], rate)
    m = A._proj(gact, wm2, bm2)
    if keeps[2] is not None:
        m = _epi_drop(m, keeps[2], rate)
    y2f, xhat2, inv2 = layer_norm_fwd((y1 + m).float(), ln2s, ln2b)
    return dict(y2=y2f, keeps=keeps, xhat1=xhat1, inv1=inv1, y1=y1, u=u,
                gact=gact, xhat2=xhat2, inv2=inv2)


def layer_stream_plain(xq, x1, x2, qkv, ep, mask_q, mask_1, mask_2,
                       num_heads: int, scale: float, rate: float = 0.0,
                       seed: int = 0):
    """K4f's plain version: K2's plain version into att (the compute
    dtype), then the epilogue. xq (B, Lq, d), x1 (B, L1, d), x2 (B, L2, d)
    -> (B, Lq, d) in xq's dtype."""
    att = A.proj_two_block_attention_plain(xq, x1, x2, *qkv, mask_q, mask_1,
                                           mask_2, num_heads, scale, rate,
                                           seed)
    return epilogue_fwd(xq, att, ep, num_heads, rate, seed)["y2"].to(
        xq.dtype)


def _col_sum(t):
    return t.reshape(-1, t.shape[-1]).sum(0)


def layer_stream_bwd_plain(xq, x1, x2, qkv, ep, mask_q, mask_1, mask_2, g,
                           num_heads: int, scale: float, rate: float = 0.0,
                           seed: int = 0):
    """K4b's plain version (``_fl_bwd_kernel``, layer_kernel.py:178-307).
    Returns (dxq, dx1, dx2, *dqkv (12), *dep (10)), each in its input's
    dtype."""
    wff, bff, ln1s, ln1b, wm1, bm1, wm2, bm2, ln2s, ln2b = ep
    att = A.proj_two_block_attention_plain(xq, x1, x2, *qkv, mask_q, mask_1,
                                           mask_2, num_heads, scale, rate,
                                           seed)
    e = epilogue_fwd(xq, att, ep, num_heads, rate, seed)
    keep_h, keep_g, keep_m = e["keeps"]
    div = torch.tensor(A.keep_divisor(rate), dtype=torch.float32,
                       device=xq.device)
    g2 = g.float()
    dln2s, dln2b = _col_sum(g2 * e["xhat2"]), _col_sum(g2)
    dr2 = layer_norm_bwd(g2, e["xhat2"], e["inv2"], ln2s)
    dm = dr2 if keep_m is None else torch.where(keep_m, dr2 / div, 0.0)
    dwm2, dbm2 = A.wgrad(e["gact"], dm, wm2, bm2)
    dgd = A.dgrad(dm, wm2)
    if keep_g is not None:
        dgd = torch.where(keep_g, dgd / div, 0.0)
    du = dgd * gelu_grad_f32(e["u"].float())
    dwm1, dbm1 = A.wgrad(e["y1"], du, wm1, bm1)
    dy1 = dr2 + A.dgrad(du, wm1)
    dln1s, dln1b = _col_sum(dy1 * e["xhat1"]), _col_sum(dy1)
    dr1 = layer_norm_bwd(dy1, e["xhat1"], e["inv1"], ln1s)
    dh = dr1 if keep_h is None else torch.where(keep_h, dr1 / div, 0.0)
    dwff, dbff = A.wgrad(att, dh, wff, bff)
    datt = A.dgrad(dh, wff)
    dys = A.proj_qkv_grads_plain(xq, x1, x2, qkv, (mask_q, mask_1, mask_2),
                                 datt, num_heads, scale, rate, seed)
    grads = A._chain_grads(xq, x1, x2, qkv, dys, dxq_add=dr1)
    dep = (dwff, dbff, dln1s, dln1b, dwm1, dbm1, dwm2, dbm2, dln2s, dln2b)
    return grads + tuple(t.to(p.dtype) for t, p in zip(dep, ep))


# ---------------------------------------------------------------------------
# launching the kernels
# ---------------------------------------------------------------------------

def k4_body(dtype) -> str:
    """Which bodies K4f and K4b run, by dtype, never on a failure:
    ``"mma"`` for bf16 (K2's projection GEMM and two-block core, the
    epilogue on mma.sync, the chain's dx and the nine dW in three bf16
    parts), ``"tf32"`` for fp32 (att and the qkv pass by K2's fp32 route,
    ``A.k2_body``; the row-tile epilogue, its backward and the chain on the
    CUDA cores)."""
    return A.k2_body(dtype)


def k4_dw_rows(B: int, Lq: int, L1: int, L2: int):
    """Rows of each of bf16 K4b's nine weight gradients: the six
    projections (q1 q2 k1 k2 v1 v2), then W_ff, W_m1, W_m2."""
    return [B * L for L in (Lq, Lq, L1, L2, L1, L2, Lq, Lq, Lq)]


def k4_dw_chunk(B: int, Lq: int, L1: int, L2: int) -> int:
    """Rows per chunk of bf16 K4b's weight gradients: about K4_DW_CHUNKS
    chunks over the nine weights' rows, a multiple of the products' 32-row
    step, each weight's chunks summed in order (as ``k2_dw_chunk``)."""
    rows = sum(k4_dw_rows(B, Lq, L1, L2))
    chunk = -(-rows // K4_DW_CHUNKS)
    return max(32, -(-chunk // 32) * 32)


def k4_dw_chunks(B: int, Lq: int, L1: int, L2: int, chunk: int):
    """Chunks of each of the nine weights at `chunk` rows."""
    return [-(-M // chunk) for M in k4_dw_rows(B, Lq, L1, L2)]


def k4_dw_shapes(d: int, ff: int):
    """(out, in) of the nine weights, in k4_dw_rows' order."""
    return [(d, d)] * 7 + [(ff, d), (d, ff)]


def k4_mma_rows(d: int, ff: int) -> int:
    """Rows of (B * Lq) a block of bf16 K4's epilogue takes: 64 where d and
    ff are at most K4_MMA_NARROW (lm512), else 32 (lm768)."""
    return K4_MMA_ROWS if max(d, ff) <= K4_MMA_NARROW else 32


def _align128(n: int) -> int:
    return (n + 127) // 128 * 128


def k4_rowtile_smem_bytes(dtype, d: int, ff: int, rows: int,
                          backward: bool) -> int:
    """Shared memory of a block of the row-tile epilogue over `rows` rows
    (``EpFwdLayout`` / ``EpBwdLayout``, csrc/layer_stream*.cu): tiles of
    the compute dtype (row stride w + 4 in fp32, w + 8 in bf16) and fp32
    (w + 4), the weight stage, the LayerNorms' row stats."""
    e = torch.tensor([], dtype=dtype).element_size()
    w = max(d, ff)

    def ld(n):
        return n + (4 if dtype == torch.float32 else 8)
    if not backward:
        g = _align128(e * rows * ld(w))
        c = g + _align128(e * rows * ld(ff))
        stage = c + _align128(4 * rows * (w + 4))
        return stage + _align128(_EP_STAGE_BYTES) + 2 * 4 * rows
    y1 = _align128(max(e * rows * ld(w), 4 * rows * (w + 4)))
    c = y1 + _align128(e * rows * ld(d))
    r2 = c + _align128(4 * rows * (w + 4))
    stage = r2 + _align128(4 * rows * (d + 4))
    return stage + _align128(_EP_STAGE_BYTES) + 4 * 4 * rows


def k4_epilogue_rows(dtype, d: int, ff: int, backward: bool) -> int:
    """Rows of (B * Lq) one block of K4's epilogue takes at widths d, ff,
    or 0 where no block fits (``ep_fwd_rows`` / ``ep_bwd_rows`` and
    ``lm_rows``): bf16 up to K4_MMA_MAX_WIDTH on the tensor-core epilogue
    (``k4_mma_rows``), every other shape on the row-tile epilogue, the
    most of K4_FWD_ROWS (K4_BWD_ROWS) and K4_NARROW_ROWS whose block fits
    one block's shared memory. Each row's sums run in the same order
    whatever its block's rows."""
    if dtype == torch.bfloat16 and max(d, ff) <= K4_MMA_MAX_WIDTH:
        return k4_mma_rows(d, ff)
    for rows in ((K4_BWD_ROWS if backward else K4_FWD_ROWS),
                 *K4_NARROW_ROWS):
        if k4_rowtile_smem_bytes(dtype, d, ff, rows, backward) \
                <= A.MAX_SMEM_BYTES:
            return rows
    return 0


def k4_epilogue_smem_bytes(d: int, ff: int, backward: bool) -> int:
    """The bf16 epilogue's shared memory (layer_mma.cuh) at its geometry
    (R rows, widths up to N): a ring of three stages, each the larger of
    (R + N) rows x 40 bf16 (forward products) and R x 40 fp32 + 32 x (N +
    8) bf16 (backward products); the seven fp32 bias and LayerNorm vectors
    of N; the backward's LN1 statistics and three R x 40 bf16 planes."""
    R = k4_mma_rows(d, ff)
    N = K4_MMA_NARROW if R == K4_MMA_ROWS else K4_MMA_MAX_WIDTH
    stage = max((R + N) * 40 * 2, R * 40 * 4 + 32 * (N + 8) * 2)
    fwd = 3 * stage + 4 * 7 * N
    return fwd + 4 * 2 * R + 3 * 2 * R * 40 if backward else fwd


def k4_mma_smem_bytes(Lq: int, L1: int, L2: int, D: int,
                      backward: bool, d: int = 512, ff: int = 512) -> int:
    """Shared memory of bf16 K4's largest block: K2's core on the path
    the shape takes (forward; the backward's with g in fp32, two bf16
    halves) or the epilogue's at widths d and ff (the tensor-core one up to
    K4_MMA_MAX_WIDTH, the row-tile one past it)."""
    core = A.k2_core_smem_bytes(Lq, L1, L2, D, False)
    if backward:
        core = max(core, A.k2_core_smem_bytes(Lq, L1, L2, D, True,
                                              g_fp32=True))
    if max(d, ff) > K4_MMA_MAX_WIDTH:
        rows = k4_epilogue_rows(torch.bfloat16, d, ff, backward) or \
            K4_NARROW_ROWS[-1]
        return max(core, k4_rowtile_smem_bytes(torch.bfloat16, d, ff, rows,
                                               backward))
    return max(core, k4_epilogue_smem_bytes(d, ff, backward))


def _check_k4(xq, x1, x2, qkv, ep, masks, num_heads, g=None):
    B, Lq, L1, L2, d, dh = A._check_k2((xq, x1, x2) + tuple(qkv), masks,
                                       num_heads, g)
    wff, bff, ln1s, ln1b, wm1, bm1, wm2, bm2, ln2s, ln2b = ep
    ff = wm1.shape[0]
    want = ((wff, (d, d)), (bff, (d,)), (wm1, (ff, d)), (bm1, (ff,)),
            (wm2, (d, ff)), (bm2, (d,)))
    A._check_cuda(tuple(t for t, _ in want), xq.dtype)
    A._check_cuda((ln1s, ln1b, ln2s, ln2b), torch.float32)
    for t, shape in want + tuple((t, (d,)) for t in (ln1s, ln1b, ln2s,
                                                      ln2b)):
        if tuple(t.shape) != shape:
            raise ValueError(f"epilogue parameter must be {shape}, got "
                             f"{tuple(t.shape)}")
    if ff % 32:
        raise ValueError(f"ff={ff}: the epilogue takes ff % 32 == 0")
    if not all(k4_epilogue_rows(xq.dtype, d, ff, bwd) for bwd in (False,
                                                                  True)):
        raise ValueError(f"(d, ff)={(d, ff)}: the epilogue's block of "
                         f"{K4_NARROW_ROWS[-1]} full rows exceeds one block's "
                         "shared memory")
    if any(t.data_ptr() % 16 for t in (wff, wm1, wm2)):
        raise ValueError("inputs must start on a 16-byte boundary")
    return B, Lq, L1, L2, d, dh, ff


def _epi_div(rate, dtype):
    """1 - rate in the compute dtype, as a float (the epilogue's divisor)."""
    return float(torch.tensor(1.0 - rate, dtype=dtype).float())


def _k4_forward_cuda(xq, x1, x2, qkv, ep, masks, num_heads, scale, rate,
                     seed):
    """K4f: att (B, Lq, d) in the compute dtype, then the epilogue. bf16:
    K2f's projection GEMM and core, then the tensor-core epilogue (y1 and g
    through transient (B, Lq, ·) tensors); three launches. fp32: K2f's
    fp32 route, then the row-tile epilogue."""
    B, Lq, L1, L2, d, dh, ff = _check_k4(xq, x1, x2, qkv, ep, masks,
                                         num_heads)
    tf32 = k4_body(xq.dtype) == "tf32"
    fn = A._fn("layer_stream", "segmm_layer_stream_fwd", ctypes.c_int,
               [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
               + [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_void_p),
                                          ctypes.c_void_p]
               + [ctypes.c_int] * 7 + [ctypes.c_float] + A._DROP_ARGS[:2]
               + [ctypes.c_float, ctypes.c_uint32, ctypes.c_void_p])
    mq, m1, m2 = A._masks_i32(*masks)
    out = torch.empty_like(xq)
    work = [A._k2_tf32_forward(xq, x1, x2, qkv, masks, num_heads, scale,
                               rate, seed) if tf32
            else torch.empty_like(xq)]  # att
    if not tf32:
        work += [torch.empty_like(xq),
                 torch.empty(B, Lq, ff, dtype=xq.dtype, device=xq.device)]
        work += A.k2_workspace(xq, x1, x2)
    rate, kdiv, seed = A._drop_args(rate, seed)
    with torch.cuda.device(xq.device):
        code = fn(A._DTYPE_CODE[xq.dtype], A._ptrs((xq, x1, x2, *qkv, *ep)),
                  mq.data_ptr(), m1.data_ptr(), m2.data_ptr(),
                  A._ptrs(work), out.data_ptr(), B, Lq, L1, L2, d,
                  num_heads, ff, float(scale), rate, kdiv,
                  _epi_div(rate, xq.dtype), seed, A._stream_ptr(xq.device))
    A._raise_on_cuda_error(code, "layer_stream")
    A.LAUNCHES["layer_stream"] += 1
    return out


def _k4_backward_cuda(xq, x1, x2, qkv, ep, masks, g, num_heads, scale, rate,
                      seed):
    """K4b: att recomputed as K4f makes it; the epilogue-backward
    row-tile kernel (d_att in fp32, the LN1 residual gradient dr1, what the
    epilogue's weight gradients need, per-block LayerNorm partial sums);
    the LayerNorm gradients summed in order; then K2b's qkv pass on g =
    d_att and its chain with dxq += dr1 and the epilogue's three dW, db.
    bf16: the tensor-core bodies, dW in k4_dw_chunk row chunks (eight
    launches); fp32: att and the qkv pass by K2's fp32 route around the
    CUDA-core epilogue backward (``segmm_layer_stream_bwd``) and chain
    (``segmm_layer_stream_chain_bwd``), dW in K2_DW_SPLITS chunks."""
    B, Lq, L1, L2, d, dh, ff = _check_k4(xq, x1, x2, qkv, ep, masks,
                                         num_heads, g)
    fn = A._fn("layer_stream_bwd", "segmm_layer_stream_bwd", ctypes.c_int,
               [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
               + [ctypes.c_void_p] * 4
               + [ctypes.POINTER(ctypes.c_void_p)] * 3
               + [ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_float]
               + A._DROP_ARGS[:2] + [ctypes.c_float, ctypes.c_uint32,
                                     ctypes.c_void_p])
    mq, m1, m2 = A._masks_i32(*masks)
    dev, f32, T = xq.device, torch.float32, xq.dtype
    mma = k4_body(T) == "mma"
    rows = B * Lq
    rows_per_block = k4_epilogue_rows(T, d, ff, True)
    nblk = (rows + rows_per_block - 1) // rows_per_block
    # workspace: att (T), y1 (T), gact (T); d_att (bf16: its hi and lo
    # halves in the same bytes), dr1, dm, dh (rows, d), du (rows, ff) fp32;
    # the LayerNorm partials (nblk, 4, d); the six fp32 dq..dv of the
    # attention backward; bf16, K2's projection workspace
    work = [torch.empty(B, Lq, w, dtype=t, device=dev) for t, w in
            ((T, d), (T, d), (T, ff), (f32, d), (f32, d), (f32, d), (f32, d),
             (f32, ff))]
    work.append(torch.empty(nblk, 4, d, dtype=f32, device=dev))
    work += [torch.empty(B, L, d, dtype=f32, device=dev)
             for L in (Lq, Lq, L1, L2, L1, L2)]
    if mma:
        work += A.k2_workspace(xq, x1, x2)
    dx = [torch.empty_like(x) for x in (xq, x1, x2)]
    shapes = [(d, d)] * 6 + [(d,)] * 6 + [(d, d), (d,), (d,), (d,), (ff, d),
                                          (ff,), (d, ff), (d,), (d,), (d,)]
    grads = [torch.empty(s, dtype=f32, device=dev) for s in shapes]
    # the row-chunk partials of the nine dW, db
    splits = A.K2_DW_SPLITS
    if mma:
        chunk = k4_dw_chunk(B, Lq, L1, L2)
        parts = sum(n * (o * i + o) for n, (o, i) in zip(
            k4_dw_chunks(B, Lq, L1, L2, chunk), k4_dw_shapes(d, ff)))
    else:
        chunk = 0
        parts = splits * (7 * (d * d + d) + 2 * d * ff + ff + d)
    scratch = torch.empty(parts, dtype=f32, device=dev)
    args = (rate, seed)
    rate, kdiv, seed = A._drop_args(rate, seed)
    ptrs = A._ptrs((xq, x1, x2, *qkv, *ep))
    if not mma:  # att, as the forward made it
        work[0] = A._k2_tf32_forward(xq, x1, x2, qkv, masks, num_heads,
                                     scale, *args)
    # bf16: all of K4b; fp32: the epilogue backward (d_att in work[3]) and
    # the LayerNorm gradients
    with torch.cuda.device(dev):
        code = fn(A._DTYPE_CODE[T], ptrs, mq.data_ptr(), m1.data_ptr(),
                  m2.data_ptr(), g.data_ptr(), A._ptrs(work), A._ptrs(dx),
                  A._ptrs(grads), scratch.data_ptr(), B, Lq, L1, L2, d,
                  num_heads, ff, splits, chunk, float(scale), rate, kdiv,
                  _epi_div(rate, T), seed, A._stream_ptr(dev))
    A._raise_on_cuda_error(code, "layer_stream_bwd")
    if not mma:  # the qkv pass on d_att into work[9..14], then the chain
        work[9:15] = A._k2_tf32_qkv_grads(xq, x1, x2, qkv, masks, work[3],
                                          num_heads, scale, *args)
        chain = A._fn("layer_stream_bwd", "segmm_layer_stream_chain_bwd",
                      ctypes.c_int, [ctypes.POINTER(ctypes.c_void_p)] * 4
                      + [ctypes.c_void_p] + [ctypes.c_int] * 7
                      + [ctypes.c_void_p])
        with torch.cuda.device(dev):
            code = chain(ptrs, A._ptrs(work), A._ptrs(dx), A._ptrs(grads),
                         scratch.data_ptr(), B, Lq, L1, L2, d, ff, splits,
                         A._stream_ptr(dev))
        A._raise_on_cuda_error(code, "layer_stream_chain_bwd")
    A.LAUNCHES["layer_stream_bwd"] += 1
    params = tuple(qkv[0::2]) + tuple(qkv[1::2]) + tuple(ep)
    out = [t.to(p.dtype) for t, p in zip(grads, params)]
    # the kernel writes dW0..dW5 then db0..db5; interleave as qkv is
    dqkv = [t for i in range(6) for t in (out[i], out[6 + i])]
    return tuple(dx) + tuple(dqkv) + tuple(out[12:])


# ---------------------------------------------------------------------------
# autograd and the public entry point
# ---------------------------------------------------------------------------

class _LayerStream(torch.autograd.Function):
    """K4f forward and K4b backward (``_fused_layer`` custom VJP,
    layer_kernel.py:457-489): saves only the layer inputs, parameters,
    masks and seed; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, xq, x1, x2, *rest):
        qkv, ep = rest[:12], rest[12:22]
        masks = rest[22:25]
        num_heads, scale, rate, seed = rest[25:]
        ctx.save_for_backward(xq, x1, x2, *qkv, *ep, *masks)
        ctx.hyper = (num_heads, scale, rate, seed)
        if A._device_kind(xq) == "cpu":
            return layer_stream_plain(xq, x1, x2, qkv, ep, *masks, num_heads,
                                      scale, rate, seed)
        return _k4_forward_cuda(xq, x1, x2, qkv, ep, masks, num_heads, scale,
                                rate, seed)

    @staticmethod
    def backward(ctx, g):
        s = ctx.saved_tensors
        xq, x1, x2, qkv, ep, masks = s[0], s[1], s[2], s[3:15], s[15:25], \
            s[25:28]
        g = g.contiguous()
        if g.device.type == "cpu":
            grads = layer_stream_bwd_plain(xq, x1, x2, qkv, ep, *masks, g,
                                           *ctx.hyper)
        else:
            grads = _k4_backward_cuda(xq, x1, x2, qkv, ep, masks, g,
                                      *ctx.hyper)
        return tuple(grads) + (None,) * 7


def fused_layer_stream(xq, x1, x2, qkv: Sequence, ep: Sequence, mask_q,
                       mask_1, mask_2, *, num_heads: int,
                       dropout_rate: float = 0.0, seed: int = 0,
                       deterministic: bool = True,
                       scale: Optional[float] = None):
    """One SegFormerX encoder-layer stream in one kernel (K4): ``qkv`` six
    (weight, bias) pairs in block order (q1, q2, k1, k2, v1, v2), ``ep`` =
    (w_ff, b_ff, ln1_s, ln1_b, w_m1, b_m1, w_m2, b_m2, ln2_s, ln2_b), all
    weights in nn.Linear layout. xq (B, Lq, d), x1 (B, L1, d), x2 (B, L2,
    d) -> (B, Lq, d). Differentiable (K4b, which saves only the inputs);
    with ``deterministic=False`` the dropout masks of ``seed`` apply."""
    d = xq.shape[-1]
    if d % num_heads:
        raise ValueError(f"d={d} is not a multiple of num_heads={num_heads}")
    if scale is None:
        scale = 1.0 / math.sqrt(d // num_heads)
    flat = [t for p in qkv for t in p]
    if len(flat) != 12 or len(ep) != 10:
        raise ValueError("qkv takes six (weight, bias) pairs and ep ten "
                         "tensors")
    return _LayerStream.apply(xq, x1, x2, *flat, *ep, mask_q, mask_1, mask_2,
                              int(num_heads), float(scale),
                              A._rate(dropout_rate, deterministic),
                              int(seed))
