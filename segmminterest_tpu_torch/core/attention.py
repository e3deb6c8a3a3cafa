"""Masked attention kernel wrappers, their backward kernels and their plain
PyTorch versions (port of ``segmminterest_tpu/core/attention.py``, forward
and custom VJP): two-block jointly normalised attention, K1
(fused_two_block_attention) and K2 (fused_proj_two_block_attention v1), and
single-block masked attention, K3 (fused_masked_attention, the CrossAtt and
SelfAtt ablations' kernel: one key block, the same order of operations).

Semantics (reference order of operations, encoder.py:44-161):

    l1 = q1 . k1^T,  l2 = q2 . k2^T        per head, fp32 accumulation
    fill -10000 where mask_q x mask_k is 0  (before the scale)
    training: keep ? l / (1 - rate) : 0     (a dropped masked logit is 0)
    x scale                                 (1/sqrt(head dim))
    one fp32 softmax over [l1 | l2]
    out = p1 . v1 + p2 . v2                 p cast to v's dtype first, both
                                            products in fp32, summed, cast

A fully padded query row is the uniform softmax of a constant, not zero.

The dropout mask is the JAX package's interpret-mode hash
(``_dropout_keep``, attention.py:114-123), so the CUDA kernels, the plain
versions and the JAX kernels run with ``interpret=True`` draw the same bits:
iota axes (row within the batch tile, query row, key column), batch tile
``_pick_block_b`` (8 if B % 8 == 0 else B), seed ``seed + tile index``,
salt ``2h`` for block 1 and ``2h + 1`` for block 2 (K3: ``h``), uint32
arithmetic, keep iff ``(h >> 8) * 2^-24 >= rate`` in fp32.

The backward recomputes the probabilities (none are saved) and follows
``_bwd2_kernel`` / ``_attn_group_bwd`` (attention.py:448-622): dv = p^T g
with p in fp32, dp = g v^T, s summed over both blocks, dl = p (dp - s)
scale, then the dropout mask, then the pair mask, dq = dl k, dk = dl^T q.
K1's gradients come back in the input dtype; K2 keeps dq..dv in fp32 and
chains them through its projections (dx in x's dtype, dW and db summed
over the batch in fp32, then cast to the weight's dtype as
``_fp_bwd_rule`` does, attention.py:1044-1046).

K3's backward (``_bwd_kernel``, attention.py:156-203) is the same with one
block: dv = p^T g, dl = p (dp - sum dp p) scale, dropout mask, pair mask,
dq = dl k, dk = dl^T q, each gradient in its input's dtype.

K6 is K2's version 2 (``_fp2_fwd_kernel`` / ``_fp2_bwd_kernel``,
attention.py:1198-1372), taken under ``SEGMM_ATTN_V2=1`` or ``version=2``:
the Q and K weights interleaved per head (``interleave_ws``), so that head h
has one query row q_c = [q1_h | q2_h] of width 2 Dh and one key axis of
Lk = L1 + L2 rows ([k1_h | 0] then [0 | k2_h]); one contraction, one fill,
one dropout mask over (query, concatenated key) with salt h (K3's form),
one softmax, one PV over Lk. The backward's weight gradients come out for
the interleaved weights and are de-interleaved. The function is K2's; the
mask bits and the order of the sums are not.

Each wrapper launches its CUDA kernel (``core/csrc``) for CUDA tensors and
runs the plain version only for CPU tensors; there is no fall-back from one
to the other.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch

from .numerics import MASK_FILL_VALUE

# launches of each kernel, counted where the wrapper launches it (plain ints)
LAUNCHES = {"two_block_attention": 0, "proj_two_block_attention": 0,
            "two_block_attention_bwd": 0, "proj_two_block_attention_bwd": 0,
            "proj_two_block_attention_qkv_bwd": 0, "masked_attention": 0,
            "masked_attention_bwd": 0, "dual_stream_attention": 0,
            "dual_stream_attention_bwd": 0, "layer_stream": 0,
            "layer_stream_bwd": 0, "proj_two_block_attention_v2": 0,
            "proj_two_block_attention_v2_bwd": 0}

# the most shared memory one block may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232_448
MAX_GRID_Y = 65_535
K2_MAX_LEN = 128
K2_HEAD_DIMS = (16, 32, 64)
# K3 keeps a whole key row in registers (fp32: per lane group in its
# backward; bf16: a warp's 16 x Lk logit tile)
K3_MAX_LEN = 128
K3_HEAD_DIMS = (16, 32, 64)
# the backward kernels keep a whole probability row per lane group in
# registers: every stream at most 128 long, head dim at most 64
BWD_MAX_LEN = 128
BWD_MAX_HEAD_DIM = 64
# K2's weight gradients are summed over the batch in this many row chunks,
# then the chunks are added in order (deterministic, no atomics)
K2_DW_SPLITS = 4
# SEGMM_ATTN_V3_BWD=1: K2's backward emits dq..dv only (K7b) and leaves dx,
# dW and db to torch.matmul, as the JAX package's switch does (:1565)
ATTN_V3_BWD = os.environ.get("SEGMM_ATTN_V3_BWD", "0") == "1"
# SEGMM_ATTN_V2=1: fused_proj_two_block_attention defaults to version 2
# (K6), as the JAX package's switch does (:51)
ATTN_V2 = os.environ.get("SEGMM_ATTN_V2", "0") == "1"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
DEFAULT_BLOCK_B = 8


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pick_block_b(B: int) -> int:
    """The TPU kernels' batch tile (attention.py:206-209); the dropout hash
    is seeded per tile."""
    return DEFAULT_BLOCK_B if B % DEFAULT_BLOCK_B == 0 else B


def keep_divisor(rate: float) -> float:
    """``1 - rate`` as JAX forms it: in double, rounded once to fp32."""
    return float(torch.tensor(1.0 - rate, dtype=torch.float32))


# ---------------------------------------------------------------------------
# the dropout mask (attention.py:114-123, interpret mode)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32), without int64 overflow."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _U32


def dropout_keep(B: int, H: int, Lq: int, Lk: int, seed: int, block: int,
                 rate: float, device, salt_stride: int = 2,
                 head_offset: int = 0) -> torch.Tensor:
    """(B, H, Lq, Lk) bool keep-mask for heads 0..H-1, the bits of
    ``_dropout_keep(interpret=True)`` with salt
    ``salt_stride * (head_offset + h) + block``: K1/K2 draw key block
    ``block`` (0 or 1) with stride 2, K3 its one block with stride 1 and
    block 0 (salt ``h``, attention.py:146-148); K5's user stream takes head
    offset H (dual_kernel.py:100-101)."""
    bt = pick_block_b(B)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    b = ar(B)
    row = _mul32(b % bt, 2654435761)[:, None, None, None]
    col = _mul32(ar(Lq), 40503)[None, None, :, None]
    key = _mul32(ar(Lk), 69069)[None, None, None, :]
    seed_val = (seed + b // bt) & _U32
    salt = salt_stride * (ar(H) + head_offset) + block
    h = ((row ^ col ^ key)
         + _mul32(seed_val, 2246822519)[:, None, None, None]
         + _mul32(salt, 3266489917)[None, :, None, None]) & _U32
    h = _mul32(h ^ (h >> 15), 2246822519)
    h = h ^ (h >> 13)
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u >= torch.tensor(rate, dtype=torch.float32, device=device)


def feature_dropout_keep(B: int, Lq: int, d: int, seed: int, salt: int,
                         rate: float, device) -> torch.Tensor:
    """(B, Lq, d) bool keep-mask of one salt over (row within the batch
    tile, query row, feature): the bits K4's epilogue draws for its three
    dropouts with salts 2H, 2H + 1, 2H + 2 (layer_kernel.py:115-132)."""
    return dropout_keep(B, 1, Lq, d, seed, salt, rate, device)[:, 0]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _pair_mask(mask_q, mask_k):
    """(B, 1, Lq, Lk) bool: mq x mk > 0 in int32, as the TPU kernel forms it
    (attention.py:798-799)."""
    mq = mask_q.to(torch.int32)
    mk = mask_k.to(torch.int32)
    return ((mq[:, :, None] * mk[:, None, :]) > 0)[:, None]


def _keeps(q1, L1, L2, rate, seed, head_offset=0):
    """Both blocks' keep-masks for (B, Lq, H, D) queries, or None when no
    dropout applies."""
    if rate <= 0:
        return None, None
    B, Lq, H = q1.shape[:3]
    return tuple(dropout_keep(B, H, Lq, L, seed, blk, rate, q1.device,
                              head_offset=head_offset)
                 for blk, L in ((0, L1), (1, L2)))


def _joint_probs(l1, l2, pair1, pair2, scale, keep1=None, keep2=None,
                 keep_div=1.0):
    """mask fill -> dropout -> scale -> one fp32 softmax over both blocks
    (attention.py:374-396)."""
    l1 = torch.where(pair1, l1, MASK_FILL_VALUE)
    l2 = torch.where(pair2, l2, MASK_FILL_VALUE)
    if keep1 is not None:
        div = torch.tensor(keep_div, dtype=torch.float32, device=l1.device)
        l1 = torch.where(keep1, l1 / div, 0.0)
        l2 = torch.where(keep2, l2 / div, 0.0)
    l1 = l1 * scale
    l2 = l2 * scale
    m = torch.maximum(l1.amax(-1, keepdim=True), l2.amax(-1, keepdim=True))
    e1 = torch.exp(l1 - m)
    e2 = torch.exp(l2 - m)
    den = e1.sum(-1, keepdim=True) + e2.sum(-1, keepdim=True)
    return e1 / den, e2 / den


def _logits(q, k):
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def two_block_attention_plain(q1, q2, k1, k2, v1, v2, mask_q, mask_k1,
                              mask_k2, scale: float, rate: float = 0.0,
                              seed: int = 0, head_offset: int = 0):
    """K1's plain version: q1/q2 (B, Lq, H, D), k1/v1 (B, L1, H, D),
    k2/v2 (B, L2, H, D) -> (B, Lq, H, D) in q1's dtype. ``rate`` > 0 applies
    the dropout mask of ``seed`` (salted from head ``head_offset`` on)."""
    keep1, keep2 = _keeps(q1, k1.shape[1], k2.shape[1], rate, seed,
                          head_offset)
    p1, p2 = _joint_probs(_logits(q1, k1), _logits(q2, k2),
                          _pair_mask(mask_q, mask_k1),
                          _pair_mask(mask_q, mask_k2), scale, keep1, keep2,
                          keep_divisor(rate))
    out = (torch.einsum("bhqk,bkhd->bqhd", p1.to(v1.dtype).float(),
                        v1.float())
           + torch.einsum("bhqk,bkhd->bqhd", p2.to(v2.dtype).float(),
                          v2.float()))
    return out.to(q1.dtype)


def _joint_bwd_plain(q1, q2, k1, k2, v1, v2, mask_q, mask_k1, mask_k2, g,
                     scale, rate, seed, head_offset=0):
    """The joint-softmax backward of ``_attn_group_bwd`` (attention.py:
    448-524) on (B, L, H, D) tensors; fp32 dq1, dq2, dk1, dk2, dv1, dv2."""
    pair1 = _pair_mask(mask_q, mask_k1)
    pair2 = _pair_mask(mask_q, mask_k2)
    keep1, keep2 = _keeps(q1, k1.shape[1], k2.shape[1], rate, seed,
                          head_offset)
    p1, p2 = _joint_probs(_logits(q1, k1), _logits(q2, k2), pair1, pair2,
                          scale, keep1, keep2, keep_divisor(rate))
    gf = g.float()
    dv1 = torch.einsum("bhqk,bqhd->bkhd", p1, gf)
    dv2 = torch.einsum("bhqk,bqhd->bkhd", p2, gf)
    dp1 = torch.einsum("bqhd,bkhd->bhqk", gf, v1.float())
    dp2 = torch.einsum("bqhd,bkhd->bhqk", gf, v2.float())
    # the dot term sums over BOTH blocks
    s = (dp1 * p1).sum(-1, keepdim=True) + (dp2 * p2).sum(-1, keepdim=True)
    dl1 = p1 * (dp1 - s) * scale
    dl2 = p2 * (dp2 - s) * scale
    if keep1 is not None:
        div = torch.tensor(keep_divisor(rate), dtype=torch.float32,
                           device=g.device)
        dl1 = torch.where(keep1, dl1 / div, 0.0)
        dl2 = torch.where(keep2, dl2 / div, 0.0)
    dl1 = torch.where(pair1, dl1, 0.0)
    dl2 = torch.where(pair2, dl2, 0.0)
    dq1 = torch.einsum("bhqk,bkhd->bqhd", dl1, k1.float())
    dq2 = torch.einsum("bhqk,bkhd->bqhd", dl2, k2.float())
    dk1 = torch.einsum("bhqk,bqhd->bkhd", dl1, q1.float())
    dk2 = torch.einsum("bhqk,bqhd->bkhd", dl2, q2.float())
    return dq1, dq2, dk1, dk2, dv1, dv2


def two_block_attention_bwd_plain(q1, q2, k1, k2, v1, v2, mask_q, mask_k1,
                                  mask_k2, g, scale: float, rate: float = 0.0,
                                  seed: int = 0):
    """K1b's plain version (``_bwd2_kernel``, attention.py:558-622):
    dq1, dq2, dk1, dk2, dv1, dv2, each in its input's dtype."""
    grads = _joint_bwd_plain(q1, q2, k1, k2, v1, v2, mask_q, mask_k1,
                             mask_k2, g, scale, rate, seed)
    return tuple(d.to(t.dtype)
                 for d, t in zip(grads, (q1, q2, k1, k2, v1, v2)))


def _proj(x, w, b):
    """x . W^T + b with W in nn.Linear layout (out, in): the fp32 dot is cast
    to x's dtype and the bias added in that dtype (attention.py:769-773)."""
    return (torch.matmul(x.float(), w.float().t()).to(x.dtype)
            + b.to(x.dtype))


def _heads(t, num_heads):
    return t.reshape(t.shape[0], t.shape[1], num_heads, -1)


def _projections(xq, x1, x2, ws, num_heads):
    wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2 = ws
    return tuple(_heads(_proj(x, w, b), num_heads) for x, w, b in (
        (xq, wq1, bq1), (xq, wq2, bq2), (x1, wk1, bk1), (x2, wk2, bk2),
        (x1, wv1, bv1), (x2, wv2, bv2)))


def proj_two_block_attention_plain(xq, x1, x2, wq1, bq1, wq2, bq2, wk1, bk1,
                                   wk2, bk2, wv1, bv1, wv2, bv2, mask_q,
                                   mask_1, mask_2, num_heads: int,
                                   scale: float, rate: float = 0.0,
                                   seed: int = 0, head_offset: int = 0):
    """K2's plain version: the six projections, then K1's plain version.
    xq (B, Lq, d), x1 (B, L1, d), x2 (B, L2, d) -> (B, Lq, d)."""
    ws = (wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2)
    out = two_block_attention_plain(
        *_projections(xq, x1, x2, ws, num_heads), mask_q, mask_1, mask_2,
        scale, rate, seed, head_offset)
    return out.reshape(xq.shape)


def dgrad(dy, w):
    """dy . W for an fp32 dy and W in nn.Linear layout (out, in): the
    gradient of x . W^T with respect to x, in fp32."""
    return torch.matmul(dy, w.float())


def wgrad(x, dy, w, b):
    """dW = dy^T x (nn.Linear layout) and db = sum dy over every row, in
    fp32, cast to the dtypes of ``w`` and ``b``."""
    dyf = dy.reshape(-1, dy.shape[-1])
    return ((dyf.t() @ x.reshape(-1, x.shape[-1]).float()).to(w.dtype),
            dyf.sum(0).to(b.dtype))


def _chain_grads(xq, x1, x2, ws, dys, dxq_add=None):
    """dx through the projections and dW, db over the whole batch, fp32
    (attention.py:854-894 and 1720-1735); dW in nn.Linear layout.
    ``dxq_add`` (fp32) joins dxq's sum before its cast, as K4's LayerNorm
    residual gradient does (layer_kernel.py:296-297)."""
    wq1, _, wq2, _, wk1, _, wk2, _, wv1, _, wv2, _ = ws
    dq1, dq2, dk1, dk2, dv1, dv2 = dys
    dxq = dgrad(dq1, wq1) + dgrad(dq2, wq2)
    if dxq_add is not None:
        dxq = dxq + dxq_add
    dxq = dxq.to(xq.dtype)
    dx1 = (dgrad(dk1, wk1) + dgrad(dv1, wv1)).to(x1.dtype)
    dx2 = (dgrad(dk2, wk2) + dgrad(dv2, wv2)).to(x2.dtype)
    dws = []
    for x, dy, i in ((xq, dq1, 0), (xq, dq2, 2), (x1, dk1, 4), (x2, dk2, 6),
                     (x1, dv1, 8), (x2, dv2, 10)):
        dws += wgrad(x, dy, ws[i], ws[i + 1])
    return (dxq, dx1, dx2, *dws)


def proj_qkv_grads_plain(xq, x1, x2, ws, masks, g, num_heads: int,
                         scale: float, rate: float = 0.0, seed: int = 0,
                         head_offset: int = 0):
    """K2b's qkv pass in plain PyTorch: the projections recomputed with
    ``_proj``'s rounding, the core backward in fp32; fp32 dq1, dq2, dk1,
    dk2, dv1, dv2 as (B, L, d). ``g`` may be fp32 whatever x's dtype."""
    grads = _joint_bwd_plain(*_projections(xq, x1, x2, ws, num_heads),
                             *masks, _heads(g, num_heads), scale, rate, seed,
                             head_offset)
    return [t.reshape(t.shape[0], t.shape[1], -1) for t in grads]


def proj_two_block_attention_bwd_plain(xq, x1, x2, wq1, bq1, wq2, bq2, wk1,
                                       bk1, wk2, bk2, wv1, bv1, wv2, bv2,
                                       mask_q, mask_1, mask_2, g,
                                       num_heads: int, scale: float,
                                       rate: float = 0.0, seed: int = 0):
    """K2b's plain version (``_fp_bwd_kernel``, attention.py:808-894):
    recompute the projections with ``_proj``'s rounding, the core backward
    in fp32, then dxq, dx1, dx2 (x's dtype) and dW, db of the six
    projections (each cast to its weight's dtype)."""
    ws = (wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2)
    dys = proj_qkv_grads_plain(xq, x1, x2, ws, (mask_q, mask_1, mask_2), g,
                               num_heads, scale, rate, seed)
    return _chain_grads(xq, x1, x2, ws, dys)


def _masked_probs(q, k, mask_q, mask_k, scale, rate, seed):
    """K3's probabilities (B, H, Lq, Lk) in fp32 (attention.py:141-150):
    fill, dropout, scale, softmax; and the pair and keep masks."""
    pair = _pair_mask(mask_q, mask_k)
    logits = torch.where(pair, _logits(q, k), MASK_FILL_VALUE)
    keep = None
    if rate > 0:
        B, Lq, H = q.shape[:3]
        keep = dropout_keep(B, H, Lq, k.shape[1], seed, 0, rate, q.device,
                            salt_stride=1)
        div = torch.tensor(keep_divisor(rate), dtype=torch.float32,
                           device=q.device)
        logits = torch.where(keep, logits / div, 0.0)
    logits = logits * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True), pair, keep


def masked_attention_plain(q, k, v, mask_q, mask_k, scale: float,
                           rate: float = 0.0, seed: int = 0):
    """K3's plain version (``_fwd_kernel``, attention.py:126-153): q
    (B, Lq, H, Dqk), k (B, Lk, H, Dqk), v (B, Lk, H, Dv), masks (B, L) ->
    (B, Lq, H, Dv) in q's dtype; the probabilities are cast to v's dtype
    before the fp32 AV product. ``rate`` > 0 applies the dropout mask of
    ``seed``."""
    p, _, _ = _masked_probs(q, k, mask_q, mask_k, scale, rate, seed)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def masked_attention_bwd_plain(q, k, v, mask_q, mask_k, g, scale: float,
                               rate: float = 0.0, seed: int = 0):
    """K3b's plain version (``_bwd_kernel``, attention.py:156-203): the
    probabilities recomputed in fp32, dv = p^T g, dp = g v^T,
    dl = p (dp - sum dp p) scale, then the dropout mask and divisor, then the
    pair mask; dq = dl k, dk = dl^T q. dq, dk, dv in their inputs' dtypes."""
    dq, dk, dv = _masked_bwd_f32(q, k, v, mask_q, mask_k, g, scale, rate,
                                 seed)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _masked_bwd_f32(q, k, v, mask_q, mask_k, g, scale, rate, seed):
    """The single-block backward of K3b and K6b in fp32: dq, dk, dv."""
    p, pair, keep = _masked_probs(q, k, mask_q, mask_k, scale, rate, seed)
    gf = g.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.float())
    dl = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    if keep is not None:
        div = torch.tensor(keep_divisor(rate), dtype=torch.float32,
                           device=g.device)
        dl = torch.where(keep, dl / div, 0.0)
    dl = torch.where(pair, dl, 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, q.float())
    return dq, dk, dv


def interleave_ws(wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, num_heads: int):
    """K6's interleaved Q and K parameters (``_interleave_ws``,
    attention.py:1156-1173) in nn.Linear layout: Wq_c, Wk1_c, Wk2_c
    (2d, d) and their (2d,) biases. Head h's rows [2h Dh, 2h Dh + Dh) of
    Wq_c are wq1's rows of head h and the next Dh rows wq2's; Wk1_c holds
    [wk1_h | 0] and Wk2_c [0 | wk2_h]."""
    d = wq1.shape[0]
    H = num_heads

    def il(a, b):
        return torch.stack([a.reshape(H, d // H, -1), b.reshape(H, d // H, -1)],
                           1).reshape(2 * d, *a.shape[1:])

    zw, zb = torch.zeros_like(wk1), torch.zeros_like(bk1)
    return (il(wq1, wq2), il(bq1, bq2), il(wk1, zw), il(bk1, zb),
            il(zw, wk2), il(zb, bk2))


def deinterleave_w(dw, num_heads: int, slot: int):
    """(2d, d) gradient of an interleaved weight -> the (d, d) gradient of
    slot 0 or 1 (``_deinterleave_w``, attention.py:1176-1180)."""
    d = dw.shape[1]
    return dw.reshape(num_heads, 2, d // num_heads, d)[:, slot].reshape(d, d)


def deinterleave_b(db, num_heads: int, slot: int):
    """(2d,) gradient of an interleaved bias -> the (d,) gradient of slot 0
    or 1 (``_deinterleave_b``, attention.py:1183-1186)."""
    d = db.shape[0] // 2
    return db.reshape(num_heads, 2, d // num_heads)[:, slot].reshape(d)


def _v2_operands(xq, x1, x2, ws, num_heads):
    """The interleaved parameters and K6's operands with ``_proj``'s
    rounding: q_c (B, Lq, H, 2Dh), the concatenated keys (B, Lk, H, 2Dh)
    and values (B, Lk, H, Dh) (attention.py:1211-1215)."""
    wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2 = ws
    cws = interleave_ws(wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, num_heads)
    wq_c, bq_c, wk1_c, bk1_c, wk2_c, bk2_c = cws
    q = _heads(_proj(xq, wq_c, bq_c), num_heads)
    k = _heads(torch.cat([_proj(x1, wk1_c, bk1_c), _proj(x2, wk2_c, bk2_c)],
                         1), num_heads)
    v = _heads(torch.cat([_proj(x1, wv1, bv1), _proj(x2, wv2, bv2)], 1),
               num_heads)
    return cws, q, k, v


def proj_two_block_attention_v2_plain(xq, x1, x2, wq1, bq1, wq2, bq2, wk1,
                                      bk1, wk2, bk2, wv1, bv1, wv2, bv2,
                                      mask_q, mask_1, mask_2, num_heads: int,
                                      scale: float, rate: float = 0.0,
                                      seed: int = 0):
    """K6f's plain version (``_fp2_fwd_kernel``, attention.py:1198-1250):
    the interleaved projections, one (Lq, Lk) logit matrix per head, fill
    -10000, dropout over (query, concatenated key) with salt h, scale, fp32
    softmax, p cast to v's dtype, PV over Lk. xq (B, Lq, d), x1 (B, L1, d),
    x2 (B, L2, d) -> (B, Lq, d)."""
    ws = (wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2)
    _, q, k, v = _v2_operands(xq, x1, x2, ws, num_heads)
    out = masked_attention_plain(q, k, v, mask_q,
                                 torch.cat([mask_1, mask_2], 1), scale, rate,
                                 seed)
    return out.reshape(xq.shape)


def proj_two_block_attention_v2_bwd_plain(xq, x1, x2, wq1, bq1, wq2, bq2,
                                          wk1, bk1, wk2, bk2, wv1, bv1, wv2,
                                          bv2, mask_q, mask_1, mask_2, g,
                                          num_heads: int, scale: float,
                                          rate: float = 0.0, seed: int = 0):
    """K6b's plain version (``_fp2_bwd_kernel``, attention.py:1253-1372,
    and ``_fp2_bwd_rule`` :1519-1546): dq_c, the concatenated dk (both
    halves) and dv in fp32, dx through the interleaved weights (x's dtype),
    dW and db of the interleaved weights over the batch in fp32,
    de-interleaved and cast to each weight's dtype. Returns K2b's fifteen
    gradients in K2b's order."""
    ws = (wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2)
    H = num_heads
    cws, q, k, v = _v2_operands(xq, x1, x2, ws, H)
    wq_c, bq_c, wk1_c, bk1_c, wk2_c, bk2_c = cws
    dq, dk, dv = (t.reshape(t.shape[0], t.shape[1], -1)
                  for t in _masked_bwd_f32(q, k, v, mask_q,
                                           torch.cat([mask_1, mask_2], 1),
                                           _heads(g, H), scale, rate, seed))
    L1 = x1.shape[1]
    dk1, dk2, dv1, dv2 = dk[:, :L1], dk[:, L1:], dv[:, :L1], dv[:, L1:]
    dxq = dgrad(dq, wq_c).to(xq.dtype)
    dx1 = (dgrad(dk1, wk1_c) + dgrad(dv1, wv1)).to(x1.dtype)
    dx2 = (dgrad(dk2, wk2_c) + dgrad(dv2, wv2)).to(x2.dtype)
    # the interleaved weights' gradients are cast before they are
    # de-interleaved: the same values as the other order
    (dwq, dbq), (dwk1, dbk1), (dwk2, dbk2), (dwv1, dbv1), (dwv2, dbv2) = (
        wgrad(x, dy, w, b) for x, dy, w, b in (
            (xq, dq, wq_c, bq_c), (x1, dk1, wk1_c, bk1_c),
            (x2, dk2, wk2_c, bk2_c), (x1, dv1, wv1, bv1), (x2, dv2, wv2, bv2)))
    return (dxq, dx1, dx2,
            deinterleave_w(dwq, H, 0), deinterleave_b(dbq, H, 0),
            deinterleave_w(dwq, H, 1), deinterleave_b(dbq, H, 1),
            deinterleave_w(dwk1, H, 0), deinterleave_b(dbk1, H, 0),
            deinterleave_w(dwk2, H, 1), deinterleave_b(dbk2, H, 1),
            dwv1, dbv1, dwv2, dbv2)


# ---------------------------------------------------------------------------
# launching the kernels
# ---------------------------------------------------------------------------

def _check_cuda(tensors, dtype):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"all inputs must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")


def _masks_i32(*masks):
    return [m.to(torch.int32).contiguous() for m in masks]


def _check_mask(m, B, L, name):
    if tuple(m.shape) != (B, L):
        raise ValueError(f"{name} must be ({B}, {L}), got {tuple(m.shape)}")


def _stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on_cuda_error(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code}")


def _fn(lib_name, symbol, restype, argtypes):
    from .build import load_library
    fn = getattr(load_library(lib_name), symbol)
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


def _ptrs(ts):
    """A C array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


_DROP_ARGS = [ctypes.c_float, ctypes.c_float, ctypes.c_uint32]


def _drop_args(rate, seed):
    return float(rate), keep_divisor(rate), int(seed) & _U32


def _check_k1(tensors, masks, bwd):
    q1, q2, k1, k2, v1, v2 = tensors[:6]
    _check_cuda(tensors, q1.dtype)
    B, Lq, H, D = q1.shape
    L1, L2 = k1.shape[1], k2.shape[1]
    for t, L, name in ((q2, Lq, "q2"), (k1, L1, "k1"), (v1, L1, "v1"),
                       (k2, L2, "k2"), (v2, L2, "v2")) + (
                           ((tensors[6], Lq, "g"),) if bwd else ()):
        if tuple(t.shape) != (B, L, H, D):
            raise ValueError(f"{name} must be {(B, L, H, D)}, got "
                             f"{tuple(t.shape)}")
    for m, L, name in zip(masks, (Lq, L1, L2), ("mask_q", "mask_k1",
                                                  "mask_k2")):
        _check_mask(m, B, L, name)
    if D % 4:
        raise ValueError(f"head dim {D} unsupported: the kernel reads q and k "
                         "four values at a time (D % 4 == 0)")
    if bwd and (max(Lq, L1, L2) > BWD_MAX_LEN or D > BWD_MAX_HEAD_DIM):
        raise ValueError(f"(Lq, L1, L2, D)={(Lq, L1, L2, D)}: the backward "
                         f"takes lengths <= {BWD_MAX_LEN} and head dims <= "
                         f"{BWD_MAX_HEAD_DIM}")
    if B > MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the grid limit {MAX_GRID_Y}")
    return B, Lq, L1, L2, H, D


def _k1_forward_cuda(q1, q2, k1, k2, v1, v2, mask_q, mask_k1, mask_k2,
                     scale, rate, seed):
    tensors = (q1, q2, k1, k2, v1, v2)
    B, Lq, L1, L2, H, D = _check_k1(tensors, (mask_q, mask_k1, mask_k2),
                                    False)
    smem = _fn("two_block_attention", "segmm_two_block_attention_smem_bytes",
               ctypes.c_size_t, [ctypes.c_int] * 4)
    if smem(Lq, L1, L2, D) > MAX_SMEM_BYTES:
        raise ValueError(f"(Lq, L1, L2, D)={(Lq, L1, L2, D)} needs more "
                         "shared memory than one block has")
    fn = _fn("two_block_attention", "segmm_two_block_attention_fwd",
             ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 10
             + [ctypes.c_int] * 6 + [ctypes.c_float] + _DROP_ARGS
             + [ctypes.c_void_p])
    mq, mk1, mk2 = _masks_i32(mask_q, mask_k1, mask_k2)
    out = torch.empty_like(q1)
    with torch.cuda.device(q1.device):
        code = fn(_DTYPE_CODE[q1.dtype], *(t.data_ptr() for t in tensors),
                  mq.data_ptr(), mk1.data_ptr(), mk2.data_ptr(),
                  out.data_ptr(), B, Lq, L1, L2, H, D, float(scale),
                  *_drop_args(rate, seed), _stream_ptr(q1.device))
    _raise_on_cuda_error(code, "two_block_attention")
    LAUNCHES["two_block_attention"] += 1
    return out


def _k1_backward_cuda(q1, q2, k1, k2, v1, v2, mask_q, mask_k1, mask_k2, g,
                      scale, rate, seed):
    tensors = (q1, q2, k1, k2, v1, v2, g)
    B, Lq, L1, L2, H, D = _check_k1(tensors, (mask_q, mask_k1, mask_k2),
                                    True)
    smem = _fn("two_block_attention_bwd",
               "segmm_two_block_attention_bwd_smem_bytes", ctypes.c_size_t,
               [ctypes.c_int] * 4)
    if smem(Lq, L1, L2, D) > MAX_SMEM_BYTES:
        raise ValueError(f"(Lq, L1, L2, D)={(Lq, L1, L2, D)} needs more "
                         "shared memory than one block has")
    fn = _fn("two_block_attention_bwd", "segmm_two_block_attention_bwd",
             ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 16
             + [ctypes.c_int] * 6 + [ctypes.c_float] + _DROP_ARGS
             + [ctypes.c_void_p])
    mq, mk1, mk2 = _masks_i32(mask_q, mask_k1, mask_k2)
    grads = [torch.empty_like(t) for t in tensors[:6]]
    with torch.cuda.device(q1.device):
        code = fn(_DTYPE_CODE[q1.dtype], *(t.data_ptr() for t in tensors[:6]),
                  mq.data_ptr(), mk1.data_ptr(), mk2.data_ptr(), g.data_ptr(),
                  *(t.data_ptr() for t in grads), B, Lq, L1, L2, H, D,
                  float(scale), *_drop_args(rate, seed),
                  _stream_ptr(q1.device))
    _raise_on_cuda_error(code, "two_block_attention_bwd")
    LAUNCHES["two_block_attention_bwd"] += 1
    return tuple(grads)


def _check_k2(tensors, masks, num_heads, g=None):
    xq, x1, x2 = tensors[:3]
    ws = tensors[3:]
    _check_cuda(tensors + ((g,) if g is not None else ()), xq.dtype)
    B, Lq, d = xq.shape
    if d % num_heads:
        raise ValueError(f"d={d} is not a multiple of num_heads={num_heads}")
    dh = d // num_heads
    L1, L2 = x1.shape[1], x2.shape[1]
    if x1.shape != (B, L1, d) or x2.shape != (B, L2, d):
        raise ValueError(f"x1/x2 must be (B, L, {d}), got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)}")
    if g is not None and g.shape != xq.shape:
        raise ValueError(f"g must be {tuple(xq.shape)}, got {tuple(g.shape)}")
    for i in range(0, 12, 2):
        if ws[i].shape != (d, d) or ws[i + 1].shape != (d,):
            raise ValueError(f"projection {i // 2} must be ({d}, {d}) + "
                             f"({d},), got {tuple(ws[i].shape)} + "
                             f"{tuple(ws[i + 1].shape)}")
    for m, L, name in zip(masks, (Lq, L1, L2), ("mask_q", "mask_1",
                                                  "mask_2")):
        _check_mask(m, B, L, name)
    if dh not in K2_HEAD_DIMS or d % 32:
        raise ValueError(f"head dim {dh} (d={d}) unsupported: the kernel "
                         f"takes head dims {K2_HEAD_DIMS} and d % 32 == 0")
    if max(Lq, L1, L2) > K2_MAX_LEN:
        raise ValueError(f"stream lengths {(Lq, L1, L2)} exceed "
                         f"{K2_MAX_LEN}")
    if B > MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the grid limit {MAX_GRID_Y}")
    # the kernel reads x and W rows 16 bytes at a time
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("inputs must start on a 16-byte boundary")
    return B, Lq, L1, L2, d, dh


def _k2_smem_check(lib, symbol, xq, Lq, L1, L2, dh):
    smem = _fn(lib, symbol, ctypes.c_size_t, [ctypes.c_int] * 5)
    if smem(_DTYPE_CODE[xq.dtype], Lq, L1, L2, dh) > MAX_SMEM_BYTES:
        raise ValueError(f"(Lq, L1, L2)={(Lq, L1, L2)} needs more shared "
                         "memory than one block has")


def _k2_forward_cuda(xq, x1, x2, ws, masks, num_heads, scale, rate, seed):
    tensors = (xq, x1, x2) + tuple(ws)
    B, Lq, L1, L2, d, dh = _check_k2(tensors, masks, num_heads)
    _k2_smem_check("proj_two_block_attention",
                   "segmm_proj_two_block_attention_smem_bytes", xq, Lq, L1,
                   L2, dh)
    fn = _fn("proj_two_block_attention", "segmm_proj_two_block_attention_fwd",
             ctypes.c_int, [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
             + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + _DROP_ARGS + [ctypes.c_void_p])
    mq, m1, m2 = _masks_i32(*masks)
    out = torch.empty_like(xq)
    with torch.cuda.device(xq.device):
        code = fn(_DTYPE_CODE[xq.dtype], _ptrs(tensors), mq.data_ptr(),
                  m1.data_ptr(), m2.data_ptr(), out.data_ptr(), B, Lq, L1, L2,
                  d, num_heads, float(scale), *_drop_args(rate, seed),
                  _stream_ptr(xq.device))
    _raise_on_cuda_error(code, "proj_two_block_attention")
    LAUNCHES["proj_two_block_attention"] += 1
    return out


def _k2_qkv_grads_cuda(xq, x1, x2, ws, masks, g, num_heads, scale, rate,
                       seed):
    """K2's backward pass over (head, batch row): recompute the projections
    and the core backward, write fp32 dq1, dq2, dk1, dk2, dv1, dv2 as
    (B, L, d). Alone it is K7b (``_fp3_bwd_kernel``)."""
    tensors = (xq, x1, x2) + tuple(ws)
    B, Lq, L1, L2, d, dh = _check_k2(tensors, masks, num_heads, g)
    _k2_smem_check("proj_two_block_attention_bwd",
                   "segmm_proj_two_block_attention_bwd_smem_bytes", xq, Lq,
                   L1, L2, dh)
    fn = _fn("proj_two_block_attention_bwd",
             "segmm_proj_two_block_attention_qkv_bwd", ctypes.c_int,
             [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
             + [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_void_p)]
             + [ctypes.c_int] * 6 + [ctypes.c_float] + _DROP_ARGS
             + [ctypes.c_void_p])
    mq, m1, m2 = _masks_i32(*masks)
    dys = [torch.empty(B, L, d, dtype=torch.float32, device=xq.device)
           for L in (Lq, Lq, L1, L2, L1, L2)]
    with torch.cuda.device(xq.device):
        code = fn(_DTYPE_CODE[xq.dtype], _ptrs(tensors), mq.data_ptr(),
                  m1.data_ptr(), m2.data_ptr(), g.data_ptr(), _ptrs(dys), B,
                  Lq, L1, L2, d, num_heads, float(scale),
                  *_drop_args(rate, seed), _stream_ptr(xq.device))
    _raise_on_cuda_error(code, "proj_two_block_attention_qkv_bwd")
    return dys


def _k2_backward_cuda(xq, x1, x2, ws, masks, g, num_heads, scale, rate,
                      seed):
    """K2b: the per-(head, batch row) pass into an fp32 workspace, then the
    kernel's own tiled products for dx and for dW, db over the batch. With
    ``ATTN_V3_BWD`` the pass runs alone (K7b) and dx, dW, db are
    torch.matmul, as ``_fp3_call_bwd`` leaves them to XLA."""
    dys = _k2_qkv_grads_cuda(xq, x1, x2, ws, masks, g, num_heads, scale,
                             rate, seed)
    if ATTN_V3_BWD:
        LAUNCHES["proj_two_block_attention_qkv_bwd"] += 1
        return _chain_grads(xq, x1, x2, ws, dys)
    d = xq.shape[-1]
    dx = [torch.empty_like(x) for x in (xq, x1, x2)]
    dw = [torch.empty(d, d, dtype=torch.float32, device=xq.device)
          for _ in range(6)]
    db = [torch.empty(d, dtype=torch.float32, device=xq.device)
          for _ in range(6)]
    scratch = torch.empty(6 * K2_DW_SPLITS * (d * d + d),
                          dtype=torch.float32, device=xq.device)
    fn = _fn("proj_two_block_attention_bwd",
             "segmm_proj_two_block_attention_chain_bwd", ctypes.c_int,
             [ctypes.c_int] + [ctypes.POINTER(ctypes.c_void_p)] * 4
             + [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    B, Lq, L1, L2 = xq.shape[0], xq.shape[1], x1.shape[1], x2.shape[1]
    with torch.cuda.device(xq.device):
        code = fn(_DTYPE_CODE[xq.dtype], _ptrs((xq, x1, x2) + tuple(ws)),
                  _ptrs(dys), _ptrs(dx), _ptrs(dw + db), scratch.data_ptr(), B,
                  Lq, L1, L2, d, K2_DW_SPLITS, _stream_ptr(xq.device))
    _raise_on_cuda_error(code, "proj_two_block_attention_bwd (dx, dW)")
    LAUNCHES["proj_two_block_attention_bwd"] += 1
    grads = list(dx)
    for i in range(6):
        grads += [dw[i].to(ws[2 * i].dtype), db[i].to(ws[2 * i + 1].dtype)]
    return tuple(grads)


def _k6_params(ws, num_heads):
    """The kernel's ten parameters: the interleaved Wq_c, bq_c, Wk1_c,
    bk1_c, Wk2_c, bk2_c, then wv1, bv1, wv2, bv2."""
    return interleave_ws(*ws[:8], num_heads) + tuple(ws[8:])


def _k6_forward_cuda(xq, x1, x2, ws, masks, num_heads, scale, rate, seed):
    tensors = (xq, x1, x2) + tuple(ws)
    B, Lq, L1, L2, d, dh = _check_k2(tensors, masks, num_heads)
    _k2_smem_check("proj_two_block_attention_v2",
                   "segmm_proj_two_block_attention_v2_smem_bytes", xq, Lq, L1,
                   L2, dh)
    fn = _fn("proj_two_block_attention_v2",
             "segmm_proj_two_block_attention_v2_fwd", ctypes.c_int,
             [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
             + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + _DROP_ARGS + [ctypes.c_void_p])
    mq, m1, m2 = _masks_i32(*masks)
    ptrs = (xq, x1, x2) + _k6_params(ws, num_heads)
    out = torch.empty_like(xq)
    with torch.cuda.device(xq.device):
        code = fn(_DTYPE_CODE[xq.dtype], _ptrs(ptrs), mq.data_ptr(),
                  m1.data_ptr(), m2.data_ptr(), out.data_ptr(), B, Lq, L1, L2,
                  d, num_heads, float(scale), *_drop_args(rate, seed),
                  _stream_ptr(xq.device))
    _raise_on_cuda_error(code, "proj_two_block_attention_v2")
    LAUNCHES["proj_two_block_attention_v2"] += 1
    return out


def _k6_backward_cuda(xq, x1, x2, ws, masks, g, num_heads, scale, rate,
                      seed):
    """K6b: the qkv pass per (head, batch row) into fp32 dq_c (B, Lq, 2d)
    and the nonzero halves of dk and dv per block, then dx and dW, db
    through chain_gemm.cuh in K2_DW_SPLITS row chunks; dW and db of Wq_c
    come out (2d, d) and are de-interleaved here."""
    tensors = (xq, x1, x2) + tuple(ws)
    B, Lq, L1, L2, d, dh = _check_k2(tensors, masks, num_heads, g)
    _k2_smem_check("proj_two_block_attention_v2_bwd",
                   "segmm_proj_two_block_attention_v2_bwd_smem_bytes", xq, Lq,
                   L1, L2, dh)
    fn = _fn("proj_two_block_attention_v2_bwd",
             "segmm_proj_two_block_attention_v2_bwd", ctypes.c_int,
             [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
             + [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_void_p)] * 3
             + [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_float]
             + _DROP_ARGS + [ctypes.c_int, ctypes.c_void_p])
    mq, m1, m2 = _masks_i32(*masks)
    # the chain's dx of the keys takes wk1 and wk2 as they are
    ptrs = (xq, x1, x2) + _k6_params(ws, num_heads) + (ws[4], ws[6])
    f32 = dict(dtype=torch.float32, device=xq.device)
    dys = [torch.empty(B, Lq, 2 * d, **f32)] + [
        torch.empty(B, L, d, **f32) for L in (L1, L2, L1, L2)]
    dx = [torch.empty_like(x) for x in (xq, x1, x2)]
    dw = [torch.empty(2 * d, d, **f32)] + [torch.empty(d, d, **f32)
                                           for _ in range(4)]
    db = [torch.empty(2 * d, **f32)] + [torch.empty(d, **f32)
                                        for _ in range(4)]
    scratch = torch.empty(K2_DW_SPLITS * 6 * (d * d + d), **f32)
    with torch.cuda.device(xq.device):
        code = fn(_DTYPE_CODE[xq.dtype], _ptrs(ptrs), mq.data_ptr(),
                  m1.data_ptr(), m2.data_ptr(), g.data_ptr(), _ptrs(dys),
                  _ptrs(dx), _ptrs(dw + db), scratch.data_ptr(), B, Lq, L1,
                  L2, d, num_heads, float(scale), *_drop_args(rate, seed),
                  K2_DW_SPLITS, _stream_ptr(xq.device))
    _raise_on_cuda_error(code, "proj_two_block_attention_v2_bwd")
    LAUNCHES["proj_two_block_attention_v2_bwd"] += 1
    H = num_heads
    grads = (deinterleave_w(dw[0], H, 0), deinterleave_b(db[0], H, 0),
             deinterleave_w(dw[0], H, 1), deinterleave_b(db[0], H, 1),
             dw[1], db[1], dw[2], db[2], dw[3], db[3], dw[4], db[4])
    return tuple(dx) + tuple(t.to(w.dtype) for t, w in zip(grads, ws))


def _check_k3(q, k, v, mask_q, mask_k, g=None):
    _check_cuda((q, k, v) + ((g,) if g is not None else ()), q.dtype)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    for t, L, name in ((k, Lk, "k"), (v, Lk, "v")) + (
            ((g, Lq, "g"),) if g is not None else ()):
        if tuple(t.shape) != (B, L, H, D):
            raise ValueError(f"{name} must be {(B, L, H, D)}, got "
                             f"{tuple(t.shape)} (the kernel takes Dqk = Dv)")
    _check_mask(mask_q, B, Lq, "mask_q")
    _check_mask(mask_k, B, Lk, "mask_k")
    if D not in K3_HEAD_DIMS:
        raise ValueError(f"head dim {D} unsupported: the kernel takes "
                         f"{K3_HEAD_DIMS}")
    if max(Lq, Lk) > K3_MAX_LEN:
        raise ValueError(f"(Lq, Lk)={(Lq, Lk)}: the kernel takes lengths "
                         f"<= {K3_MAX_LEN}")
    if B > MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the grid limit {MAX_GRID_Y}")
    # the bf16 kernels stage head rows by 16-byte cp.async
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v) + ((g,) if g is not None
                                                   else ())):
        raise ValueError("bf16 inputs must start on a 16-byte boundary")
    return B, Lq, Lk, H, D


def _k3_forward_cuda(q, k, v, mask_q, mask_k, scale, rate, seed):
    B, Lq, Lk, H, D = _check_k3(q, k, v, mask_q, mask_k)
    fn = _fn("masked_attention", "segmm_masked_attention_fwd", ctypes.c_int,
             [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float] + _DROP_ARGS + [ctypes.c_void_p])
    mq, mk = _masks_i32(mask_q, mask_k)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), mq.data_ptr(), mk.data_ptr(), out.data_ptr(),
                  B, Lq, Lk, H, D, float(scale), *_drop_args(rate, seed),
                  _stream_ptr(q.device))
    _raise_on_cuda_error(code, "masked_attention")
    LAUNCHES["masked_attention"] += 1
    return out


def _k3_backward_cuda(q, k, v, mask_q, mask_k, g, scale, rate, seed):
    B, Lq, Lk, H, D = _check_k3(q, k, v, mask_q, mask_k, g)
    fn = _fn("masked_attention_bwd", "segmm_masked_attention_bwd",
             ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 9
             + [ctypes.c_int] * 5 + [ctypes.c_float] + _DROP_ARGS
             + [ctypes.c_void_p])
    mq, mk = _masks_i32(mask_q, mask_k)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        code = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), mq.data_ptr(), mk.data_ptr(), g.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Lq, Lk, H,
                  D, float(scale), *_drop_args(rate, seed),
                  _stream_ptr(q.device))
    _raise_on_cuda_error(code, "masked_attention_bwd")
    LAUNCHES["masked_attention_bwd"] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _device_kind(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


class _TwoBlockAttention(torch.autograd.Function):
    """K1 forward and K1b backward (``_fused_two_block`` custom VJP,
    attention.py:704-729): saves the inputs, masks and seed."""

    @staticmethod
    def forward(ctx, q1, q2, k1, k2, v1, v2, mask_q, mask_k1, mask_k2, scale,
                rate, seed):
        args = (q1, q2, k1, k2, v1, v2, mask_q, mask_k1, mask_k2)
        ctx.save_for_backward(*args)
        ctx.hyper = (scale, rate, seed)
        if _device_kind(q1) == "cpu":
            return two_block_attention_plain(*args, scale, rate, seed)
        return _k1_forward_cuda(*args, scale, rate, seed)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        g = g.contiguous()
        if g.device.type == "cpu":
            grads = two_block_attention_bwd_plain(*args, g, *ctx.hyper)
        else:
            grads = _k1_backward_cuda(*args, g, *ctx.hyper)
        return grads + (None,) * 6


class _ProjTwoBlockAttention(torch.autograd.Function):
    """K2 forward and K2b backward (``_fused_proj_attention`` custom VJP,
    attention.py:1007-1051), or with ``v2`` K6 forward and K6b backward
    (``_fused_proj_attention_v2``, :1491-1549), which take the same (d, d)
    parameters and interleave the Q and K ones on each call, as the JAX
    package does."""

    @staticmethod
    def forward(ctx, xq, x1, x2, wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1,
                bv1, wv2, bv2, mask_q, mask_1, mask_2, num_heads, scale,
                rate, seed, v2):
        ws = (wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2)
        masks = (mask_q, mask_1, mask_2)
        ctx.save_for_backward(xq, x1, x2, *ws, *masks)
        ctx.hyper = (num_heads, scale, rate, seed)
        ctx.v2 = v2
        if _device_kind(xq) == "cpu":
            plain = (proj_two_block_attention_v2_plain if v2
                     else proj_two_block_attention_plain)
            return plain(xq, x1, x2, *ws, *masks, num_heads, scale, rate,
                         seed)
        launch = _k6_forward_cuda if v2 else _k2_forward_cuda
        return launch(xq, x1, x2, ws, masks, num_heads, scale, rate, seed)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        xq, x1, x2, ws, masks = saved[0], saved[1], saved[2], saved[3:15], \
            saved[15:]
        g = g.contiguous()
        if g.device.type == "cpu":
            plain = (proj_two_block_attention_v2_bwd_plain if ctx.v2
                     else proj_two_block_attention_bwd_plain)
            grads = plain(xq, x1, x2, *ws, *masks, g, *ctx.hyper)
        else:
            launch = _k6_backward_cuda if ctx.v2 else _k2_backward_cuda
            grads = launch(xq, x1, x2, ws, masks, g, *ctx.hyper)
        return tuple(grads) + (None,) * 8


class _MaskedAttention(torch.autograd.Function):
    """K3 forward and K3b backward (``_fused_attention`` custom VJP,
    attention.py:297-321): saves q, k, v, the masks and the seed."""

    @staticmethod
    def forward(ctx, q, k, v, mask_q, mask_k, scale, rate, seed):
        ctx.save_for_backward(q, k, v, mask_q, mask_k)
        ctx.hyper = (scale, rate, seed)
        if _device_kind(q) == "cpu":
            return masked_attention_plain(q, k, v, mask_q, mask_k, scale,
                                          rate, seed)
        return _k3_forward_cuda(q, k, v, mask_q, mask_k, scale, rate, seed)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        g = g.contiguous()
        if g.device.type == "cpu":
            grads = masked_attention_bwd_plain(*args, g, *ctx.hyper)
        else:
            grads = _k3_backward_cuda(*args, g, *ctx.hyper)
        return tuple(grads) + (None,) * 5


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _rate(dropout_rate, deterministic):
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    return 0.0 if deterministic else float(dropout_rate)


def fused_two_block_attention(q1, q2, k1, k2, v1, v2, mask_q, mask_k1,
                              mask_k2, *, dropout_rate: float = 0.0,
                              seed: int = 0, deterministic: bool = True,
                              scale: Optional[float] = None):
    """Jointly normalised attention of one query set over two KV blocks with
    a different q per block (K1). q1/q2 (B, Lq, H, D), k1/v1 (B, L1, H, D),
    k2/v2 (B, L2, H, D), masks (B, L) bool or int -> (B, Lq, H, D).
    Differentiable (K1b); with ``deterministic=False`` the dropout mask of
    ``seed`` applies."""
    if scale is None:
        scale = 1.0 / math.sqrt(v1.shape[-1])
    return _TwoBlockAttention.apply(q1, q2, k1, k2, v1, v2, mask_q, mask_k1,
                                    mask_k2, float(scale),
                                    _rate(dropout_rate, deterministic),
                                    int(seed))


def fused_proj_two_block_attention(xq, x1, x2, wq1, bq1, wq2, bq2,
                                   wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2,
                                   mask_q, mask_1, mask_2, *,
                                   num_heads: int,
                                   dropout_rate: float = 0.0,
                                   seed: int = 0,
                                   deterministic: bool = True,
                                   scale: Optional[float] = None,
                                   version: Optional[int] = None):
    """Two-block jointly normalised attention with the six QKV projections
    inside the kernel (K2): q1 = xq.Wq1^T + bq1 attends k1 = x1.Wk1^T + bk1,
    q2 = xq.Wq2^T + bq2 attends k2 = x2.Wk2^T + bk2, one softmax over both,
    values from x1/x2. Weights in nn.Linear layout (d, d) = (out, in),
    biases (d,). xq (B, Lq, d), x1 (B, L1, d), x2 (B, L2, d) -> (B, Lq, d).
    Differentiable (K2b).

    ``version`` 1 runs K2, 2 the weight-interleaved K6; None means 2 under
    ``SEGMM_ATTN_V2=1`` and 1 otherwise. As in the JAX package
    (attention.py:1101-1131), version 2 needs L1 or L2 to be a multiple of
    8: an explicit request raises where neither is, the switch's default
    falls back to K2 there, and an unaligned L1 with an aligned L2 swaps the
    two blocks (their weights and masks with them), which changes the
    concatenation order, the dropout bits and the order of the sums."""
    d = xq.shape[-1]
    if d % num_heads:
        raise ValueError(f"d={d} is not a multiple of num_heads={num_heads}")
    if scale is None:
        scale = 1.0 / math.sqrt(d // num_heads)
    L1, L2 = x1.shape[1], x2.shape[1]
    explicit = version == 2
    if version is None:
        version = 2 if ATTN_V2 else 1
    if version not in (1, 2):
        raise ValueError(f"version must be None, 1 or 2, got {version}")
    if version == 2 and L1 % 8 and L2 % 8:
        if explicit:
            raise ValueError(
                f"version=2 requires L1 or L2 to be a multiple of 8; got "
                f"L1={L1}, L2={L2} - use version=1 or pad a block")
        version = 1
    args = (xq, x1, x2, wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1,
            wv2, bv2)
    if version == 2 and L1 % 8:
        args = swap_blocks(args)
        mask_1, mask_2 = mask_2, mask_1
    return _ProjTwoBlockAttention.apply(
        *args, mask_q, mask_1, mask_2, int(num_heads), float(scale),
        _rate(dropout_rate, deterministic), int(seed), version == 2)


_SWAP = (0, 2, 1, 5, 6, 3, 4, 9, 10, 7, 8, 13, 14, 11, 12)


def swap_blocks(ts):
    """xq, x1, x2 and the twelve parameters (or their gradients) with key
    blocks 1 and 2 exchanged, as version 2 runs an unaligned L1 with an
    aligned L2 (attention.py:1125-1131). Its own inverse."""
    return tuple(ts[i] for i in _SWAP)


def fused_masked_attention(q, k, v, mask_q, mask_k, *,
                           dropout_rate: float = 0.0, seed: int = 0,
                           deterministic: bool = True,
                           scale: Optional[float] = None):
    """Masked attention of one query set over one key block (K3): q
    (B, Lq, H, Dqk), k (B, Lk, H, Dqk), v (B, Lk, H, Dv), masks (B, L) bool
    or int -> (B, Lq, H, Dv). ``scale`` defaults to 1/sqrt(Dv), as
    attention.py:340-341. Differentiable (K3b); with ``deterministic=False``
    the dropout mask of ``seed`` applies."""
    if scale is None:
        scale = 1.0 / math.sqrt(v.shape[-1])
    return _MaskedAttention.apply(q, k, v, mask_q, mask_k, float(scale),
                                  _rate(dropout_rate, deterministic),
                                  int(seed))
