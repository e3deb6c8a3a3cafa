"""Two-block jointly normalised attention: the K1 and K2 kernel wrappers and
their plain PyTorch versions (port of the forward halves of
``segmminterest_tpu/core/attention.py`` fused_two_block_attention and
fused_proj_two_block_attention v1).

Semantics (reference order of operations, encoder.py:44-161):

    l1 = q1 . k1^T,  l2 = q2 . k2^T        per head, fp32 accumulation
    fill -10000 where mask_q x mask_k is 0  (before the scale)
    x scale                                 (1/sqrt(head dim))
    one fp32 softmax over [l1 | l2]
    out = p1 . v1 + p2 . v2                 p cast to v's dtype first, both
                                            products in fp32, summed, cast

A fully padded query row is the uniform softmax of a constant, not zero.

Each wrapper launches its CUDA kernel (``core/csrc``) for CUDA tensors and
runs the plain version only for CPU tensors; there is no fall-back from one
to the other. Both are forward only: the backward kernels and the in-kernel
dropout mask come with the training slice, so training-mode dropout and
inputs that require grad raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .numerics import MASK_FILL_VALUE

# launches of each kernel, counted where the wrapper launches it (plain ints)
LAUNCHES = {"two_block_attention": 0, "proj_two_block_attention": 0}

# the most shared memory one block may use on an H100 (227 KB)
MAX_SMEM_BYTES = 232_448
MAX_GRID_Y = 65_535
K2_MAX_LEN = 128
K2_HEAD_DIMS = (16, 32, 64)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _pair_mask(mask_q, mask_k):
    """(B, 1, Lq, Lk) bool: mq x mk > 0 in int32, as the TPU kernel forms it
    (attention.py:798-799)."""
    mq = mask_q.to(torch.int32)
    mk = mask_k.to(torch.int32)
    return ((mq[:, :, None] * mk[:, None, :]) > 0)[:, None]


def _joint_probs(l1, l2, pair1, pair2, scale):
    """mask fill -> scale -> one fp32 softmax over both blocks
    (attention.py:374-396, deterministic)."""
    l1 = torch.where(pair1, l1, MASK_FILL_VALUE) * scale
    l2 = torch.where(pair2, l2, MASK_FILL_VALUE) * scale
    m = torch.maximum(l1.amax(-1, keepdim=True), l2.amax(-1, keepdim=True))
    e1 = torch.exp(l1 - m)
    e2 = torch.exp(l2 - m)
    den = e1.sum(-1, keepdim=True) + e2.sum(-1, keepdim=True)
    return e1 / den, e2 / den


def two_block_attention_plain(q1, q2, k1, k2, v1, v2, mask_q, mask_k1,
                              mask_k2, scale: float):
    """K1's plain version: q1/q2 (B, Lq, H, D), k1/v1 (B, L1, H, D),
    k2/v2 (B, L2, H, D) -> (B, Lq, H, D) in q1's dtype."""
    l1 = torch.einsum("bqhd,bkhd->bhqk", q1.float(), k1.float())
    l2 = torch.einsum("bqhd,bkhd->bhqk", q2.float(), k2.float())
    p1, p2 = _joint_probs(l1, l2, _pair_mask(mask_q, mask_k1),
                          _pair_mask(mask_q, mask_k2), scale)
    out = (torch.einsum("bhqk,bkhd->bqhd", p1.to(v1.dtype).float(),
                        v1.float())
           + torch.einsum("bhqk,bkhd->bqhd", p2.to(v2.dtype).float(),
                          v2.float()))
    return out.to(q1.dtype)


def _proj(x, w, b):
    """x . W^T + b with W in nn.Linear layout (out, in): the fp32 dot is cast
    to x's dtype and the bias added in that dtype (attention.py:769-773)."""
    return (torch.matmul(x.float(), w.float().t()).to(x.dtype)
            + b.to(x.dtype))


def proj_two_block_attention_plain(xq, x1, x2, wq1, bq1, wq2, bq2, wk1, bk1,
                                   wk2, bk2, wv1, bv1, wv2, bv2, mask_q,
                                   mask_1, mask_2, num_heads: int,
                                   scale: float):
    """K2's plain version: the six projections, then K1's plain version.
    xq (B, Lq, d), x1 (B, L1, d), x2 (B, L2, d) -> (B, Lq, d)."""
    B, Lq, d = xq.shape

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], num_heads, d // num_heads)

    out = two_block_attention_plain(
        heads(_proj(xq, wq1, bq1)), heads(_proj(xq, wq2, bq2)),
        heads(_proj(x1, wk1, bk1)), heads(_proj(x2, wk2, bk2)),
        heads(_proj(x1, wv1, bv1)), heads(_proj(x2, wv2, bv2)),
        mask_q, mask_1, mask_2, scale)
    return out.reshape(B, Lq, d)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_forward_only(tensors, dropout_rate, deterministic):
    if dropout_rate > 0 and not deterministic:
        raise NotImplementedError(
            "training-mode attention dropout is not ported yet (forward-only "
            "kernels); call with deterministic=True")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the attention kernels are forward only: run under "
            "torch.no_grad() / torch.inference_mode()")


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


def fused_two_block_attention(q1, q2, k1, k2, v1, v2, mask_q, mask_k1,
                              mask_k2, *, dropout_rate: float = 0.0,
                              deterministic: bool = True,
                              scale: Optional[float] = None):
    """Jointly normalised attention of one query set over two KV blocks with
    a different q per block (K1). q1/q2 (B, Lq, H, D), k1/v1 (B, L1, H, D),
    k2/v2 (B, L2, H, D), masks (B, L) bool or int -> (B, Lq, H, D)."""
    tensors = (q1, q2, k1, k2, v1, v2)
    _check_forward_only(tensors, dropout_rate, deterministic)
    if scale is None:
        scale = 1.0 / math.sqrt(v1.shape[-1])
    if q1.device.type == "cpu":
        return two_block_attention_plain(q1, q2, k1, k2, v1, v2, mask_q,
                                         mask_k1, mask_k2, scale)
    if q1.device.type != "cuda":
        raise ValueError(f"unsupported device {q1.device}")
    _check_cuda(tensors, q1.dtype)
    B, Lq, H, D = q1.shape
    L1, L2 = k1.shape[1], k2.shape[1]
    for t, L, name in ((q2, Lq, "q2"), (k1, L1, "k1"), (v1, L1, "v1"),
                       (k2, L2, "k2"), (v2, L2, "v2")):
        if tuple(t.shape) != (B, L, H, D):
            raise ValueError(f"{name} must be {(B, L, H, D)}, got "
                             f"{tuple(t.shape)}")
    _check_mask(mask_q, B, Lq, "mask_q")
    _check_mask(mask_k1, B, L1, "mask_k1")
    _check_mask(mask_k2, B, L2, "mask_k2")
    if D % 4:
        raise ValueError(f"head dim {D} unsupported: the kernel reads q and k "
                         "four values at a time (D % 4 == 0)")
    if B > MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the grid limit {MAX_GRID_Y}")
    from .build import load_library
    lib = load_library("two_block_attention")
    fn = lib.segmm_two_block_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    smem = lib.segmm_two_block_attention_smem_bytes
    smem.restype = ctypes.c_size_t
    smem.argtypes = [ctypes.c_int] * 4
    if smem(Lq, L1, L2, D) > MAX_SMEM_BYTES:
        raise ValueError(f"(Lq, L1, L2, D)={(Lq, L1, L2, D)} needs more "
                         "shared memory than one block has")
    mq, mk1, mk2 = _masks_i32(mask_q, mask_k1, mask_k2)
    out = torch.empty_like(q1)
    with torch.cuda.device(q1.device):
        code = fn(_DTYPE_CODE[q1.dtype], *(t.data_ptr() for t in tensors),
                  mq.data_ptr(), mk1.data_ptr(), mk2.data_ptr(),
                  out.data_ptr(), B, Lq, L1, L2, H, D, float(scale),
                  _stream_ptr(q1.device))
    _raise_on_cuda_error(code, "two_block_attention")
    LAUNCHES["two_block_attention"] += 1
    return out


def fused_proj_two_block_attention(xq, x1, x2, wq1, bq1, wq2, bq2,
                                   wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2,
                                   mask_q, mask_1, mask_2, *,
                                   num_heads: int,
                                   dropout_rate: float = 0.0,
                                   deterministic: bool = True,
                                   scale: Optional[float] = None):
    """Two-block jointly normalised attention with the six QKV projections
    inside the kernel (K2): q1 = xq.Wq1^T + bq1 attends k1 = x1.Wk1^T + bk1,
    q2 = xq.Wq2^T + bq2 attends k2 = x2.Wk2^T + bk2, one softmax over both,
    values from x1/x2. Weights in nn.Linear layout (d, d) = (out, in),
    biases (d,). xq (B, Lq, d), x1 (B, L1, d), x2 (B, L2, d) -> (B, Lq, d).
    """
    ws = (wq1, bq1, wq2, bq2, wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2)
    tensors = (xq, x1, x2) + ws
    _check_forward_only(tensors, dropout_rate, deterministic)
    B, Lq, d = xq.shape
    if d % num_heads:
        raise ValueError(f"d={d} is not a multiple of num_heads={num_heads}")
    dh = d // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    if xq.device.type == "cpu":
        return proj_two_block_attention_plain(
            xq, x1, x2, *ws, mask_q, mask_1, mask_2, num_heads, scale)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    _check_cuda(tensors, xq.dtype)
    L1, L2 = x1.shape[1], x2.shape[1]
    if x1.shape != (B, L1, d) or x2.shape != (B, L2, d):
        raise ValueError(f"x1/x2 must be (B, L, {d}), got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)}")
    for i in range(0, 12, 2):
        if ws[i].shape != (d, d) or ws[i + 1].shape != (d,):
            raise ValueError(f"projection {i // 2} must be ({d}, {d}) + "
                             f"({d},), got {tuple(ws[i].shape)} + "
                             f"{tuple(ws[i + 1].shape)}")
    _check_mask(mask_q, B, Lq, "mask_q")
    _check_mask(mask_1, B, L1, "mask_1")
    _check_mask(mask_2, B, L2, "mask_2")
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
    from .build import load_library
    lib = load_library("proj_two_block_attention")
    fn = lib.segmm_proj_two_block_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    smem = lib.segmm_proj_two_block_attention_smem_bytes
    smem.restype = ctypes.c_size_t
    smem.argtypes = [ctypes.c_int] * 5
    if smem(_DTYPE_CODE[xq.dtype], Lq, L1, L2, dh) > MAX_SMEM_BYTES:
        raise ValueError(f"(Lq, L1, L2)={(Lq, L1, L2)} needs more shared "
                         "memory than one block has")
    mq, m1, m2 = _masks_i32(mask_q, mask_1, mask_2)
    ptrs = (ctypes.c_void_p * 15)(*(t.data_ptr() for t in tensors))
    out = torch.empty_like(xq)
    with torch.cuda.device(xq.device):
        code = fn(_DTYPE_CODE[xq.dtype], ptrs, mq.data_ptr(), m1.data_ptr(),
                  m2.data_ptr(), out.data_ptr(), B, Lq, L1, L2, d, num_heads,
                  float(scale), _stream_ptr(xq.device))
    _raise_on_cuda_error(code, "proj_two_block_attention")
    LAUNCHES["proj_two_block_attention"] += 1
    return out
