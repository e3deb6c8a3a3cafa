"""Mask-aware numerical primitives (port of
``segmminterest_tpu/core/numerics.py``).

The survival chain and masking conventions of the reference implementation
(reference MMinterest/models/decoder_leave_focal.py:506-515 and
reference MMinterest/models/encoder.py:64-73), on torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# The reference fills masked attention logits with -10000.0 *before* the
# 1/sqrt(d_head) scaling (encoder.py:71 then :117,146).
MASK_FILL_VALUE = -10000.0


def log_survival_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """``h_t = cumsum(log(sigmoid(logits)))`` along the segment axis, with the
    numerically stable ``logsigmoid`` (PARITY N1)."""
    return torch.cumsum(F.logsigmoid(logits), dim=1)


def survival_from_logits(logits: torch.Tensor):
    """``(h_t, survival, hazard)`` for per-segment interest logits
    (decoder_leave_focal.py:506-515)."""
    h_t = log_survival_from_logits(logits)
    survival = torch.exp(h_t)
    return h_t, survival, 1.0 - survival


def quantize_table_int8(table) -> tuple:
    """Per-row symmetric int8 quantization of a (N, D) host table.

    Returns numpy ``(q, scale)``: ``q`` int8 (N, D), ``scale`` float32 (N, 1)
    with ``q * scale ~= table`` (max-abs rows map to +-127; all-zero rows get
    scale 0). The train path L1-normalizes every gathered row, so the scale
    cancels (PARITY D8)."""
    t = np.asarray(table, dtype=np.float32)
    amax = np.abs(t).max(axis=1, keepdims=True)
    safe = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(t / safe), -127, 127).astype(np.int8)
    scale = np.where(amax > 0, safe, 0.0).astype(np.float32)
    return q, scale


def quantize_rows_int8(rows: torch.Tensor):
    """Device-side twin of :func:`quantize_table_int8` for one chunk of rows
    (used to build a table on the card without a host copy)."""
    amax = rows.abs().amax(dim=1, keepdim=True)
    safe = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(rows / safe), -127, 127).to(torch.int8)
    return q, torch.where(amax > 0, safe, torch.zeros_like(amax))


def dequantize_rows(q_rows: torch.Tensor, scale_rows: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """int8 rows (+ per-row scale, shape (..., 1)) -> compute-dtype rows."""
    return q_rows.to(out_dtype) * scale_rows.to(out_dtype)


def l1_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / (||x||_1 + eps)`` along the last axis
    (main_for_seq_leave_earlystop_SegMM.py:272-273)."""
    return x / (x.abs().sum(dim=-1, keepdim=True) + eps)


def masked_attention_logits(q: torch.Tensor, k: torch.Tensor,
                            mask_q: torch.Tensor,
                            mask_k: torch.Tensor) -> torch.Tensor:
    """Raw (unscaled) attention logits with the reference's mask convention.

    q: (B, Lq, H, Dh), k: (B, Lk, H, Dh), boolean masks (B, Lq)/(B, Lk).
    Returns (B, H, Lq, Lk) with masked entries set to MASK_FILL_VALUE; the
    caller scales after the fill (encoder.py:44-73)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    pair = mask_q.bool()[:, None, :, None] & mask_k.bool()[:, None, None, :]
    return logits.masked_fill(~pair, MASK_FILL_VALUE)
