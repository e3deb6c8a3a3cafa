"""Survival-analysis loss zoo for segment-level interest modeling (port of
``segmminterest_tpu/models/losses.py``).

Behavioral spec: reference MMinterest/models/decoder_leave_focal.py
(my_sigmoid_focal_loss :35-59, huber_loss :61-66, compute_leave_prob_CE
:68-97, compute_interest_leave_CE :99-161, compute_interest_BPR_all :163-221,
compute_partial_likelihood_loss :273-286, compute_loss :490-572).

Every function is a pure map over fixed-shape tensors:
    logits   (B, L) per-segment interest logits (bias already added)
    gt       (B, L) leave labels in {1, 0, -1, -2}:
                    1 watched, 0 leave segment, -1 unwatched, -2 padding
    row_mask (B,)   True for real rows (False for batch padding)

As in the JAX package: empty-valid-row batches give 0 instead of NaN (the
denominators are at least 1), and log(sigmoid(x)) is ``logsigmoid``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from ..core.numerics import survival_from_logits


def _seg_iota(gt):
    return torch.arange(gt.shape[1], device=gt.device)[None, :]


def _count(mask):
    """max(sum(mask), 1) as a float, the row_mask denominator."""
    return mask.sum().clamp_min(1).float()


def label_components(gt: torch.Tensor, row_mask: torch.Tensor):
    """Shared label-derived quantities (decoder_leave_focal.py:493-527)."""
    mask = (gt != -2) & row_mask[:, None]
    gt_binary = ((gt == 1) & row_mask[:, None]).float()
    view_lengths = gt_binary.sum(dim=1)
    durations = mask.int().sum(dim=1)
    return mask, gt_binary, view_lengths, durations


def focal_loss(logits, gt, mask, row_mask, exposure_prob,
               alpha: float = 0.5, gamma: float = 2.0):
    """Exposure-corrected sigmoid focal loss, summed over valid positions and
    divided by the (real) batch size (decoder_leave_focal.py:35-59,534-538)."""
    targets = (gt > 0).float()
    p = torch.sigmoid(logits) * exposure_prob[None, :]
    ce = (logits.clamp_min(0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    loss = alpha_t * loss
    return torch.where(mask, loss, 0.0).sum() / _count(row_mask)


def huber_on_hazard(hazard_masked, view_lengths, row_mask,
                    delta: float = 1.0):
    """Huber(sum_t hazard, view_length) (decoder_leave_focal.py:61-66)."""
    err = hazard_masked.sum(dim=1) - view_lengths
    h = torch.where(err.abs() < delta, 0.5 * err ** 2,
                    delta * (err.abs() - 0.5 * delta))
    return torch.where(row_mask, h, 0.0).sum() / _count(row_mask)


def cox_partial_likelihood(hazard_masked, view_lengths, row_mask):
    """Cox partial likelihood over the leave position
    (decoder_leave_focal.py:273-286). Rows with view_length == L are skipped
    but still counted in the denominator, matching the reference."""
    L = hazard_masked.shape[1]
    vl = view_lengths.long()
    valid = (vl < L) & row_mask
    vl_safe = vl.clamp(0, L - 1)
    h_at = torch.gather(hazard_masked, 1, vl_safe[:, None])[:, 0]
    risk = torch.where(_seg_iota(hazard_masked) >= vl_safe[:, None],
                       hazard_masked, 0.0).sum(dim=1)
    ll = torch.log(h_at + 1e-6) - torch.log(risk + 1e-6)
    return -torch.where(valid, ll, 0.0).sum() / _count(row_mask)


def survive_ce(h_t, gt_binary, mask):
    """BCE-with-logits applied to exp(h_t) = S(t) as if it were a logit, a
    reference quirk kept verbatim (decoder_leave_focal.py:68-97)."""
    s = torch.exp(h_t)
    ce = s.clamp_min(0) - s * gt_binary + torch.log1p(torch.exp(-s.abs()))
    return torch.where(mask, ce, 0.0).sum() / _count(mask)


def interest_bpr_all(logits, view_lengths, row_mask):
    """The paper's main loss: softmax-weighted soft-BPR of the leave position
    against all other segments (decoder_leave_focal.py:163-221)."""
    L = logits.shape[1]
    vl = view_lengths.long()
    valid = (vl < L) & row_mask
    vl_safe = vl.clamp(0, L - 1)
    pos = torch.gather(logits, 1, vl_safe[:, None])
    is_pos = _seg_iota(logits) == vl_safe[:, None]
    neg_softmax = torch.softmax(logits.masked_fill(is_pos, float("-inf")),
                                dim=1)
    soft_diff = torch.sigmoid(logits - pos) * neg_softmax
    s = soft_diff.sum(dim=1).clamp(1e-8, 1.0 - 1e-8)
    per_row = -torch.log(s)
    return torch.where(valid, per_row, 0.0).sum() / _count(valid)


def interest_leave_ce(logits, gt, mask, row_mask, kind: str = "CE",
                      use_mask: bool = False):
    """Softmax-interest vs non-leave-distribution CE / KL
    (decoder_leave_focal.py:99-161). The softmaxes run over all 40 slots,
    padding included, exactly like the reference."""
    gt_nonleave = (gt != 0).float()
    log_interest = F.log_softmax(logits, dim=1)
    norm_gt = torch.softmax(gt_nonleave, dim=1)
    n_rows = _count(row_mask)
    maskf = mask.float()
    if kind == "CE":
        if use_mask:
            per_row = -(maskf * norm_gt * log_interest).sum(dim=1) \
                / maskf.sum(dim=1).clamp_min(1)
        else:
            per_row = -(norm_gt * log_interest).sum(dim=1)
        return torch.where(row_mask, per_row, 0.0).sum() / n_rows
    if kind == "KL":
        # torch F.kl_div(input=log_interest, target=norm_gt):
        # target * (log(target) - input), 0 where target == 0
        elem = torch.where(norm_gt > 0,
                           norm_gt * (torch.log(norm_gt.clamp_min(1e-38))
                                      - log_interest), 0.0)
        if use_mask:
            per_row = (elem * maskf).sum(dim=1) / maskf.sum(dim=1).clamp_min(1)
        else:  # reduction="batchmean": total sum / batch size
            per_row = elem.sum(dim=1)
        return torch.where(row_mask, per_row, 0.0).sum() / n_rows
    raise ValueError(f"unknown kind {kind}")


def mse_diagnostics(survival_masked, gt, view_lengths, durations, row_mask):
    """Always-computed diagnostics (decoder_leave_focal.py:552-558):
      mse : MSE(sum_t S_masked, view_length)
      mse2: the same after forcing S_masked[duration-1] = 1, against the
            view count including the leave slot ((gt >= 0).sum).
    The reference's (B,) input against a (B, 1) target broadcasts to (B, B)
    and averages every pair; kept, with padded rows out of both axes."""
    n = _count(row_mask)
    pred = survival_masked.sum(dim=1)

    def broadcast_mse(inp, tgt):
        diff = inp[None, :] - tgt[:, None]
        pair_mask = row_mask[None, :] & row_mask[:, None]
        return torch.where(pair_mask, diff * diff, 0.0).sum() / (n * n)

    mse1 = broadcast_mse(pred, view_lengths.to(pred.dtype))
    dur_idx = (durations - 1).clamp(0, gt.shape[1] - 1).long()
    at_dur = torch.gather(survival_masked, 1, dur_idx[:, None])[:, 0]
    pred2 = pred - at_dur + 1.0
    vl2 = ((gt >= 0) & row_mask[:, None]).sum(dim=1).to(pred.dtype)
    return mse1, broadcast_mse(pred2, vl2)


def compute_loss_dict(logits: torch.Tensor, gt: torch.Tensor,
                      row_mask: torch.Tensor, exposure_prob: torch.Tensor,
                      loss_types: Sequence[str],
                      loss_weights: Dict[str, float],
                      mask_loss: bool = False) -> Dict[str, torch.Tensor]:
    """The decoder's compute_loss (decoder_leave_focal.py:490-572) as a pure
    function: every requested loss, the mse/mse2 diagnostics, and the
    weighted total under "loss"."""
    row_mask = row_mask.bool()
    mask, gt_binary, view_lengths, durations = label_components(gt, row_mask)
    h_t, survival, hazard = survival_from_logits(logits)
    hazard_masked = torch.where(mask, hazard, 0.0)
    survival_masked = torch.where(mask, survival, 0.0)

    out: Dict[str, torch.Tensor] = {}
    # the reference's focal branch relabels gt IN PLACE (gt[gt>0]=1,
    # gt[gt==-1]=0, decoder_leave_focal.py:534-535): every loss listed after
    # 'focal', and the mse2 diagnostic computed last, sees the new labels
    gt_cur = gt
    for lt in loss_types:
        if lt == "focal":
            out["focal"] = focal_loss(logits, gt_cur, mask, row_mask,
                                      exposure_prob)
            gt_cur = torch.where(gt_cur == -1, torch.zeros_like(gt_cur),
                                 gt_cur)
        elif lt == "huber":
            out["huber"] = huber_on_hazard(hazard_masked, view_lengths,
                                           row_mask)
        elif lt == "hazard":
            out["hazard"] = cox_partial_likelihood(hazard_masked,
                                                   view_lengths, row_mask)
        elif lt == "surviveCE":
            out["surviveCE"] = survive_ce(h_t, gt_binary, mask)
        elif lt == "interestBPR":
            out["interestBPR"] = interest_bpr_all(logits, view_lengths,
                                                  row_mask)
        elif lt == "interestCE":
            out["interestCE"] = interest_leave_ce(logits, gt_cur, mask,
                                                  row_mask, "CE", mask_loss)
        elif lt == "interestKL":
            out["interestKL"] = interest_leave_ce(logits, gt_cur, mask,
                                                  row_mask, "KL", mask_loss)
        else:
            raise ValueError(f"unknown loss type: {lt}")

    out["mse"], out["mse2"] = mse_diagnostics(survival_masked, gt_cur,
                                              view_lengths, durations,
                                              row_mask)
    total = torch.zeros((), dtype=logits.dtype, device=logits.device)
    for lt in loss_types:
        # 'huber' is weighted by the 'mse' coefficient (reference :561-566)
        coef = loss_weights["mse"] if lt == "huber" else loss_weights[lt]
        total = total + out[lt] * coef
    out["loss"] = total
    return out
