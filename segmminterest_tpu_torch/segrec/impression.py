"""Impression-list losses (port of ``segmminterest_tpu/segrec/impression.py``:
the listwise training objectives of SegRec/models/BaseModel.py
ImpressionModel.loss :443-555).

Protocol: predictions (B, P+N) where the first ``max_pos`` slots are (padded)
positive items and the rest (padded) negatives; ``target`` in {1, 0, -1}
with -1 marking padding (ImpressionModel.Dataset pads to fixed lengths,
:586-600).

Quirks kept, as the JAX package keeps them:
 * ``test_have_neg`` reweighting multiplies per-row losses by
   has-negatives indicators normalized to the batch (:493,506,525);
 * BPR 'session' reweights between log and softmax, 'pair' after, 'simple'
   sums raw softplus pairs per row (a (B,) vector, not a scalar: a runner
   cannot train on it, in either package), default reweights within
   (:472-483);
 * listnet forces padded softmax probs to 1 so log() zeroes them (:490);
 * every loss averages over all the batch's rows: no ``row_mask`` (the
   impression feeds wrap-pad the final batch with real rows).

Masked slots take -inf through ``torch.where`` before a softmax, never a
product with a mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _neg_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, -torch.inf)


def _masks(target, max_pos):
    mask = (target != -1).to(torch.float32)   # 1 for real items, 0 for pad
    L = target.shape[1]
    pos_mask = (torch.arange(L, device=target.device)[None, :]
                < max_pos).to(torch.float32)
    neg_mask = 1.0 - pos_mask
    test_have_neg = mask[:, max_pos]          # :453 — slot max_pos's validity
    return mask, pos_mask, neg_mask, test_have_neg


def _reweight(per_row, have_neg):
    """Per-row losses times has-negatives, normalised to the batch."""
    return per_row * have_neg / torch.clamp(have_neg.sum(), min=1e-9) \
        * have_neg.shape[0]


def impression_bpr_loss(predictions, target, max_pos, variant: str = "session"):
    """BPR family (:455-483): variant in {session, pair, simple, hard, plain}."""
    mask, pos_mask, neg_mask, _ = _masks(target, max_pos)
    valid_pair = mask[:, :, None] * mask[:, None, :]
    select = pos_mask[:, :, None] * neg_mask[:, None, :] * valid_pair
    diff = predictions[:, :, None] - predictions[:, None, :]
    diff_masked = diff * select

    neg_pred = torch.where(neg_mask * mask == 1, predictions,
                           _neg_inf(predictions))
    neg_softmax = torch.softmax(neg_pred, dim=1)
    if variant == "hard":
        pos_pred = torch.where(pos_mask * mask == 1, predictions,
                               torch.full_like(predictions, torch.inf))
        pos_softmax = torch.softmax(pos_pred.min() - pos_pred, dim=1)
    else:
        pos_pred = torch.where(pos_mask * mask == 1, predictions,
                               _neg_inf(predictions))
        pos_softmax = torch.softmax(pos_pred, dim=1)

    if variant == "pair":
        per_row = ((F.softplus(-diff_masked)
                    * neg_softmax[:, None, :]).sum(-1) * pos_softmax).sum(-1)
        return per_row.mean()
    if variant in ("session", "hard"):
        s = ((torch.sigmoid(diff_masked) * neg_softmax[:, None, :]).sum(-1)
             * pos_softmax).sum(-1)
        return (-torch.log(torch.clamp(s, min=1e-12))).mean()
    if variant == "simple":
        return ((F.softplus(-diff_masked) * select).sum(-1)).sum(-1)
    # default: reweight within log-softmax (:480-482)
    per_row = F.softplus(
        -(diff_masked * neg_softmax[:, None, :]).sum(-1) * pos_softmax
    ).sum(-1)
    return per_row.mean()


def listnet_loss(predictions, target, max_pos):
    """:485-495."""
    mask, _, _, have_neg = _masks(target, max_pos)
    t = target.to(predictions.dtype)
    t = torch.where(target != -1, t, _neg_inf(t))
    t_softmax = torch.softmax(t, dim=1)
    p_softmax = torch.softmax(predictions, dim=1)
    p_softmax = torch.where(mask == 1, p_softmax, torch.ones_like(p_softmax))
    per_row = -(t_softmax * torch.log(torch.clamp(p_softmax, min=1e-12))
                ).sum(1)
    return _reweight(per_row, have_neg).mean()


def softmax_ce_loss(predictions, target, max_pos):
    """:497-508: uniform click probability over the positives."""
    mask, _, _, have_neg = _masks(target, max_pos)
    pos_length = (target == 1).to(predictions.dtype).sum(1)
    p = torch.where(mask == 1, predictions,
                    torch.full_like(predictions, -1e5))
    p_softmax = torch.softmax(p - p.max(1, keepdim=True).values, dim=1)
    target_pre = p_softmax[:, :max_pos]
    target_pre = torch.where(mask[:, :max_pos] == 1, target_pre,
                             torch.ones_like(target_pre))
    per_row = -(torch.log(torch.clamp(target_pre, min=1e-12))).sum(1) \
        / torch.clamp(pos_length, min=1e-9)
    return _reweight(per_row, have_neg).mean()


def attention_rank_loss(predictions, target, max_pos):
    """:510-527: softmax CE + punishment term on (1 - p)."""
    mask, _, _, have_neg = _masks(target, max_pos)
    t = target.to(predictions.dtype)
    t = torch.where(target != -1, t, _neg_inf(t))
    t_softmax = torch.softmax(t, dim=1)
    p = torch.where(mask == 1, predictions,
                    torch.full_like(predictions, -1e5))
    p_softmax = torch.softmax(p, dim=1)
    p1 = torch.where(mask == 1, p_softmax, torch.ones_like(p_softmax))
    loss_1 = -(t_softmax * torch.log(torch.clamp(p1, min=1e-12))).sum(1)
    p2 = torch.where(mask == 1, p_softmax, torch.zeros_like(p_softmax))
    p2 = torch.where(p2 != 1.0, p2, torch.zeros_like(p2))
    loss_2 = -((1 - t_softmax)
               * torch.log(torch.clamp(1 - p2, min=1e-12))).sum(1)
    return _reweight(loss_1 + loss_2, have_neg).mean()


def pointwise_ce_loss(predictions, target, max_pos):
    """:529-534."""
    mask, *_ = _masks(target, max_pos)
    p = torch.sigmoid(predictions)
    t = torch.clamp(target.to(predictions.dtype), 0.0, 1.0)
    ce = -(t * torch.log(torch.clamp(p, 1e-12, 1.0))
           + (1 - t) * torch.log(torch.clamp(1 - p, 1e-12, 1.0)))
    ce = ce * mask
    return (ce.sum(1) / torch.clamp(mask.sum(1), min=1e-9)).mean()


def sampled_softmax_loss(predictions, target, max_pos):
    """:536-545 (Wu et al. 2022)."""
    mask, *_ = _masks(target, max_pos)
    pos_mask_t = (target == 1).to(predictions.dtype)
    num = (torch.exp(predictions * pos_mask_t) * pos_mask_t).sum(-1)
    den = (torch.exp(predictions * mask) * mask).sum(-1)
    return (-torch.log(torch.clamp(num / torch.clamp(den, min=1e-12),
                                   min=1e-12))).mean()


def prob_ce_loss(predictions, target, max_pos):
    """:547-552 (predictions already probabilities)."""
    mask, *_ = _masks(target, max_pos)
    p = torch.clamp(predictions * mask, 1e-12, 1 - 1e-12)
    t = torch.clamp(target.to(predictions.dtype), 0.0, 1.0)
    ce = -(t * torch.log(p) + (1 - t) * torch.log(1 - p)) * mask
    return ce.sum(1).mean()


IMPRESSION_LOSSES = {
    "BPRsession": lambda p, t, m: impression_bpr_loss(p, t, m, "session"),
    "BPRpair": lambda p, t, m: impression_bpr_loss(p, t, m, "pair"),
    "BPRsimple": lambda p, t, m: impression_bpr_loss(p, t, m, "simple"),
    "BPR_hard": lambda p, t, m: impression_bpr_loss(p, t, m, "hard"),
    "BPR": lambda p, t, m: impression_bpr_loss(p, t, m, "plain"),
    "listnet": listnet_loss,
    "softmaxCE": softmax_ce_loss,
    "attention_rank": attention_rank_loss,
    "pointwiseCE": pointwise_ce_loss,
    "sampled_softmax": sampled_softmax_loss,
    "probCE": prob_ce_loss,
}
