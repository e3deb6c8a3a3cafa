"""Clip-integrated WideDeep, ClipWDRec (port of
``segmminterest_tpu/segrec/models/cliprec.py``).

Behavioral spec: reference SegRec/models/context/ClipRec.py:14-198
(ClipRecBase): every candidate video is scored PER SEGMENT — segment repr =
[frame CLIP feature embed ||] (item embed || frame-position embed) — and the
final prediction is sum_seg clip_score * interest_weight * duration_mask,
where interest_weight comes from Task-1 logits (``c_interest_weight``), a
trainable 40-vector (``adjust_interest_weight``), or ones.

Frame features arrive as int32 line ids (``item_frame_lines``, -1 where
there is none) and are gathered inside the forward from the feature table
on the device: negative lines are clipped to 0 and their rows zeroed.

Every model of the subpackage returns ``(scores (B, I), losses)``:
``losses`` holds what the flax model ``sow``s into its ``"losses"``
collection (here ClipWDRec's contrastive term, unweighted; the runner
weights it by ``auxillary_loss_weight``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import MLPBlock

CLIP_NUM = 40


def gather_frames(feat_table: torch.Tensor,
                  lines: torch.Tensor) -> torch.Tensor:
    """(..., C) line ids -> (..., C, feat_dim) rows, zero where the line is
    negative (ClipRec's take + mask, cliprec.py:96-99)."""
    frames = feat_table[lines.clamp(min=0).long()]
    return frames * (lines >= 0)[..., None].to(frames.dtype)


def positions(B: int, I: int, C: int, like: torch.Tensor) -> torch.Tensor:
    """The (B, I, C, 1) segment positions 0..C-1 in ``like``'s dtype and
    device (the layer's weight they feed: fp32 as trained)."""
    return torch.arange(C, dtype=like.dtype, device=like.device) \
        .view(1, 1, C, 1).expand(B, I, C, 1)


class ClipScoreMixin:
    """Shared weighting logic (ClipRec.py:159-181)."""

    duration_mask: bool

    def integrate_clips(self, clip_predictions, feed, trainable_weight=None):
        B, I, C = clip_predictions.shape
        dt = clip_predictions.dtype
        if trainable_weight is not None:
            interest = trainable_weight[None, None, :].expand(B, I, C)
        elif "c_interest_weight" in feed:
            interest = feed["c_interest_weight"].to(dt)
        else:
            interest = torch.ones((B, I, C), dtype=dt,
                                  device=clip_predictions.device)
        if self.duration_mask:
            dur = feed["i_duration"].int()  # (B, I)
            mask = (torch.arange(C, device=dur.device)[None, None, :]
                    < dur[..., None]).to(dt)
        else:
            mask = torch.ones((B, I, C), dtype=dt,
                              device=clip_predictions.device)
        return (clip_predictions * interest * mask).sum(-1)


class ClipWDModel(nn.Module, ClipScoreMixin):
    """ClipRecBase / ClipWDRec: wide+deep scoring of each segment
    (ClipRec.py:41-181). ``contrastive``: "ContrastiveLoss" (pair margin on
    per-clip embeddings, ClipRec.py:238-247) or "infoNCELoss" (item-level
    InfoNCE over [embed || value] rows, :249-271), with frames only."""

    def __init__(self, feature_max: Dict[str, int], emb_dim: int = 64,
                 dnn_layers: Sequence[int] = (64,), dropout: float = 0.0,
                 adjust_interest_weight: bool = False,
                 duration_mask: bool = False, frame_feature_dim: int = 1024,
                 use_frames: bool = False, contrastive: str = "",
                 infonce_tau: float = 0.1):
        super().__init__()
        if contrastive not in ("", "ContrastiveLoss", "infoNCELoss"):
            raise ValueError(f"unknown contrastive {contrastive!r}")
        d = self.emb_dim = emb_dim
        self.use_frames = use_frames
        self.duration_mask = duration_mask
        self.contrastive = contrastive
        self.infonce_tau = infonce_tau
        n_users, n_items = feature_max["user_id"], feature_max["item_id"]
        self.user_embedding = nn.Embedding(n_users, d)
        self.item_embedding = nn.Embedding(n_items, d)
        self.frame_position_embedding = nn.Linear(1, d)
        self.user_linear = nn.Embedding(n_users, 1)
        self.item_linear = nn.Embedding(n_items, 1)
        self.frame_position_linear = nn.Linear(1, 1)
        if use_frames:
            self.frame_embedding = nn.Linear(frame_feature_dim, d)
            self.frame_linear = nn.Linear(frame_feature_dim, 1)
            self.frame_id_projector = nn.Linear(2 * d, d)
            self.frame_id_projector_linear = nn.Linear(2, 1)
        self.dnn_mlp_layers = MLPBlock(3 * d, dnn_layers, output_dim=1,
                                       dropout=dropout)
        self.overall_bias = nn.Parameter(torch.full((1,), 0.01))
        self.trainable_interest_weight = (
            nn.Parameter(torch.ones(CLIP_NUM)) if adjust_interest_weight
            else None)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        user_ids = feed["user_id"].long()
        item_ids = feed["item_id"].long()
        B, I = item_ids.shape
        C, d = CLIP_NUM, self.emb_dim

        user_embed = self.user_embedding(user_ids)
        item_embed = self.item_embedding(item_ids)
        pos = positions(B, I, C, self.frame_position_embedding.weight)
        frame_position_embed = self.frame_position_embedding(pos)
        item_embed_exp = item_embed[:, :, None, :].expand(B, I, C, d)
        user_value = self.user_linear(user_ids)
        item_value = self.item_linear(item_ids)
        item_value_exp = item_value[:, :, None, :].expand(B, I, C, 1)
        frame_position_linear = self.frame_position_linear(pos)

        id_embed = torch.cat([item_embed_exp, frame_position_embed], -1)
        id_value = torch.cat([item_value_exp, frame_position_linear], -1)
        if self.use_frames:
            frames = gather_frames(feat_table, feed["item_frame_lines"])
            frame_feats_embed = F.relu(self.frame_embedding(frames))
            frame_feats_value = F.relu(self.frame_linear(frames))
            frame_id_embed = self.frame_id_projector(id_embed)
            frame_id_value = self.frame_id_projector_linear(id_value)
            frame_concat_embed = torch.cat(
                [frame_feats_embed, frame_id_embed], -1)
            frame_concat_value = torch.cat(
                [frame_feats_value, frame_id_value], -1)
        else:
            frame_concat_embed, frame_concat_value = id_embed, id_value

        user_exp = user_embed[:, None, None, :].expand(B, I, C, d)
        fm_vectors = torch.cat([user_exp, frame_concat_embed], -1)
        deep_prediction = self.dnn_mlp_layers(fm_vectors,
                                              generator).squeeze(-1)
        user_value_exp = user_value[:, None, None, :].expand(B, I, C, 1)
        linear_value = torch.cat([user_value_exp, frame_concat_value], -1)
        wide_prediction = self.overall_bias + linear_value.sum(-1)
        clip_predictions = deep_prediction + wide_prediction

        losses = {}
        if self.contrastive and self.use_frames:
            losses["contrastive_loss"] = self._contrastive(
                frame_feats_embed, frame_id_embed, frame_feats_value,
                frame_id_value)
        return (self.integrate_clips(clip_predictions, feed,
                                     self.trainable_interest_weight),
                losses)

    def _contrastive(self, feats_embed, id_embed, feats_value, id_value):
        B, I, C, d = feats_embed.shape
        if self.contrastive == "ContrastiveLoss":
            # all-positive pair-margin loss: labels are ones, so only the
            # 0.5 * mean(||e1 - e2||^2) term survives (ClipRec.py:238-247)
            diff = (feats_embed - id_embed).reshape(-1, d)
            return 0.5 * (diff ** 2).sum(-1).mean()
        e = torch.cat([feats_embed.reshape(B * I, C * d),
                       feats_value.reshape(B * I, C)], dim=1)
        g = torch.cat([id_embed.reshape(B * I, C * d),
                       id_value.reshape(B * I, C)], dim=1)
        e = e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True),
                            min=1e-12)
        g = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                            min=1e-12)
        logits = (e @ g.T) / self.infonce_tau
        eye = torch.eye(logits.shape[0], dtype=logits.dtype,
                        device=logits.device)
        exp = torch.exp(logits)
        pos = (exp * eye).sum(1)
        neg = (exp * (1 - eye)).sum(1)
        return (-torch.log(pos / (pos + neg))).mean()
