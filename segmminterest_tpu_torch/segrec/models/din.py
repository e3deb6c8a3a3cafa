"""DIN and ClipDINRec (port of ``segmminterest_tpu/segrec/models/din.py``).

Behavioral spec: reference SegRec/models/context_seq/DIN.py:22-182 and
ClipDINRec.py:11-261. Quirks kept verbatim:
 * the "attention" is a sigmoid-MLP score per history position, ZEROED (not
   -inf) at padded positions, divided by sqrt(H), and used WITHOUT softmax
   (softmax_stag=False) as weights over history (DIN.py:69-103);
 * the DNN head uses Dice activations with an affine pre-BatchNorm
   (batch_norm=True, norm_before_activation=True);
 * ClipDIN scores every (candidate, clip) pair: the segment's repr runs the
   same DIN attention against the history, then sum_clip score * interest *
   mask with optional softmax / sigmoid normalisation over clips
   (ClipDINRec.py:210-250).

ClipDINRec's attention input is (B*I*40, L, 4H) wide, as the JAX model's:
about 0.84 GB in fp32 at CTR's B=512, I=1, L=20, H=128, and 100 times that
for a ranking evaluation over 100 candidates at the same batch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import MLPBlock, add_feature_layers, lookup
from .cliprec import CLIP_NUM, gather_frames, positions


def din_attention(att_mlp: MLPBlock, queries: torch.Tensor,
                  keys: torch.Tensor, keys_length: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """(N, H) queries x (N, L, H) keys -> (N, H) weighted history sum
    (DIN.py:69-103): no softmax; padded positions scored 0."""
    N, L, H = keys.shape
    q = queries[:, None, :].expand(N, L, H)
    inp = torch.cat([q, keys, q - keys, q * keys], dim=-1)
    scores = att_mlp(inp, generator)[..., 0]  # (N, L)
    mask = torch.arange(L, device=keys.device)[None, :] >= \
        keys_length[:, None]
    scores = torch.where(mask, torch.zeros_like(scores), scores) / \
        math.sqrt(H)
    return torch.einsum("nl,nlh->nh", scores, keys)


class _EmbedDict(nn.Module):
    """Per-feature embedding dict shared by current and history features
    (DIN.py:47-51)."""

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int], vec_size: int):
        super().__init__()
        add_feature_layers(self, "emb_", feature_names, feature_max, vec_size)

    def lookup(self, f: str, x: torch.Tensor) -> torch.Tensor:
        return lookup(getattr(self, f"emb_{f}"), x)


class DINModel(nn.Module):
    """DIN (DIN.py:22-182): target attention over the user history per
    candidate, Dice DNN head. ``add_historical_situations`` appends the
    historical situation embeddings to each history step and the current
    situation to each candidate (DIN.py:132-141)."""

    def __init__(self, user_features: Sequence[str],
                 item_features: Sequence[str],
                 situation_features: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 att_layers: Sequence[int] = (64,),
                 dnn_layers: Sequence[int] = (64,),
                 add_historical_situations: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.user_features = list(user_features)
        self.item_features = list(item_features)
        self.situation_features = list(situation_features)
        self.add_hist_situ = bool(add_historical_situations
                                  and self.situation_features)
        d = emb_size
        self.embedding_dict = _EmbedDict(
            self.user_features + self.item_features
            + self.situation_features, feature_max, d)
        n_if, n_uf = len(self.item_features), len(self.user_features)
        n_sf = len(self.situation_features)
        H = (n_if + (n_sf if self.add_hist_situ else 0)) * d
        ctx = (n_if + n_uf + n_sf) * d
        self.att_mlp_layers = MLPBlock(4 * H, att_layers, output_dim=1,
                                       activation="sigmoid", dropout=dropout)
        self.dnn_mlp_layers = MLPBlock(2 * H + ctx, dnn_layers, output_dim=1,
                                       activation="dice", batch_norm=True,
                                       dropout=dropout)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        ed = self.embedding_dict
        B, I = feed["item_id"].shape
        item_feats_emb = torch.stack(
            [ed.lookup(f, feed[f]) for f in self.item_features], dim=-2)
        history_item_emb = torch.stack(
            [ed.lookup(f, feed["history_" + f]) for f in self.item_features],
            dim=-2)  # (B, L, n_if, d)
        user_feats_emb = torch.stack(
            [ed.lookup(f, feed[f]) for f in self.user_features], dim=-2)
        situ_emb = [ed.lookup(f, feed[f]) for f in self.situation_features]

        def over_items(t):  # (B, ...) -> (B, I, ...)
            return t[:, None].expand(B, I, *t.shape[1:])

        if self.add_hist_situ:
            hist_situ = torch.stack(
                [ed.lookup(f, feed["history_" + f])
                 for f in self.situation_features], dim=-2)
            history_item_emb = torch.cat([history_item_emb, hist_situ],
                                         dim=-2)
            cur_situ = torch.stack(situ_emb, dim=-2)
            current_emb = torch.cat([item_feats_emb, over_items(cur_situ)],
                                    dim=-2).reshape(B, I, -1)
        else:
            current_emb = item_feats_emb.reshape(B, I, -1)
        history_emb = history_item_emb.reshape(
            B, history_item_emb.shape[1], -1)
        ctx = [item_feats_emb, over_items(user_feats_emb)]
        if situ_emb:
            ctx.append(over_items(torch.stack(situ_emb, dim=-2)))
        all_context = torch.cat(ctx, dim=-2).reshape(B, I, -1)

        L, H = history_emb.shape[1], history_emb.shape[2]
        cur2d = current_emb.reshape(B * I, -1)
        his2d = over_items(history_emb).reshape(B * I, L, H)
        len2d = over_items(feed["lengths"]).reshape(-1)
        user_his = din_attention(self.att_mlp_layers, cur2d, his2d, len2d,
                                 generator)
        din_in = torch.cat(
            [user_his, user_his * cur2d, all_context.reshape(B * I, -1)], -1)
        out = self.dnn_mlp_layers(din_in, generator)
        return out[..., 0].reshape(B, I), {}


class ClipDINModel(nn.Module):
    """ClipDINRec (ClipDINRec.py:11-261): DIN attention per (candidate,
    clip) segment followed by interest-weighted clip integration;
    ``norm_interest_type`` none, softmax or sigmoid over the clips."""

    def __init__(self, feature_max: Dict[str, int], has_duration: bool = True,
                 emb_size: int = 64, att_layers: Sequence[int] = (64,),
                 dnn_layers: Sequence[int] = (64,), dropout: float = 0.0,
                 adjust_interest_weight: bool = False,
                 duration_mask: bool = False,
                 norm_interest_type: str = "none", use_frames: bool = False,
                 frame_feature_dim: int = 1024):
        super().__init__()
        if norm_interest_type not in ("none", "softmax", "sigmoid"):
            raise ValueError(f"unknown norm_interest_type "
                             f"{norm_interest_type!r}")
        d = self.emb_size = emb_size
        self.has_duration = has_duration
        self.duration_mask = duration_mask
        self.norm_interest_type = norm_interest_type
        self.use_frames = use_frames
        self.user_embedding = nn.Embedding(feature_max["user_id"], d)
        self.item_embedding = nn.Embedding(feature_max["item_id"], d)
        self.item_feature_embedding = nn.Linear(1, d)
        self.frame_position_embedding = nn.Linear(1, d)
        self.frame_id_projector = nn.Linear(2 * d, d)
        if use_frames:
            self.frame_embedding = nn.Linear(frame_feature_dim, d)
        H = 2 * d if has_duration else d
        self.att_mlp_layers = MLPBlock(4 * H, att_layers, output_dim=1,
                                       activation="sigmoid", dropout=dropout)
        self.dnn_mlp_layers = MLPBlock(2 * H + H + d, dnn_layers,
                                       output_dim=1, activation="dice",
                                       batch_norm=True, dropout=dropout)
        self.trainable_interest_weight = (
            nn.Parameter(torch.ones(CLIP_NUM)) if adjust_interest_weight
            else None)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        d = self.emb_size
        item_ids = feed["item_id"].long()
        B, I = item_ids.shape
        C = CLIP_NUM

        # ---- current (per-clip) embedding (ClipDINRec.py:123-151) ----
        item_embed = self.item_embedding(item_ids)
        item_embed_exp = item_embed[:, :, None, :].expand(B, I, C, d)
        frame_position_embed = self.frame_position_embedding(
            positions(B, I, C, self.frame_position_embedding.weight))
        id_embed = torch.cat([item_embed_exp, frame_position_embed], -1)
        if self.use_frames:
            frames = gather_frames(feat_table, feed["item_frame_lines"])
            frame_feats_embed = F.relu(self.frame_embedding(frames))
            frame_concat = torch.cat(
                [frame_feats_embed, self.frame_id_projector(id_embed)], -1)
        else:
            frame_concat = id_embed
        item_feats_emb = self.frame_id_projector(frame_concat)  # (B,I,C,d)

        history_item_emb = self.item_embedding(
            feed["history_item_id"].long())  # (B, L, d)
        if self.has_duration:
            item_feature_emb = self.item_feature_embedding(
                feed["i_duration"].to(
                    self.item_feature_embedding.weight.dtype)[..., None])
            item_feats_emb = torch.cat(
                [item_feats_emb,
                 item_feature_emb[:, :, None, :].expand(B, I, C, d)], -1)
            history_feature_emb = self.item_feature_embedding(
                feed["history_i_duration"].to(
                    self.item_feature_embedding.weight.dtype)[..., None])
            history_item_emb = torch.cat(
                [history_item_emb, history_feature_emb], -1)

        user_embed = self.user_embedding(feed["user_id"].long())
        all_context = torch.cat(
            [item_feats_emb,
             user_embed[:, None, None, :].expand(B, I, C, d)], -1)

        # ---- per-(item, clip) DIN attention (ClipDINRec.py:186-208) ----
        L, H = history_item_emb.shape[1], history_item_emb.shape[2]
        cur2d = item_feats_emb.reshape(B * I * C, -1)
        his2d = history_item_emb[:, None, None].expand(
            B, I, C, L, H).reshape(B * I * C, L, H)
        len2d = feed["lengths"][:, None, None].expand(B, I, C).reshape(-1)
        user_his = din_attention(self.att_mlp_layers, cur2d, his2d, len2d,
                                 generator)
        din_in = torch.cat(
            [user_his, user_his * cur2d,
             all_context.reshape(B * I * C, -1)], -1)
        clip_predictions = self.dnn_mlp_layers(din_in, generator)[..., 0] \
            .reshape(B, I, C)

        # ---- clip integration (ClipDINRec.py:210-250) ----
        dt = clip_predictions.dtype
        if self.trainable_interest_weight is not None:
            interest = self.trainable_interest_weight[None, None, :] \
                .expand(B, I, C)
        elif "c_interest_weight" in feed:
            interest = feed["c_interest_weight"].to(dt)
        else:
            interest = torch.ones((B, I, C), dtype=dt,
                                  device=clip_predictions.device)
        if self.duration_mask:
            dur = feed["i_duration"].int()
            mask = torch.arange(C, device=dur.device)[None, None, :] < \
                dur[..., None]
        else:
            mask = torch.ones((B, I, C), dtype=torch.bool,
                              device=clip_predictions.device)
        if self.norm_interest_type == "softmax":
            interest = torch.softmax(
                torch.where(mask, interest,
                            torch.full_like(interest, -math.inf)), dim=-1)
        elif self.norm_interest_type == "sigmoid":
            interest = torch.sigmoid(interest) * mask
        else:
            interest = interest * mask
        return (clip_predictions * interest).sum(-1), {}
