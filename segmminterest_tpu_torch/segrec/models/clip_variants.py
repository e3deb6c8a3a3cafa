"""The Clip-integrated backbones (port of
``segmminterest_tpu/segrec/models/clip_variants.py``).

Behavioral spec: reference SegRec/models/context/{ClipDCNv2Rec,
ClipAutoIntRec,ClipFinalMLPRec,ClipAdaGINRec}.py and
context_seq/{ClipCANRec,ClipDIENRec}.py. Each builds the per-segment
context [user embed ++ segment repr] of shape (B, I, 40, .), runs its
backbone with the segment axis as one more batch axis, and sums the
segment scores times the interest weights times the duration mask
(``ClipScoreMixin``, the ``_clip_integret_Rec_*`` methods).

ClipDIENRec and ClipCANRec take the DIEN target attention's softmax over
the flattened B*I*40 rows (padded rows at -inf), run the AUGRU whatever
``evolving_gru_type`` says, and leave ``norm_interest_type`` unread, as
the JAX models do. Their extractor GRU runs once per batch row and is
broadcast over the candidates and segments (the same values).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...models.interest import InteractionAggregation
from ..layers import MLPBlock, normal_param
from .adagin import AdaGINHead, AutoGraphLayer
from .autoint import AutoIntLayers
from .can import co_action, induce_size, orders_cat
from .cliprec import CLIP_NUM, ClipScoreMixin, gather_frames, positions
from .dcn import CrossNetV2
from .dien import MaskedGRU, batch_axis_attention
from .finalmlp import FeatureSelection


class ClipSegmentEmbedder(nn.Module):
    """The user embedding and each segment's repr: item embed ++ position
    embed, projected to ``emb_dim`` where asked or where frames are on, and
    with the frame's CLIP features embedded first (the shared
    ``_get_embeddings_Clip*`` helper)."""

    def __init__(self, feature_max: Dict[str, int], emb_dim: int,
                 use_frames: bool = False, project_frame_id: bool = False,
                 frame_feature_dim: int = 1024):
        super().__init__()
        d = self.emb_dim = emb_dim
        self.use_frames = use_frames
        self.user_embedding = nn.Embedding(feature_max["user_id"], d)
        self.item_embedding = nn.Embedding(feature_max["item_id"], d)
        self.frame_position_embedding = nn.Linear(1, d)
        self.project = project_frame_id or use_frames
        if self.project:
            self.frame_id_projector = nn.Linear(2 * d, d)
        if use_frames:
            self.frame_embedding = nn.Linear(frame_feature_dim, d)

    def width(self) -> int:
        """The segment repr's width."""
        return self.emb_dim * ((1 if self.project else 2)
                               + (1 if self.use_frames else 0))

    def forward(self, feed, feat_table=None):
        """-> (user embeds (B, I, C, d) broadcast, segment reprs)."""
        d = self.emb_dim
        item_ids = feed["item_id"].long()
        B, I = item_ids.shape
        C = CLIP_NUM
        user_embed = self.user_embedding(feed["user_id"].long())
        item_embed = self.item_embedding(item_ids)
        pos_embed = self.frame_position_embedding(
            positions(B, I, C, self.frame_position_embedding.weight))
        frame_id = torch.cat([item_embed[:, :, None, :].expand(B, I, C, d),
                              pos_embed], -1)
        if self.project:
            frame_id = self.frame_id_projector(frame_id)
        if self.use_frames:
            frames = gather_frames(feat_table, feed["item_frame_lines"])
            frame_id = torch.cat([F.relu(self.frame_embedding(frames)),
                                  frame_id], -1)
        return user_embed[:, None, None, :].expand(B, I, C, d), frame_id


class _ClipBase(nn.Module, ClipScoreMixin):
    """The arguments every Clip variant shares."""

    def __init__(self, feature_max: Dict[str, int], emb_size: int,
                 adjust_interest_weight: bool, duration_mask: bool,
                 use_frames: bool, project_frame_id: bool):
        super().__init__()
        self.emb_size = emb_size
        self.duration_mask = duration_mask
        self.seg_embedder = ClipSegmentEmbedder(feature_max, emb_size,
                                                use_frames, project_frame_id)
        self.trainable_interest_weight = (
            nn.Parameter(torch.ones(CLIP_NUM)) if adjust_interest_weight
            else None)

    def integrate(self, clip_predictions, feed):
        return self.integrate_clips(clip_predictions, feed,
                                    self.trainable_interest_weight)


class ClipDCNv2Model(_ClipBase, CrossNetV2):
    """ClipDCNv2Rec.py:246-277: DCNv2's cross network over each segment's
    context; the mixed low-rank experts by default, the full-matrix cross
    with its sown ``reg_loss`` otherwise (:298-303)."""

    def __init__(self, feature_max: Dict[str, int], emb_size: int = 64,
                 layers: Sequence[int] = (64,), cross_layer_num: int = 6,
                 mixed: bool = True, structure: str = "parallel",
                 expert_num: int = 2, low_rank: int = 64,
                 reg_weight: float = 2.0, dropout: float = 0.0,
                 adjust_interest_weight: bool = False,
                 duration_mask: bool = False, use_frames: bool = False):
        super().__init__(feature_max, emb_size, adjust_interest_weight,
                         duration_mask, use_frames, False)
        self.init_cross(emb_size + self.seg_embedder.width(), layers,
                        cross_layer_num, mixed, structure, expert_num,
                        low_rank, reg_weight, dropout)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        user_exp, frame_concat = self.seg_embedder(feed, feat_table)
        clip_predictions, losses = self.cross(
            torch.cat([user_exp, frame_concat], -1), generator)
        return self.integrate(clip_predictions, feed), losses


class ClipAutoIntModel(_ClipBase, AutoIntLayers):
    """ClipAutoIntRec.py: AutoInt's self-attention over each segment's
    feature tokens [user, (frame features,) item, position] plus the wide
    linear term of ClipWDRec's linear embeddings."""

    def __init__(self, feature_max: Dict[str, int], emb_size: int = 64,
                 attention_size: int = 32, num_heads: int = 1,
                 num_layers: int = 1, layers: Sequence[int] = (64,),
                 dropout: float = 0.0, adjust_interest_weight: bool = False,
                 duration_mask: bool = False, use_frames: bool = False):
        super().__init__(feature_max, emb_size, adjust_interest_weight,
                         duration_mask, use_frames, False)
        n_tokens = 1 + self.seg_embedder.width() // emb_size
        self.init_autoint(n_tokens, emb_size, attention_size, num_heads,
                          num_layers, layers, dropout)
        self.user_linear = nn.Embedding(feature_max["user_id"], 1)
        self.item_linear = nn.Embedding(feature_max["item_id"], 1)
        self.frame_position_linear = nn.Linear(1, 1)
        self.overall_bias = nn.Parameter(torch.full((1,), 0.01))

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        d = self.emb_size
        user_exp, frame_concat = self.seg_embedder(feed, feat_table)
        item_ids = feed["item_id"].long()
        B, I = item_ids.shape
        C = CLIP_NUM
        user_value = self.user_linear(feed["user_id"].long())
        item_value = self.item_linear(item_ids)
        pos_value = self.frame_position_linear(
            positions(B, I, C, self.frame_position_linear.weight))
        linear_value = torch.cat(
            [user_value[:, None, None, :].expand(B, I, C, 1),
             item_value[:, :, None, :].expand(B, I, C, 1), pos_value], -1)
        linear_value = self.overall_bias + linear_value.sum(-1)
        tokens = torch.cat([user_exp, frame_concat], -1).reshape(
            B, I, C, -1, d)
        clip_predictions = linear_value + self.deep(tokens, generator)
        return self.integrate(clip_predictions, feed), {}


class ClipFinalMLPModel(_ClipBase):
    """ClipFinalMLPRec.py: FinalMLP's two streams per segment, the gates
    from their learned biases, fused by InteractionAggregation."""

    def __init__(self, feature_max: Dict[str, int], emb_size: int = 64,
                 mlp1_hidden_units: Sequence[int] = (64,),
                 mlp2_hidden_units: Sequence[int] = (64,),
                 use_fs: bool = True,
                 fs_hidden_units: Sequence[int] = (64,),
                 num_heads: int = 1, dropout: float = 0.0,
                 adjust_interest_weight: bool = False,
                 duration_mask: bool = False, use_frames: bool = False):
        super().__init__(feature_max, emb_size, adjust_interest_weight,
                         duration_mask, use_frames, False)
        width = emb_size + self.seg_embedder.width()
        self.fs_module = (FeatureSelection(width, emb_size, fs_hidden_units,
                                           feature_max=feature_max)
                          if use_fs else None)
        self.mlp1 = MLPBlock(width, mlp1_hidden_units, dropout=dropout)
        self.mlp2 = MLPBlock(width, mlp2_hidden_units, dropout=dropout)
        self.fusion_module = InteractionAggregation(
            mlp1_hidden_units[-1], mlp2_hidden_units[-1], output_dim=1,
            num_heads=num_heads)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        user_exp, frame_concat = self.seg_embedder(feed, feat_table)
        flat_emb = torch.cat([user_exp, frame_concat], -1)
        feat1, feat2 = (self.fs_module(feed, flat_emb, generator)
                        if self.fs_module is not None
                        else (flat_emb, flat_emb))
        clip_predictions = self.fusion_module(self.mlp1(feat1, generator),
                                              self.mlp2(feat2, generator))
        return self.integrate(clip_predictions, feed), {}


class ClipAdaGINModel(_ClipBase, AdaGINHead):
    """ClipAdaGINRec.py: AdaGIN's graph interaction over each segment's
    tokens [user, (frame features,) projected item ++ position]."""

    def __init__(self, feature_max: Dict[str, int], emb_size: int = 64,
                 warm_dim: int = 64, cold_dim: int = 64,
                 warm_tau: float = 1.0, cold_tau: float = 0.01,
                 fi_hidden_units: Sequence[int] = (64, 64),
                 w_hidden_units: Sequence[int] = (64, 64),
                 num_gnn_layers: int = 3, only_use_last_layer: bool = True,
                 dropout: float = 0.0, adjust_interest_weight: bool = False,
                 duration_mask: bool = False, use_frames: bool = False):
        super().__init__(feature_max, emb_size, adjust_interest_weight,
                         duration_mask, use_frames, True)
        n = 1 + self.seg_embedder.width() // emb_size
        self.init_head(n, emb_size, fi_hidden_units, w_hidden_units,
                       num_gnn_layers, only_use_last_layer, dropout)
        self.AutoGraph = AutoGraphLayer(n, emb_size, warm_dim, warm_tau,
                                        cold_tau, only_use_last_layer,
                                        num_gnn_layers)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                gumbel_noise: Optional[List[torch.Tensor]] = None):
        d = self.emb_size
        user_exp, frame_concat = self.seg_embedder(feed, feat_table)
        tokens = torch.cat([user_exp, frame_concat], -1)
        B, I, C = tokens.shape[:3]
        tokens = tokens.reshape(B * I * C, -1, d)
        h_list = self.AutoGraph(tokens, generator, gumbel_noise)
        clip_predictions = self.score(h_list, generator).reshape(B, I, C)
        return self.integrate(clip_predictions, feed), {}


class ClipDIENModel(_ClipBase):
    """ClipDIENRec.py: DIEN's interest evolution per (candidate, segment),
    then the segment integration (ClipDINRec's shape on DIEN's trunk)."""

    def __init__(self, feature_max: Dict[str, int], emb_size: int = 64,
                 evolving_gru_type: str = "AGRU",
                 fcn_hidden_layers: Sequence[int] = (64,),
                 dropout: float = 0.0, adjust_interest_weight: bool = False,
                 duration_mask: bool = False, norm_interest_type: str = "none",
                 use_frames: bool = False, fcn_extra: int = 0):
        super().__init__(feature_max, emb_size, adjust_interest_weight,
                         duration_mask, use_frames, True)
        d = emb_size
        if self.seg_embedder.width() != d:
            self.frame_reduce = nn.Linear(self.seg_embedder.width(), d)
        self.hist_item_embedding = nn.Embedding(feature_max["item_id"], d)
        self.gru = MaskedGRU(d)
        normal_param(self, "attentionW", (d, d))
        self.evolving_gru = MaskedGRU(d, "augru")
        self.fcn_net = MLPBlock(fcn_extra + 5 * d, fcn_hidden_layers,
                                output_dim=1, dropout=dropout)

    def segments(self, feed, feat_table, generator, extra=None):
        """The (B, I, C) segment scores; ``extra`` (B, I, k) goes first in
        the FCN's input (ClipCANRec's co-action features)."""
        d = self.emb_size
        user_exp, frame_concat = self.seg_embedder(feed, feat_table)
        cur = (self.frame_reduce(frame_concat) if hasattr(self,
                                                          "frame_reduce")
               else frame_concat)
        B, I, C, _ = cur.shape
        N = B * I * C
        history_emb = self.hist_item_embedding(
            feed["history_item_id"].long())                  # (B, L, d)
        L = history_emb.shape[1]
        lengths = feed["lengths"]
        interest_row, _ = self.gru(history_emb, lengths)
        interest = interest_row[:, None, None].expand(B, I, C, L, d) \
            .reshape(N, L, d)
        lens = lengths[:, None, None].expand(B, I, C).reshape(-1)
        rm = feed["row_mask"][:, None, None].expand(B, I, C).reshape(-1)
        cur = cur.reshape(N, d)
        attention = batch_axis_attention(interest, self.attentionW, cur, rm)
        h_out = self.evolving_gru(interest, lens, attn=attention)[1]
        history_sum = history_emb.sum(1)[:, None, None].expand(
            B, I, C, d).reshape(N, d)
        parts = [] if extra is None else [
            extra[:, :, None, :].expand(B, I, C, extra.shape[-1])
            .reshape(N, -1)]
        parts += [user_exp.reshape(N, d), cur, history_sum,
                  cur * history_sum, h_out]
        return self.fcn_net(torch.cat(parts, -1), generator)[..., 0] \
            .reshape(B, I, C)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        return self.integrate(self.segments(feed, feat_table, generator),
                              feed), {}


class ClipCANModel(ClipDIENModel):
    """ClipCANRec.py: ClipDIENRec's trunk with the user-item co-action
    features first in each segment's FCN input."""

    def __init__(self, feature_max: Dict[str, int], emb_size: int = 64,
                 evolving_gru_type: str = "AGRU",
                 fcn_hidden_layers: Sequence[int] = (64,),
                 dropout: float = 0.0, adjust_interest_weight: bool = False,
                 duration_mask: bool = False, norm_interest_type: str = "none",
                 use_frames: bool = False, induce_vec_size: int = 512,
                 orders: int = 1, co_action_layers: Sequence[int] = (4, 4)):
        super().__init__(feature_max, emb_size, evolving_gru_type,
                         fcn_hidden_layers, dropout, adjust_interest_weight,
                         duration_mask, norm_interest_type, use_frames,
                         fcn_extra=sum(co_action_layers))
        self.orders = orders
        self.co_action_layers = tuple(co_action_layers)
        self.item_embedding_induce = nn.Embedding(
            feature_max["item_id"],
            induce_size(emb_size, orders, co_action_layers, induce_vec_size))
        self.can_user_emb = nn.Embedding(feature_max["user_id"], emb_size)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        induction = self.item_embedding_induce(feed["item_id"].long())
        user_emb = self.can_user_emb(feed["user_id"].long())[:, None]
        ui = co_action(induction, orders_cat(user_emb, self.orders),
                       self.co_action_layers)               # (B, I, sum)
        return self.integrate(self.segments(feed, feat_table, generator,
                                            extra=ui), feed), {}
