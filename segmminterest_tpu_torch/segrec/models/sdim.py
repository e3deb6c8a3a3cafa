"""SDIM and ETA (port of ``segmminterest_tpu/segrec/models/sdim.py``):
hash-based retrieval over the long user history.

SDIM (FuxiCTR's SDIM, Cao et al., CIKM 2022, as the JAX model follows it;
reference SegRec/models/context_seq/SDIM.py:21-160): short-term interest
= multi-head target attention over the ``recent_k`` most recent history
slots; long-term interest = LSH collision attention (the target and the
older history hashed by shared random rotations, colliding items
mean-pooled); DNN over [target ++ short ++ long ++ user].

ETA (the ReChorus fork's models/context_seq/ETA.py:30-278): the same short
term; long term = top ``retrieval_k`` of the older history by minus the
absolute bucket-id difference summed over hashes (:259, the reference's
similarity, not a Hamming distance), masked slots at -hash_bits, then
target attention over them; DNN over [short ++ long].

Codes are the sign of the projection (``proj > 0``) on
``random_rotations``, a parameter converted from the JAX model, never
drawn anew. ETA's similarities are integers, so ties are the rule: the
top-k keeps ``jax.lax.top_k``'s order, the lower index first among equal
values (a stable sort of -sim).

Recency as the reference indexes it: slot j counts as L-1-j from the end
(SDIM.py:91-96), whatever the row's length.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..layers import MLPBlock, MultiHeadTargetAttention, normal_param
from .din import _EmbedDict


def hash_codes(x: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """(..., H) -> (..., num_hashes) bucket ids: the bits of proj > 0."""
    proj = torch.einsum("...h,hnb->...nb", x, rotations.to(x.dtype))
    powers = 2 ** torch.arange(rotations.shape[-1], device=x.device)
    return ((proj > 0).long() * powers).sum(-1)


def topk_lower_index_first(sim: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest along the last axis, ties broken
    towards the lower index (``jax.lax.top_k``'s order)."""
    return torch.sort(-sim, dim=-1, stable=True).indices[..., :k]


class _RecencyMixin:
    """Short-term interest shared by SDIM and ETA."""

    recent_k: int

    def masks(self, L: int, lengths: torch.Tensor):
        indices = torch.arange(L - 1, -1, -1, device=lengths.device)[None, :]
        lens = lengths[:, None]
        return ((indices < lens) & (indices <= self.recent_k),
                (indices < lens) & (indices > self.recent_k))

    @staticmethod
    def over_items(t: torch.Tensor, I: int) -> torch.Tensor:
        return t[:, None].expand((t.shape[0], I) + t.shape[1:])

    def short_interest(self, att, target_emb, history_emb, mask_short,
                       generator):
        B, I, H = target_emb.shape
        L = history_emb.shape[1]
        return att(target_emb.reshape(B * I, H),
                   self.over_items(history_emb, I).reshape(B * I, L, H),
                   self.over_items(mask_short, I).reshape(B * I, L),
                   generator).reshape(B, I, H)


class SDIMModel(nn.Module, _RecencyMixin):

    def __init__(self, user_features: Sequence[str],
                 item_features: Sequence[str],
                 situation_features: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 dnn_layers: Sequence[int] = (64,), attention_dim: int = 64,
                 num_heads: int = 1, num_hashes: int = 1, hash_bits: int = 4,
                 recent_k: int = 5, dropout: float = 0.0):
        super().__init__()
        self.user_features = list(user_features)
        self.item_features = list(item_features)
        self.recent_k = recent_k
        H = emb_size * len(self.item_features)
        # the situation features are not read
        self.embedding_dict = _EmbedDict(
            self.user_features + self.item_features, feature_max, emb_size)
        self.short_attention = MultiHeadTargetAttention(
            H, attention_dim, num_heads, dropout)
        normal_param(self, "random_rotations", (H, num_hashes, hash_bits))
        self.dnn = MLPBlock(3 * H + emb_size * len(self.user_features),
                            dnn_layers, output_dim=1, dropout=dropout)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        ed = self.embedding_dict
        B, I = feed["item_id"].shape
        target_emb = torch.stack([ed.lookup(f, feed[f])
                                  for f in self.item_features],
                                 dim=-2).reshape(B, I, -1)
        history_emb = torch.stack([ed.lookup(f, feed["history_" + f])
                                   for f in self.item_features], dim=-2)
        history_emb = history_emb.reshape(B, history_emb.shape[1], -1)
        user_emb = torch.stack([ed.lookup(f, feed[f])
                                for f in self.user_features],
                               dim=-2).reshape(B, -1)
        L = history_emb.shape[1]
        mask_short, mask_long = self.masks(L, feed["lengths"])
        short = self.short_interest(self.short_attention, target_emb,
                                    history_emb, mask_short, generator)

        # long term: LSH collision attention (SDIM.py:107-124)
        tgt_codes = hash_codes(target_emb, self.random_rotations)  # (B,I,n)
        his_codes = hash_codes(history_emb, self.random_rotations)  # (B,L,n)
        collide = (tgt_codes[:, :, None, :] == his_codes[:, None, :, :]) \
            & mask_long[:, None, :, None]
        w = collide.to(target_emb.dtype).sum(-1)               # (B, I, L)
        denom = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        long = torch.einsum("bil,blh->bih", w / denom, history_emb)

        inp = torch.cat([target_emb, short, long,
                         self.over_items(user_emb, I)], -1)
        return self.dnn(inp, generator)[..., 0], {}


class ETAModel(nn.Module, _RecencyMixin):

    def __init__(self, user_features: Sequence[str],
                 item_features: Sequence[str],
                 situation_features: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 dnn_layers: Sequence[int] = (128, 64),
                 attention_dim: int = 64, num_heads: int = 1,
                 num_hashes: int = 1, hash_bits: int = 4, recent_k: int = 5,
                 retrieval_k: int = 5, history_max: int = 20,
                 dropout: float = 0.0):
        super().__init__()
        H = emb_size   # the item id's embedding alone
        self.recent_k, self.retrieval_k = recent_k, retrieval_k
        self.hash_bits = hash_bits
        self.long_branch = history_max > recent_k
        self.embedding_dict = _EmbedDict(["item_id"], feature_max, emb_size)
        self.short_attention_0 = MultiHeadTargetAttention(
            H, attention_dim, num_heads, dropout)
        if self.long_branch:
            # no long-interest branch where the history is no longer than
            # the recent window (ETA.py:139-141,206-208)
            normal_param(self, "random_rotations", (H, num_hashes, hash_bits))
            self.long_attention_0 = MultiHeadTargetAttention(
                H, attention_dim, num_heads, dropout)
        self.dnn = MLPBlock((2 if self.long_branch else 1) * H, dnn_layers,
                            output_dim=1, dropout=dropout)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        ed = self.embedding_dict
        B, I = feed["item_id"].shape
        target_emb = ed.lookup("item_id", feed["item_id"])            # (B,I,H)
        history_emb = ed.lookup("item_id", feed["history_item_id"])   # (B,L,H)
        L, H = history_emb.shape[1:]
        mask_short, mask_long = self.masks(L, feed["lengths"])
        short = self.short_interest(self.short_attention_0, target_emb,
                                    history_emb, mask_short, generator)
        if not self.long_branch:
            return self.dnn(short, generator)[..., 0], {}

        # LSH top-k retrieval (topk_retrieval :251-266)
        tgt_codes = hash_codes(target_emb, self.random_rotations)
        his_codes = hash_codes(history_emb, self.random_rotations)
        sim = -(tgt_codes[:, :, None, :]
                - his_codes[:, None, :, :]).abs().sum(-1)     # (B, I, L)
        ml = self.over_items(mask_long, I)
        sim = torch.where(ml, sim, torch.full_like(sim, -self.hash_bits))
        k = min(self.retrieval_k, L)
        idx = topk_lower_index_first(sim, k)                   # (B, I, k)
        topk_emb = torch.gather(
            self.over_items(history_emb, I), 2,
            idx[..., None].expand(B, I, k, H))                 # (B, I, k, H)
        topk_mask = torch.gather(ml, 2, idx)
        long = self.long_attention_0(
            target_emb.reshape(B * I, H), topk_emb.reshape(B * I, k, H),
            topk_mask.reshape(B * I, k), generator).reshape(B, I, H)
        return self.dnn(torch.cat([short, long], -1), generator)[..., 0], {}
