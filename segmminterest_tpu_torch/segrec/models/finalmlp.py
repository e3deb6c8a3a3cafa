"""FinalMLP (port of ``segmminterest_tpu/segrec/models/finalmlp.py``;
reference SegRec/models/context/FinalMLP.py:15-210): two MLP streams over
the (optionally feature-selected) flattened embeddings, fused by the
Task-1 model's InteractionAggregation."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ...models.interest import InteractionAggregation
from ..layers import ContextEmbedding, MLPBlock, lookup


class FeatureSelection(nn.Module):
    """FinalMLP.py:141-196: a sigmoid gate per stream over the flattened
    embedding, from the context features named (an Embedding for ``*_c``,
    a Dense with bias of the value otherwise), or from a learned bias where
    none is named. A gate from the bias is the same for every row: it is
    computed once and broadcast."""

    def __init__(self, feature_dim: int, embedding_dim: int,
                 fs_hidden_units: Sequence[int],
                 fs1_context: Sequence[str] = (),
                 fs2_context: Sequence[str] = (),
                 feature_max: Optional[Dict[str, int]] = None):
        super().__init__()
        self.context = {1: list(fs1_context), 2: list(fs2_context)}
        for tag, names in self.context.items():
            if not names:
                self.register_parameter(
                    f"fs{tag}_ctx_bias",
                    nn.Parameter(torch.zeros(1, embedding_dim)))
            for ctx in names:
                self.add_module(
                    f"fs{tag}_emb_{ctx}",
                    nn.Embedding(feature_max[ctx], embedding_dim)
                    if ctx.endswith("_c") else nn.Linear(1, embedding_dim))
            self.add_module(f"fs{tag}_gate", MLPBlock(
                embedding_dim * max(1, len(names)), fs_hidden_units,
                output_dim=feature_dim))

    def _ctx_input(self, tag: int, feed, item_num: int) -> torch.Tensor:
        names = self.context[tag]
        if not names:
            return getattr(self, f"fs{tag}_ctx_bias")[None]   # (1, 1, E)
        embs = []
        for ctx in names:
            v = lookup(getattr(self, f"fs{tag}_emb_{ctx}"), feed[ctx])
            if v.dim() == 2:
                v = v[:, None].expand(v.shape[0], item_num, v.shape[1])
            embs.append(v)
        return torch.cat(embs, -1)

    def forward(self, feed, flat_emb: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        item_num = flat_emb.shape[1]
        feats = []
        for tag in (1, 2):
            g = getattr(self, f"fs{tag}_gate")(
                self._ctx_input(tag, feed, item_num), generator)
            feats.append(flat_emb * torch.sigmoid(g) * 2)
        return feats


class FinalMLPModel(nn.Module):

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 mlp1_hidden_units: Sequence[int] = (64,),
                 mlp2_hidden_units: Sequence[int] = (64,),
                 use_fs: bool = True,
                 fs_hidden_units: Sequence[int] = (64,),
                 fs1_context: Sequence[str] = (),
                 fs2_context: Sequence[str] = (),
                 num_heads: int = 1, dropout: float = 0.0):
        super().__init__()
        width = len(feature_names) * emb_size
        self.embedding_dict = ContextEmbedding(feature_names, feature_max,
                                               emb_size)
        self.fs_module = (FeatureSelection(width, emb_size, fs_hidden_units,
                                           fs1_context, fs2_context,
                                           feature_max) if use_fs else None)
        self.mlp1 = MLPBlock(width, mlp1_hidden_units, dropout=dropout)
        self.mlp2 = MLPBlock(width, mlp2_hidden_units, dropout=dropout)
        self.fusion_module = InteractionAggregation(
            mlp1_hidden_units[-1], mlp2_hidden_units[-1], output_dim=1,
            num_heads=num_heads)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        item_num = feed["item_id"].shape[1]
        X = self.embedding_dict(feed, item_num)
        B, I = X.shape[:2]
        flat_emb = X.reshape(B, I, -1)
        feat1, feat2 = (self.fs_module(feed, flat_emb, generator)
                        if self.fs_module is not None
                        else (flat_emb, flat_emb))
        return self.fusion_module(self.mlp1(feat1, generator),
                                  self.mlp2(feat2, generator)), {}
