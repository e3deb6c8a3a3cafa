"""WideDeep (port of ``segmminterest_tpu/segrec/models/widedeep.py``;
reference SegRec/models/context/WideDeep.py:15-84)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..layers import ContextEmbedding, LinearContext, MLPBlock


class WideDeepModel(nn.Module):
    """wide = FM linear term; deep = MLP over the flattened per-feature
    embeddings (WideDeep.py:40-46)."""

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 layers: Sequence[int] = (64,), dropout: float = 0.0):
        super().__init__()
        self.context_embedding = ContextEmbedding(feature_names, feature_max,
                                                  emb_size)
        self.linear_embedding = LinearContext(feature_names, feature_max)
        self.deep_layers = MLPBlock(len(feature_names) * emb_size, layers,
                                    output_dim=1, dropout=dropout)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        item_num = feed["item_id"].shape[1]
        deep_vectors = self.context_embedding(feed, item_num)
        wide_prediction = self.linear_embedding(feed, item_num)
        B, I = deep_vectors.shape[:2]
        deep_prediction = self.deep_layers(
            deep_vectors.reshape(B, I, -1), generator).squeeze(-1)
        return deep_prediction + wide_prediction, {}
