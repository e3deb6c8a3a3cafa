"""FM (port of ``segmminterest_tpu/segrec/models/fm.py``; reference
SegRec/models/context/FM.py:13-110)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..layers import ContextEmbedding, LinearContext


def fm_cross(vectors: torch.Tensor) -> torch.Tensor:
    """The pairwise term 0.5 * (sum^2 - sum of squares) per vector entry,
    (B, I, F, D) -> (B, I, D) (FM.py:66-70)."""
    return 0.5 * (vectors.sum(-2) ** 2 - (vectors ** 2).sum(-2))


class FMModel(nn.Module):
    """Factorization machine over the context features: linear term +
    the pairwise term."""

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        self.context_embedding = ContextEmbedding(feature_names, feature_max,
                                                  emb_size)
        self.linear_embedding = LinearContext(feature_names, feature_max)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        item_num = feed["item_id"].shape[1]
        vectors = self.context_embedding(feed, item_num)
        linear = self.linear_embedding(feed, item_num)
        return linear + fm_cross(vectors).sum(-1), {}
