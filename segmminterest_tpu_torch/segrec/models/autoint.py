"""AutoInt (port of ``segmminterest_tpu/segrec/models/autoint.py``;
reference SegRec/models/context/AutoInt.py:20-112): FM embeddings ->
stacked multi-head self-attention over the feature axis with linear
residuals -> deep MLP + the linear term."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ContextEmbedding, LinearContext, MLPBlock


class FeatureSelfAttention(nn.Module):
    """utils/layers.py's MultiHeadAttention (kq_same=False, bias=False)
    over the feature axis of (..., F, D); the scores shifted by their
    maximum over the whole tensor before the softmax, as the reference
    (:55-63)."""

    def __init__(self, d_model: int, attention_d: int, n_heads: int):
        super().__init__()
        self.attention_d, self.n_heads = attention_d, n_heads
        self.q_linear = nn.Linear(d_model, attention_d, bias=False)
        self.k_linear = nn.Linear(d_model, attention_d, bias=False)
        self.v_linear = nn.Linear(d_model, attention_d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d_k = self.attention_d // self.n_heads

        def split(t):  # (..., F, A) -> (..., H, F, d_k)
            return t.reshape(t.shape[:-1] + (self.n_heads, d_k)) \
                .transpose(-2, -3)
        q, k, v = (split(lin(x)) for lin in (self.q_linear, self.k_linear,
                                             self.v_linear))
        scores = q @ k.transpose(-2, -1) / math.sqrt(d_k)
        scores = torch.softmax(scores - scores.max(), dim=-1)
        return (scores @ v).transpose(-2, -3).reshape(
            x.shape[:-1] + (self.attention_d,))


class AutoIntLayers:
    """``num_layers`` of self-attention + Dense residual + relu, then the
    deep MLP over the flattened tokens: (..., F, D) -> (...); made on the
    model itself (the flax names are the model's own)."""

    def init_autoint(self, n_tokens: int, emb_size: int, attention_size: int,
                     num_heads: int, num_layers: int, layers: Sequence[int],
                     dropout: float):
        self.num_layers = num_layers
        d = emb_size
        for i in range(num_layers):
            self.add_module(f"autoint_attention_{i}", FeatureSelfAttention(
                d, attention_size, num_heads))
            self.add_module(f"residual_{i}", nn.Linear(d, attention_size))
            d = attention_size
        self.deep_layers = MLPBlock(n_tokens * d, layers, output_dim=1,
                                    dropout=dropout)

    def deep(self, x: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        for i in range(self.num_layers):
            x = F.relu(getattr(self, f"autoint_attention_{i}")(x)
                       + getattr(self, f"residual_{i}")(x))
        return self.deep_layers(x.reshape(x.shape[:-2] + (-1,)),
                                generator)[..., 0]


class AutoIntModel(nn.Module, AutoIntLayers):

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 attention_size: int = 32, num_heads: int = 1,
                 num_layers: int = 1, layers: Sequence[int] = (64,),
                 dropout: float = 0.0):
        super().__init__()
        self.init_autoint(len(feature_names), emb_size, attention_size,
                          num_heads, num_layers, layers, dropout)
        self.context_embedding = ContextEmbedding(feature_names, feature_max,
                                                  emb_size)
        self.linear_embedding = LinearContext(feature_names, feature_max)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        item_num = feed["item_id"].shape[1]
        emb = self.context_embedding(feed, item_num)
        linear = self.linear_embedding(feed, item_num)
        return linear + self.deep(emb, generator), {}
