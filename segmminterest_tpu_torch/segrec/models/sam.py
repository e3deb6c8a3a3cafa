"""SAM (port of ``segmminterest_tpu/segrec/models/sam.py``).

Behavioral spec: reference SkipPredBaseline/ReChorus/src/models/context/
SAM.py (:25-75 and FuxiCTR's SAMBlock :118-220): the per-feature
embeddings go through one of five self-attentive interactions (SAM1,
SAM2A, SAM2E, SAM3A, SAM3E), then concat / weighted / mean / sum pooling
into a Dense(1) head. SAM2* forces concat and SAM1 weighted pooling
(:41-46).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..layers import ContextEmbedding, dropout

INTERACTIONS = ("SAM1", "SAM2A", "SAM2E", "SAM3A", "SAM3E")
AGGREGATIONS = ("concat", "weighted_pooling", "mean_pooling", "sum_pooling")


class SAMModel(nn.Module):

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 interaction_type: str = "SAM2E",
                 aggregation: str = "concat", num_layers: int = 1,
                 use_residual: bool = False, dropout: float = 0.0):
        super().__init__()
        if interaction_type not in INTERACTIONS:
            raise ValueError(f"interaction_type={interaction_type} not "
                             "supported")
        if interaction_type in ("SAM2A", "SAM2E"):
            aggregation = "concat"
        elif interaction_type == "SAM1":
            aggregation = "weighted_pooling"
        if aggregation not in AGGREGATIONS:
            raise ValueError(f"aggregation={aggregation} not supported")
        n, d = len(feature_names), emb_size
        self.itype, self.agg = interaction_type, aggregation
        self.num_layers, self.use_residual = num_layers, use_residual
        self.dropout = dropout
        self.context_embedding = ContextEmbedding(feature_names, feature_max,
                                                  d)
        if interaction_type == "SAM2A":
            self.W = nn.Parameter(torch.ones(n, n, d))
        if interaction_type in ("SAM3A", "SAM3E"):
            for layer in range(num_layers):
                self.add_module(f"K_{layer}", nn.Linear(d, d, bias=False))
                if interaction_type == "SAM3A":
                    self.register_parameter(
                        f"W_{layer}", nn.Parameter(torch.ones(n, n, d)))
                if use_residual:
                    self.add_module(f"Q_{layer}", nn.Linear(d, d, bias=False))
        if aggregation == "weighted_pooling":
            self.agg_weight = nn.Parameter(torch.ones(n, 1))
        width = n * n * d if interaction_type in ("SAM2A", "SAM2E") else \
            (n * d if aggregation == "concat" else d)
        self.output_layer = nn.Linear(width, 1)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        item_num = feed["item_id"].shape[1]
        emb = self.context_embedding(feed, item_num)   # (B, I, n, D)
        gen = generator if self.training else None
        n = emb.shape[-2]

        def pair_scores(x, k=None):
            return torch.einsum("...nd,...md->...nm", x,
                                k(x) if k is not None else x)

        out = emb
        if self.itype == "SAM2A":
            out = dropout(pair_scores(emb)[..., None] * self.W, self.dropout,
                          gen)
        elif self.itype == "SAM2E":
            U = torch.einsum("...nd,...md->...nmd", emb, emb)
            out = dropout(pair_scores(emb)[..., None] * U, self.dropout, gen)
        elif self.itype in ("SAM3A", "SAM3E"):
            for layer in range(self.num_layers):
                S = pair_scores(out, getattr(self, f"K_{layer}"))
                if self.itype == "SAM3A":
                    nxt = (S[..., None] * getattr(self, f"W_{layer}")).sum(-2)
                else:
                    U = torch.einsum("...nd,...md->...nmd", out, out)
                    nxt = (S[..., None] * U).sum(-2)
                if self.use_residual:
                    nxt = nxt + getattr(self, f"Q_{layer}")(out)
                out = dropout(nxt, self.dropout, gen)

        B, I = out.shape[:2]
        if self.agg == "weighted_pooling":
            pooled = (out.reshape(B, I, n, -1) * self.agg_weight).sum(-2)
        elif self.agg == "concat":
            pooled = out.reshape(B, I, -1)
        elif self.agg == "mean_pooling":
            pooled = out.reshape(B, I, n, -1).mean(-2)
        else:
            pooled = out.reshape(B, I, n, -1).sum(-2)
        return self.output_layer(pooled).squeeze(-1), {}
