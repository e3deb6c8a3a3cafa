"""DeepFM, AFM and xDeepFM (port of
``segmminterest_tpu/segrec/models/deepfm.py``).

Behavioral spec: reference SkipPredBaseline/ReChorus/src/models/context/
DeepFM.py:18-28 (FM + MLP over the flattened embeddings), AFM.py:44-81
(attention-weighted pairwise interactions, RecBole's AttLayer) and
xDeepFM.py:49-140 (the compressed interaction network: each layer's outer
product collapsed by a 1x1 convolution, which is a Dense over the
field-pair axis; half the channels go on and half to the output unless
``direct``). AFM and xDeepFM carry ``reg_loss()``, the L2 term the runner
adds to the training loss (AFM.py:103-106, xDeepFM.py:77-94).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import (ContextEmbedding, LinearContext, MLPBlock, dropout,
                      normal_param)
from .fm import fm_cross


class DeepFMModel(nn.Module):
    """FM prediction + deep MLP prediction (DeepFM.py:19-28)."""

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
        vectors = self.context_embedding(feed, item_num)
        linear = self.linear_embedding(feed, item_num)
        B, I = vectors.shape[:2]
        deep = self.deep_layers(vectors.reshape(B, I, -1),
                                generator).squeeze(-1)
        return fm_cross(vectors).sum(-1) + linear + deep, {}


class AFMModel(nn.Module):
    """Attentional FM (AFM.py:44-81): AttLayer = Dense(att, no bias) ->
    relu -> dot with h -> softmax over the feature pairs."""

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 attention_size: int = 64, dropout: float = 0.0,
                 reg_weight: float = 2.0):
        super().__init__()
        n = len(feature_names)
        self.row = [i for i in range(n - 1) for _ in range(i + 1, n)]
        self.col = [j for i in range(n - 1) for j in range(i + 1, n)]
        self.dropout, self.reg_weight = dropout, reg_weight
        self.context_embedding = ContextEmbedding(feature_names, feature_max,
                                                  emb_size)
        self.linear_embedding = LinearContext(feature_names, feature_max)
        self.att_w = nn.Linear(emb_size, attention_size, bias=False)
        normal_param(self, "att_h", (attention_size,))
        normal_param(self, "p", (emb_size,))

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        item_num = feed["item_id"].shape[1]
        vectors = self.context_embedding(feed, item_num)
        linear = self.linear_embedding(feed, item_num)
        inter = vectors[..., self.row, :] * vectors[..., self.col, :]
        att = F.relu(self.att_w(inter))
        signal = torch.softmax((att * self.att_h).sum(-1), dim=-1)
        pooled = (signal[..., None] * inter).sum(-2)
        pooled = dropout(pooled, self.dropout,
                         generator if self.training else None)
        return linear + (pooled * self.p).sum(-1), {}

    def reg_loss(self) -> torch.Tensor:
        """reg_weight * ||attlayer.w||_2 (AFM.py:103-106)."""
        return self.reg_weight * torch.sqrt((self.att_w.weight ** 2).sum())


class XDeepFMModel(nn.Module):
    """xDeepFM: linear + CIN + deep MLP (xDeepFM.py:49-152), the candidate
    axis batched in."""

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 layers: Sequence[int] = (64,),
                 cin_layers: Sequence[int] = (8, 8), direct: bool = False,
                 reg_weight: float = 2.0, dropout: float = 0.0):
        super().__init__()
        n = len(feature_names)
        self.emb_size, self.direct, self.reg_weight = \
            emb_size, direct, reg_weight
        self.context_embedding = ContextEmbedding(feature_names, feature_max,
                                                  emb_size)
        self.linear_embedding = LinearContext(feature_names, feature_max)
        # layer sizes legalised as the reference does (xDeepFM.py:39-46)
        sizes = list(cin_layers)
        if not direct:
            sizes = [int(x // 2 * 2) for x in sizes[:-1]] + [sizes[-1]]
        self.cin_sizes = sizes
        h, final = n, 0
        for i, size in enumerate(sizes):
            self.add_module(f"cin_{i}", nn.Linear(h * n, size))
            if direct or i == len(sizes) - 1:
                final, h = final + size, size
            else:
                final, h = final + size // 2, size // 2
        self.cin_linear = nn.Linear(final, 1)
        self.deep_layers = MLPBlock(n * emb_size, layers, output_dim=1,
                                    dropout=dropout)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        item_num = feed["item_id"].shape[1]
        vectors = self.context_embedding(feed, item_num)
        linear = self.linear_embedding(feed, item_num)
        B, I = vectors.shape[:2]
        h0 = hidden = vectors                      # (B, I, F, D)
        outputs = []
        for i, size in enumerate(self.cin_sizes):
            z = torch.einsum("bihd,bimd->bihmd", hidden, h0).reshape(
                B, I, -1, self.emb_size)             # (B, I, h*m, D)
            # Conv1d(h*m -> size, kernel 1) == a Dense over the pair axis
            out = F.relu(getattr(self, f"cin_{i}")(
                z.transpose(-1, -2))).transpose(-1, -2)   # (B, I, size, D)
            if self.direct:
                outputs.append(out)
                hidden = out
            elif i != len(self.cin_sizes) - 1:
                hidden, to_out = out.split(size // 2, dim=-2)
                outputs.append(to_out)
            else:
                outputs.append(out)
        cin = torch.cat(outputs, dim=-2).sum(-1)  # (B, I, final)
        cin_pred = self.cin_linear(cin).squeeze(-1)
        deep = self.deep_layers(vectors.reshape(B, I, -1),
                                generator).squeeze(-1)
        return linear + cin_pred + deep, {}

    def reg_loss(self) -> torch.Tensor:
        """reg_weight * the sum of the L2 norms of the CIN, deep and
        linear kernels and embeddings (xDeepFM.py:77-94)."""
        total = 0.0
        for name, p in self.named_parameters():
            top, leaf = name.split(".", 1)[0], name.rsplit(".", 1)[-1]
            if (top.startswith("cin_") or top in ("deep_layers",
                                                   "linear_embedding")) \
                    and leaf == "weight":
                total = total + torch.sqrt((p ** 2).sum())
        return self.reg_weight * total
