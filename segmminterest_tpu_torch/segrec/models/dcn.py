"""DCN and DCNv2 (port of ``segmminterest_tpu/segrec/models/dcn.py``).

Behavioral spec: reference SegRec/models/context/DCN.py and
DCNv2.py:20-169: a cross network over the flattened per-feature
embeddings; v2 with a full-matrix cross (``mixed`` off: its weights' L2,
pre-weighted, is the sown ``reg_loss``, DCNv2.py:190-196) or a low-rank
mixture of experts with a softmax gate (``mixed``, :93-141), and the deep
MLP beside the cross (``parallel``) or after it (``stacked``).

:class:`CrossNetV2` puts the cross network and the head on its model, over
any leading axes, so ClipDCNv2Rec (``clip_variants.py``) runs the same code
with the segment axis in.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..layers import ContextEmbedding, MLPBlock, normal_param


class DCNModel(nn.Module):
    """DCN v1: x_{l+1} = x0 * (x_l . w_l) + b_l + x_l (DCN.py)."""

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 layers: Sequence[int] = (64,), cross_layer_num: int = 6,
                 dropout: float = 0.0):
        super().__init__()
        pre = len(feature_names) * emb_size
        self.cross_layer_num = cross_layer_num
        self.context_embedding = ContextEmbedding(feature_names, feature_max,
                                                  emb_size)
        for l in range(cross_layer_num):
            normal_param(self, f"cross_w_{l}", (pre,))
            self.register_parameter(f"cross_b_{l}",
                                    nn.Parameter(torch.zeros(pre)))
        self.deep_layers = MLPBlock(pre, layers, dropout=dropout)
        self.predict_layer = nn.Linear(pre + layers[-1], 1)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        item_num = feed["item_id"].shape[1]
        vectors = self.context_embedding(feed, item_num)
        B, I = vectors.shape[:2]
        x0 = xl = vectors.reshape(B, I, -1)
        for l in range(self.cross_layer_num):
            w = getattr(self, f"cross_w_{l}")
            xl = x0 * (xl @ w)[..., None] + getattr(self, f"cross_b_{l}") + xl
        deep = self.deep_layers(x0, generator)
        return self.predict_layer(torch.cat([xl, deep], -1)).squeeze(-1), {}


class CrossNetV2:
    """DCNv2's cross network, deep MLP and predict layer over (..., pre)
    inputs (DCNv2.py:43-169), made on the model itself (the flax names
    are the model's own)."""

    def init_cross(self, pre: int, layers: Sequence[int] = (64,),
                   cross_layer_num: int = 6, mixed: bool = True,
                   structure: str = "parallel", expert_num: int = 2,
                   low_rank: int = 64, reg_weight: float = 2.0,
                   dropout: float = 0.0):
        if structure not in ("parallel", "stacked"):
            raise ValueError(f"unknown structure {structure!r}")
        self.cross_layer_num, self.mixed = cross_layer_num, mixed
        self.structure, self.expert_num = structure, expert_num
        self.reg_weight = reg_weight
        if mixed:
            for e in range(expert_num):
                self.add_module(f"gating_{e}", nn.Linear(pre, 1))
        for l in range(cross_layer_num):
            if mixed:
                normal_param(self, f"cross_u_{l}", (expert_num, pre, low_rank))
                normal_param(self, f"cross_v_{l}", (expert_num, pre, low_rank))
                normal_param(self, f"cross_c_{l}",
                             (expert_num, low_rank, low_rank))
            else:
                normal_param(self, f"cross_w2_{l}", (pre, pre))
            self.register_parameter(f"cross_bias_{l}",
                                    nn.Parameter(torch.zeros(pre)))
        self.deep_layers = MLPBlock(pre, layers, dropout=dropout)
        self.predict_layer = nn.Linear(
            (pre if structure == "parallel" else 0) + layers[-1], 1)

    def cross(self, x0: torch.Tensor,
              generator: Optional[torch.Generator] = None):
        """(..., pre) -> ((...) scores, losses)."""
        xl, losses = x0, {}
        if self.mixed:
            # low-rank experts under a softmax gate
            for l in range(self.cross_layer_num):
                U, V, C = (getattr(self, f"cross_{k}_{l}") for k in "uvc")
                bias = getattr(self, f"cross_bias_{l}")
                experts, gates = [], []
                for e in range(self.expert_num):
                    gates.append(getattr(self, f"gating_{e}")(xl))
                    v = torch.tanh(xl @ V[e])
                    c = torch.tanh(v @ C[e])
                    experts.append(x0 * (c @ U[e].T + bias))
                gate = torch.softmax(torch.cat(gates, -1), dim=-1)
                xl = torch.einsum("...pe,...e->...p",
                                  torch.stack(experts, -1), gate) + xl
        else:
            reg = 0.0
            for l in range(self.cross_layer_num):
                W = getattr(self, f"cross_w2_{l}")
                xl = x0 * (xl @ W.T + getattr(self, f"cross_bias_{l}")) + xl
                reg = reg + torch.sqrt((W.float() ** 2).sum())
            losses["reg_loss"] = self.reg_weight * reg
        if self.structure == "parallel":
            deep = self.deep_layers(x0, generator)
            out = self.predict_layer(torch.cat([xl, deep], -1))
        else:
            out = self.predict_layer(self.deep_layers(xl, generator))
        return out[..., 0], losses


class DCNv2Model(nn.Module, CrossNetV2):
    """DCNv2 over the flattened per-feature embeddings."""

    def __init__(self, feature_names: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 layers: Sequence[int] = (64,), cross_layer_num: int = 6,
                 mixed: bool = True, structure: str = "parallel",
                 expert_num: int = 2, low_rank: int = 64,
                 reg_weight: float = 2.0, dropout: float = 0.0):
        super().__init__()
        self.init_cross(len(feature_names) * emb_size, layers,
                        cross_layer_num, mixed, structure, expert_num,
                        low_rank, reg_weight, dropout)
        self.context_embedding = ContextEmbedding(feature_names, feature_max,
                                                  emb_size)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        item_num = feed["item_id"].shape[1]
        vectors = self.context_embedding(feed, item_num)
        B, I = vectors.shape[:2]
        return self.cross(vectors.reshape(B, I, -1), generator)
