"""CAN (port of ``segmminterest_tpu/segrec/models/can.py``; reference
SegRec/models/context_seq/CAN.py:18-230): DIEN plus co-action micro-MLPs
whose weights are induced from a large per-item embedding (the candidate
parameterises a tiny MLP applied to the user and history embeddings)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from .dien import DIENModel


def induce_size(emb_size: int, orders: int, co_action_layers: Sequence[int],
                induce_vec_size: int) -> int:
    """The induction vector's width: at least what the micro-MLPs' weights
    and biases take (CAN.py:34-44)."""
    pre, need = emb_size * orders, 0
    for layer in co_action_layers:
        need += pre * layer + layer
        pre = layer
    return max(induce_vec_size, need)


def orders_cat(x: torch.Tensor, orders: int) -> torch.Tensor:
    return torch.cat([x ** (i + 1) for i in range(orders)], -1)


def _micro_layers(induction, pre, co_action_layers):
    """Each micro-MLP layer's (weight (B, I, pre, out), bias (B, I, out))
    sliced from the (B, I, V) induction vectors."""
    B, I, _ = induction.shape
    start = 0
    for layer in co_action_layers:
        w = induction[:, :, start:start + pre * layer].reshape(
            B, I, pre, layer)
        start += pre * layer
        b = induction[:, :, start:start + layer]
        start += layer
        yield w, b
        pre = layer


def co_action(induction: torch.Tensor, feed_orders: torch.Tensor,
              co_action_layers: Sequence[int]) -> torch.Tensor:
    """The micro-MLP parameterised by the induction vector (CAN.py:100-124):
    (B, I, V) induction, (B, 1, P) inputs -> (B, I, sum(layers))."""
    B, I, _ = induction.shape
    hidden = feed_orders.expand(B, I, feed_orders.shape[-1])[:, :, None, :]
    outputs = []
    for w, b in _micro_layers(induction, feed_orders.shape[-1],
                              co_action_layers):
        hidden = torch.tanh(hidden @ w + b[:, :, None, :])
        outputs.append(hidden[:, :, 0, :])
    return torch.cat(outputs, -1)


def co_action_history(induction: torch.Tensor, feed_orders: torch.Tensor,
                      mask: torch.Tensor,
                      co_action_layers: Sequence[int]) -> torch.Tensor:
    """The history variant, averaged over the valid history steps
    (CAN.py:126-155): (B, L, P) inputs, (B, L) mask -> (B, I, sum)."""
    B, I, _ = induction.shape
    L, P = feed_orders.shape[1:]
    hidden = feed_orders[:, :, None, None, :].expand(B, L, I, 1, P)
    maskf = mask.to(feed_orders.dtype)
    denom = torch.clamp(maskf.sum(-1), min=1e-9)[:, None, None]
    outputs = []
    for w, b in _micro_layers(induction, P, co_action_layers):
        hidden = torch.tanh(hidden @ w[:, None] + b[:, None, :, None, :])
        outputs.append((hidden[:, :, :, 0, :]
                        * maskf[:, :, None, None]).sum(1) / denom)
    return torch.cat(outputs, -1)


class CANModel(DIENModel):

    def __init__(self, user_features: Sequence[str],
                 item_features: Sequence[str],
                 situation_features: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 evolving_gru_type: str = "AGRU",
                 fcn_hidden_layers: Sequence[int] = (64,),
                 aux_hidden_layers: Sequence[int] = (64,),
                 alpha_aux: float = 0.0, dropout: float = 0.0,
                 induce_vec_size: int = 512, orders: int = 1,
                 co_action_layers: Sequence[int] = (4, 4)):
        # the situation co-action is the empty-situation branch for the
        # SegMM datasets (CAN.py:88-96): [user, history] co-actions first
        super().__init__(user_features, item_features, situation_features,
                         feature_max, emb_size, evolving_gru_type,
                         fcn_hidden_layers, aux_hidden_layers, alpha_aux,
                         False, dropout,
                         fcn_extra=2 * sum(co_action_layers))
        self.orders = orders
        self.co_action_layers = tuple(co_action_layers)
        self.item_embedding_induce = nn.Embedding(
            feature_max["item_id"],
            induce_size(emb_size, orders, co_action_layers, induce_vec_size))
        self.can_user_emb = nn.Embedding(feature_max["user_id"], emb_size)
        self.can_item_emb = nn.Embedding(feature_max["item_id"], emb_size)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        induction = self.item_embedding_induce(feed["item_id"].long())
        user_emb = self.can_user_emb(feed["user_id"].long())[:, None, :]
        his_emb = self.can_item_emb(feed["history_item_id"].long())
        L = his_emb.shape[1]
        mask = torch.arange(L, device=his_emb.device)[None, :] < \
            feed["lengths"][:, None]
        ui = co_action(induction, orders_cat(user_emb, self.orders),
                       self.co_action_layers)
        hi = co_action_history(induction, orders_cat(his_emb, self.orders),
                               mask, self.co_action_layers)
        return self.trunk(feed, generator, extra=torch.cat([ui, hi], -1))
