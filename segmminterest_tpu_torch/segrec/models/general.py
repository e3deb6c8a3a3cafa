"""General (non-sequential) recommenders (port of
``segmminterest_tpu/segrec/models/general.py``): the ReChorus baselines the
paper evaluates on the leave-frame ranking task.

Behavioral spec: reference ReChorus/src/models/general/
 * BPRMF.py — dot-product MF.
 * NeuMF.py — GMF ++ MLP towers.
 * LightGCN.py — n-layer normalised-adjacency propagation over the train
   graph, mean of the layer embeddings: two scatter-adds a layer
   (``index_add``) over the edge list, recomputed every forward as the
   JAX model does.
 * DirectAU.py — MF scored by dot product, trained with alignment +
   gamma * uniformity (:func:`direct_au_loss`, the runner's ``DirectAU``
   route).
 * POP.py — item train popularity; its one parameter exists so that the
   optimizer has something to hold.
 * BUIR.py — online and momentum-target tables and a shared predictor.

Parameter names are the flax tree's (``u_embeddings``, ``mlp.dense_0``...)
so ``models/convert.py`` maps the JAX params onto the ``state_dict``.
What the JAX models hold as static fields (POP's popularity, LightGCN's
edge list) are non-persistent buffers: they are not in the ``state_dict``,
as they are not in the params. Item 0 is a learned row like any other, as
flax's ``nn.Embed`` has no padding index.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..layers import MLPBlock, normal_param


def _dot(u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """(B, E) x (B, I, E) -> (B, I): the JAX models' elementwise product
    summed over E, so that a full-sort row scores its target at column 0
    and at the target's own column with the same op (the same bits)."""
    return (u[:, None, :] * i).sum(-1)


class BPRMFModel(nn.Module):

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64):
        super().__init__()
        self.u_embeddings = nn.Embedding(user_num, emb_size)
        self.i_embeddings = nn.Embedding(item_num, emb_size)

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        u = self.u_embeddings(feed["user_id"].long())
        i = self.i_embeddings(feed["item_id"].long())
        return _dot(u, i), {}


class NeuMFModel(nn.Module):
    """GMF + MLP fusion (ReChorus general/NeuMF.py)."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 layers: Sequence[int] = (64,), dropout: float = 0.2):
        super().__init__()
        self.mf_u = nn.Embedding(user_num, emb_size)
        self.mf_i = nn.Embedding(item_num, emb_size)
        self.mlp_u = nn.Embedding(user_num, emb_size)
        self.mlp_i = nn.Embedding(item_num, emb_size)
        self.mlp = MLPBlock(2 * emb_size, list(layers), dropout=dropout)
        self.prediction = nn.Linear(
            emb_size + (list(layers)[-1] if layers else 2 * emb_size), 1,
            bias=False)

    def forward(self, feed, feat_table=None, generator=None):
        uid, iid = feed["user_id"].long(), feed["item_id"].long()
        mlp_u = self.mlp_u(uid)
        mlp_i = self.mlp_i(iid)
        gmf = self.mf_u(uid)[:, None, :] * self.mf_i(iid)
        x = torch.cat([mlp_u[:, None, :].expand(-1, iid.shape[1], -1),
                       mlp_i], -1)
        x = self.mlp(x, generator)
        return self.prediction(torch.cat([gmf, x], -1))[..., 0], {}


class LightGCNModel(nn.Module):
    """LightGCN encoder: the embeddings propagated ``n_layers`` times over
    the symmetric-normalised train graph (edges with their duplicates, as
    the JAX CLI passes them) and averaged."""

    def __init__(self, user_num: int, item_num: int, edge_users,
                 edge_items, emb_size: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        normal_param(self, "u_embeddings", (user_num, emb_size), 0.01)
        normal_param(self, "i_embeddings", (item_num, emb_size), 0.01)
        eu = torch.as_tensor(np.asarray(edge_users, np.int64))
        ei = torch.as_tensor(np.asarray(edge_items, np.int64))
        self.register_buffer("edge_users", eu, persistent=False)
        self.register_buffer("edge_items", ei, persistent=False)
        # the degrees (edge counts, at least 1): integers, exact in fp32
        du = np.maximum(np.bincount(eu.numpy(), minlength=user_num), 1)
        di = np.maximum(np.bincount(ei.numpy(), minlength=item_num), 1)
        self.register_buffer("deg_users", torch.from_numpy(
            du.astype(np.float32)), persistent=False)
        self.register_buffer("deg_items", torch.from_numpy(
            di.astype(np.float32)), persistent=False)

    def forward(self, feed, feat_table=None, generator=None):
        eu, ei = self.edge_users, self.edge_items
        dt = self.u_embeddings.dtype
        norm = (1.0 / torch.sqrt(self.deg_users.to(dt)[eu]
                                 * self.deg_items.to(dt)[ei]))[:, None]
        ue, ie = self.u_embeddings, self.i_embeddings
        u_acc, i_acc = ue, ie
        for _ in range(self.n_layers):
            new_u = torch.zeros_like(ue).index_add(0, eu, ie[ei] * norm)
            new_i = torch.zeros_like(ie).index_add(0, ei, ue[eu] * norm)
            ue, ie = new_u, new_i
            u_acc = u_acc + ue
            i_acc = i_acc + ie
        u = (u_acc / (self.n_layers + 1))[feed["user_id"].long()]
        i = (i_acc / (self.n_layers + 1))[feed["item_id"].long()]
        return _dot(u, i), {}


def direct_au_loss(u_e: torch.Tensor, i_e: torch.Tensor,
                   row_mask: torch.Tensor, gamma: float) -> torch.Tensor:
    """alignment = E||u - i||^2 (normalised); uniformity =
    log E exp(-2||x - x'||^2) over the real rows' pairs
    (DirectAU.py:alignment/uniformity)."""
    def norm(x):
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                               min=1e-12)

    u, i = norm(u_e), norm(i_e)
    row_mask = row_mask.to(u.dtype)
    n = torch.clamp(row_mask.sum(), min=1)
    align = (torch.square(u - i).sum(-1) * row_mask).sum() / n

    def uniformity(x):
        d2 = torch.square(x[:, None, :] - x[None, :, :]).sum(-1)
        eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
        pairs = row_mask[:, None] * row_mask[None, :] * (1 - eye)
        e = torch.exp(-2.0 * d2) * pairs
        return torch.log(e.sum() / torch.clamp(pairs.sum(), min=1) + 1e-12)

    return align + gamma * (uniformity(u) + uniformity(i)) / 2


class DirectAUModel(BPRMFModel):
    """MF with the DirectAU alignment / uniformity objective
    (general/DirectAU.py): BPRMF's tables and scores; the runner applies
    :func:`direct_au_loss` where ``loss_n`` is ``DirectAU``, with its
    ``directau_gamma`` (the JAX model's own ``gamma`` field is read by
    nothing)."""


class POPModel(nn.Module):
    """Train-popularity scorer (general/POP.py); run with epoch 0: the
    ``dummy`` parameter exists only for the optimizer."""

    def __init__(self, popularity):
        super().__init__()
        self.dummy = nn.Parameter(torch.zeros(1))
        self.register_buffer("popularity", torch.as_tensor(
            np.asarray(popularity, np.float32)), persistent=False)

    def forward(self, feed, feat_table=None, generator=None):
        return self.popularity[feed["item_id"].long()], {}


class BUIRModel(nn.Module):
    """BUIR (general/BUIR.py): bootstrapped user / item representations,
    online and momentum-target tables and a shared predictor.

    prediction = predictor(i_on)·u_on + predictor(u_on)·i_on (:77-80).
    Training (the runner's ``BUIR`` route, :meth:`buir_loss`): symmetric
    2 - 2·cos between the online predictions and the detached targets
    over the batch's first candidate column (:101-114). The target tables
    are parameters, as in the JAX params: the loss gives them no gradient,
    but the optimizer holds them (``--l2`` decays them) and the runner
    applies :meth:`momentum_update` after every step and
    :meth:`sync_targets` before training."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 momentum: float = 0.995):
        super().__init__()
        self.momentum = momentum
        self.user_online = nn.Embedding(user_num, emb_size)
        self.item_online = nn.Embedding(item_num, emb_size)
        self.user_target = nn.Embedding(user_num, emb_size)
        self.item_target = nn.Embedding(item_num, emb_size)
        self.predictor = nn.Linear(emb_size, emb_size)

    def forward(self, feed, feat_table=None, generator=None):
        u_on = self.user_online(feed["user_id"].long())
        i_on = self.item_online(feed["item_id"].long())
        return ((self.predictor(i_on) * u_on[:, None, :]).sum(-1)
                + (self.predictor(u_on)[:, None, :] * i_on).sum(-1)), {}

    def buir_loss(self, user_id: torch.Tensor, item0_id: torch.Tensor,
                  row_mask: torch.Tensor) -> torch.Tensor:
        """The symmetric bootstrap loss over one candidate a row."""
        def norm(x):
            return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)

        user_id, item0_id = user_id.long(), item0_id.long()
        u_on = self.predictor(self.user_online.weight[user_id])
        i_on = self.predictor(self.item_online.weight[item0_id])
        u_t = self.user_target.weight[user_id].detach()
        i_t = self.item_target.weight[item0_id].detach()
        loss_ui = 2 - 2 * (norm(u_on) * norm(i_t)).sum(-1)
        loss_iu = 2 - 2 * (norm(i_on) * norm(u_t)).sum(-1)
        row_mask = row_mask.to(loss_ui.dtype)
        n = torch.clamp(row_mask.sum(), min=1)
        return ((loss_ui + loss_iu) * row_mask).sum() / n

    @torch.no_grad()
    def sync_targets(self) -> None:
        """Online -> target (BUIR.py:52-57), before training."""
        self.user_target.weight.copy_(self.user_online.weight)
        self.item_target.weight.copy_(self.item_online.weight)

    @torch.no_grad()
    def momentum_update(self) -> None:
        """t <- m·t + (1-m)·o for both target tables (BUIR.py:66-71)."""
        m = self.momentum
        for side in ("user", "item"):
            t = getattr(self, f"{side}_target").weight
            o = getattr(self, f"{side}_online").weight
            t.copy_(m * t + (1 - m) * o)
