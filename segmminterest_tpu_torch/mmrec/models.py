"""MMRec model zoo: full-graph (user, item) embedding producers (port of
``segmminterest_tpu/mmrec/models.py``).

Behavioral spec: reference SkipPredBaseline/MMRec/src/models/{bpr,
lightgcn,layergcn,freedom,bm3,lattice,mmgcn,slmrec}.py. Every model exposes

    embeddings(keep_values=None) -> (user_emb (U, D), item_emb (I, D))

plus the loss helpers the runner dispatches on (``extra_loss``;
``bm3_loss``; ``ssl_loss``; LATTICE's ``embeddings`` also takes
``learned_edges`` and it has ``projected_features``). The reference's
positional hack is kept: a feature matrix whose last column is i_pos (x40)
adds a learned position embedding to the item ids (freedom.py:197-205).

The parameters carry the flax names (``user_embedding``, ``image_trs``,
``modal_layer_u_0`` ...), so ``models/convert.py:mmrec_state_dict`` maps a
JAX model's params onto them. The graph arrays and the features are
non-persistent buffers: ``.to(device)`` moves them and ``state_dict`` holds
the parameters only. BM3's and SLMRec's dropout masks are drawn from the
``generator`` handed in (torch's bits, not JAX's); ``masks`` takes them
instead.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .graph import item_graph_propagate, propagate, weighted_laplacian_values


def bpr_triplet_loss(u_e, pos_e, neg_e, row_mask):
    """-mean log sigmoid(pos - neg) (freedom.py bpr_loss)."""
    pos = (u_e * pos_e).sum(-1)
    neg = (u_e * neg_e).sum(-1)
    per = -F.logsigmoid(pos - neg)
    n = torch.clamp(row_mask.sum(), min=1)
    return (per * row_mask).sum() / n


def _cos(a, b):
    na = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-12)
    nb = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + 1e-12)
    return (na * nb).sum(-1)


def _dropout_masks(shapes, keep: float, generator, device):
    """One Bernoulli(keep) mask per shape from ``generator``."""
    return [torch.rand(s, generator=generator, device=device) < keep
            for s in shapes]


def _drop(x, mask, rate: float):
    return x * (mask.to(x.dtype) / (1 - rate))


def _leaky_relu(x):
    """jax.nn.leaky_relu: slope 1 at 0 (torch's takes 0.01 there, where
    MMGCN's first layer sits: its users start at zero)."""
    return torch.where(x >= 0, x, 0.01 * x)


def _buffer(x, dtype):
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _xavier_(w: torch.Tensor, generator: torch.Generator):
    """flax's xavier_uniform on a (rows, cols) table or (in, out) kernel;
    the same bound as torch's on the transposed (out, in) weight."""
    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * bound)


class _MMBase(nn.Module):
    """Shared fields + the LightGCN-style trunk every model reuses.
    ``n_ui_layers`` is FREEDOM's and LATTICE's."""
    modal_proj = None   # image_trs's width: "emb" | "feat" | None

    def __init__(self, n_users: int, n_items: int, edge_u, edge_i,
                 edge_values, emb_size: int = 64, v_feat=None,
                 mm_edges=None, mm_values=None, n_layers: int = 2,
                 n_mm_layers: int = 1, feat_embed_dim: int = 64,
                 reg_weight: float = 1e-5, lambda_coeff: float = 0.9,
                 dropout: float = 0.3, ssl_alpha: float = 0.01,
                 ssl_temp: float = 0.5, n_ui_layers: int = 2):
        super().__init__()
        self.n_users, self.n_items, self.emb_size = n_users, n_items, emb_size
        self.n_layers, self.n_mm_layers = n_layers, n_mm_layers
        self.n_ui_layers = n_ui_layers
        self.feat_embed_dim, self.reg_weight = feat_embed_dim, reg_weight
        self.lambda_coeff, self.dropout = lambda_coeff, dropout
        self.ssl_alpha, self.ssl_temp = ssl_alpha, ssl_temp
        for name, x, dt in (("edge_u", edge_u, torch.int64),
                            ("edge_i", edge_i, torch.int64),
                            ("edge_values", edge_values, torch.float32),
                            ("mm_edges", mm_edges, torch.int64),
                            ("mm_values", mm_values, torch.float32)):
            self.register_buffer(name, _buffer(x, dt), persistent=False)
        feats = _buffer(v_feat, torch.float32)
        self.has_pos_column = feats is not None and feats.shape[-1] % 8 == 1
        pos = None
        if self.has_pos_column:
            # int32(v * 40) in fp32, truncated toward zero, clipped to 0..39
            pos = torch.clamp((feats[:, -1] * 40).to(torch.int32), 0, 39)
            feats = feats[:, :-1].contiguous()
        self.register_buffer("pos_index", None if pos is None else pos.long(),
                             persistent=False)
        # the modal features, the position column dropped
        self.register_buffer("modal_feat", feats, persistent=False)
        self.user_embedding = nn.Parameter(torch.empty(n_users, emb_size))
        self.item_id_embedding = nn.Parameter(torch.empty(n_items, emb_size))
        if self.has_pos_column:
            self.new_pos_embedding = nn.Parameter(torch.empty(40, emb_size))
            self.learnable_param = nn.Parameter(torch.empty(()))
        if self.modal_proj and feats is not None:
            width = emb_size if self.modal_proj == "emb" else feat_embed_dim
            self.image_trs = nn.Linear(feats.shape[1], width)
        self._build_heads()
        self.reset_parameters(torch.Generator().manual_seed(0))

    def _build_heads(self):
        """The model's own Denses (none here)."""

    def reset_parameters(self, generator: torch.Generator):
        """Initial weights from ``generator``: xavier_uniform tables and
        Dense kernels, zero biases, ``learnable_param`` 0.1 (the flax
        initializers)."""
        for name, p in self.named_parameters():
            if name == "learnable_param":
                nn.init.constant_(p, 0.1)
            elif name.endswith("bias"):
                nn.init.zeros_(p)
            else:
                _xavier_(p, generator)

    def _item_base(self):
        i = self.item_id_embedding
        if self.has_pos_column:
            i = i + self.learnable_param * \
                self.new_pos_embedding.index_select(0, self.pos_index)
        return i

    def _gcn(self, u, i, keep_values, n_layers):
        """mean-of-layers LightGCN propagation."""
        values = keep_values if keep_values is not None else self.edge_values
        ue, ie = u, i
        u_acc, i_acc = u, i
        for _ in range(n_layers):
            ue, ie = propagate(ue, ie, self.edge_u, self.edge_i, values)
            u_acc, i_acc = u_acc + ue, i_acc + ie
        return u_acc / (n_layers + 1), i_acc / (n_layers + 1)

    def forward(self, keep_values=None):
        return self.embeddings(keep_values)

    def extra_loss(self, u_all, i_all, u_idx, pos_idx, neg_idx, row_mask):
        return 0.0


class BPRMM(_MMBase):
    """models/bpr.py: plain MF."""

    def embeddings(self, keep_values=None):
        return self.user_embedding, self._item_base()


class LightGCNMM(_MMBase):
    """models/lightgcn.py."""

    def embeddings(self, keep_values=None):
        return self._gcn(self.user_embedding, self._item_base(),
                         keep_values, self.n_layers)


class LayerGCNMM(_MMBase):
    """models/layergcn.py: layer outputs reweighted by cosine similarity with
    the ego embedding, SUMMED (the ego embedding left out)."""

    def embeddings(self, keep_values=None):
        u, i = self.user_embedding, self._item_base()
        values = keep_values if keep_values is not None else self.edge_values
        ue, ie = u, i
        u_sum = torch.zeros_like(u)
        i_sum = torch.zeros_like(i)
        for _ in range(self.n_layers):
            ue, ie = propagate(ue, ie, self.edge_u, self.edge_i, values)
            ue = _cos(ue, u)[:, None] * ue
            ie = _cos(ie, i)[:, None] * ie
            u_sum, i_sum = u_sum + ue, i_sum + ie
        return u_sum, i_sum


class FREEDOM(_MMBase):
    """models/freedom.py: frozen item kNN mm-graph on top of the user-item
    GCN; modality-alignment BPR term weighted by reg_weight. The projection
    matches emb_size (the alignment term dots users against it)."""
    modal_proj = "emb"

    def embeddings(self, keep_values=None):
        i = self._item_base()
        h = i
        for _ in range(self.n_mm_layers):
            h = item_graph_propagate(h, self.mm_edges, self.mm_values)
        u_g, i_g = self._gcn(self.user_embedding, i, keep_values,
                             self.n_ui_layers)
        return u_g, i_g + h

    def extra_loss(self, u_all, i_all, u_idx, pos_idx, neg_idx, row_mask):
        if self.modal_feat is None:
            return 0.0
        proj = self.image_trs(self.modal_feat)
        return self.reg_weight * bpr_triplet_loss(
            u_all[u_idx], proj[pos_idx], proj[neg_idx], row_mask)


class LATTICE(_MMBase):
    """models/lattice.py: item_adj = lambda * original_adj (frozen global
    sim-weighted kNN of raw features, lattice.py:72-76) + (1-lambda) *
    learned_adj (kNN REBUILT each epoch from the projected learned features,
    :137-157). The rebuilt structure arrives as a fixed-shape (n*k, 2) edge
    array (the runner's ``graph.knn_edges_device``); its sim-weighted
    laplacian values are computed from the projections on every batch, with
    their gradient. With ``learned_edges=None`` the learned weights fall
    back onto the frozen structure."""
    modal_proj = "feat"

    def projected_features(self):
        """image_trs(features) — the runner pulls this to rebuild the kNN
        structure (lattice.py:134)."""
        return (self.image_trs(self.modal_feat)
                if self.modal_feat is not None else None)

    def embeddings(self, keep_values=None, learned_edges=None):
        i = self._item_base()
        lam = self.lambda_coeff
        if self.modal_feat is not None:
            proj = self.image_trs(self.modal_feat)
            edges_l = (learned_edges if learned_edges is not None
                       else self.mm_edges)
            values_l = weighted_laplacian_values(edges_l, proj, self.n_items)
        else:
            edges_l, values_l = self.mm_edges, self.mm_values
            lam = 1.0
        h = i
        for _ in range(self.n_mm_layers):
            h = lam * item_graph_propagate(h, self.mm_edges, self.mm_values) \
                + (1 - lam) * item_graph_propagate(h, edges_l, values_l)
        u_g, i_g = self._gcn(self.user_embedding, i, keep_values,
                             self.n_ui_layers)
        return u_g, i_g + h


class BM3(_MMBase):
    """models/bm3.py: bootstrap latent targets — LightGCN trunk + predictor;
    cosine mismatch between online projections and dropped-out stop-gradient
    targets, plus modal terms (calculate_loss :55-120)."""
    modal_proj = "emb"

    def _build_heads(self):
        self.predictor = nn.Linear(self.emb_size, self.emb_size)

    def embeddings(self, keep_values=None):
        return self._gcn(self.user_embedding, self._item_base(),
                         keep_values, self.n_layers)

    def bm3_loss(self, u_idx, pos_idx, row_mask, keep_values=None,
                 generator=None, masks=None):
        """The whole BM3 objective (no BPR term). ``masks``: the three
        dropout masks (over u_all, i_all and the projected features), drawn
        from ``generator`` when None."""
        u_all, i_all = self.embeddings(keep_values)
        trs = (self.image_trs(self.modal_feat)
               if self.modal_feat is not None else None)
        if masks is None:
            shapes = [u_all.shape, i_all.shape] + (
                [trs.shape] if trs is not None else [])
            masks = _dropout_masks(shapes, 1 - self.dropout, generator,
                                   u_all.device)
        u_t = _drop(u_all.detach(), masks[0], self.dropout)[u_idx]
        i_t = _drop(i_all.detach(), masks[1], self.dropout)[pos_idx]
        u_on = self.predictor(u_all)[u_idx]
        i_on = self.predictor(i_all)[pos_idx]
        n = torch.clamp(row_mask.sum(), min=1)
        total = ((1 - _cos(u_on, i_t)) * row_mask).sum() / n \
            + ((1 - _cos(i_on, u_t)) * row_mask).sum() / n
        if trs is not None:
            f_t = _drop(trs.detach(), masks[2], self.dropout)[pos_idx]
            f_on = self.predictor(trs)[pos_idx]
            loss_v = ((1 - _cos(f_on, i_t.detach())) * row_mask).sum() / n
            loss_vv = ((1 - _cos(f_on, f_t)) * row_mask).sum() / n
            total = total + self.reg_weight * (loss_v + loss_vv)
        return total


class MMGCN(_MMBase):
    """models/mmgcn.py (single-modality configuration): a per-modality GCN
    whose item nodes start from projected modal features, combined with the
    id embeddings. ``fu`` starts at zeros; each layer propagates the old
    (fu, fi) pair before its Denses."""

    def _build_heads(self):
        if self.modal_feat is not None:
            d = self.emb_size
            self.modal_trs = nn.Linear(self.modal_feat.shape[1], d)
            for l in range(self.n_layers):
                setattr(self, f"modal_layer_u_{l}", nn.Linear(d, d))
                setattr(self, f"modal_layer_i_{l}", nn.Linear(d, d))

    def embeddings(self, keep_values=None):
        u, i = self.user_embedding, self._item_base()
        if self.modal_feat is None:
            return u, i
        values = keep_values if keep_values is not None else self.edge_values
        fi = self.modal_trs(self.modal_feat)
        fu = torch.zeros((self.n_users, self.emb_size), dtype=fi.dtype,
                         device=fi.device)
        for l in range(self.n_layers):
            fu, fi = propagate(fu, fi, self.edge_u, self.edge_i, values)
            fi = _leaky_relu(getattr(self, f"modal_layer_i_{l}")(fi))
            fu = _leaky_relu(getattr(self, f"modal_layer_u_{l}")(fu))
        return u + fu, i + fi


class SLMRec(_MMBase):
    """models/slmrec.py (compact): LightGCN trunk with modal-feature item
    initialization + a feature-dropout InfoNCE self-supervision term."""

    def _build_heads(self):
        if self.modal_feat is not None:
            self.modal_trs = nn.Linear(self.modal_feat.shape[1],
                                       self.emb_size)

    def embeddings(self, keep_values=None):
        i = self._item_base()
        if self.modal_feat is not None:
            i = i + self.modal_trs(self.modal_feat)
        return self._gcn(self.user_embedding, i, keep_values, self.n_layers)

    def ssl_loss(self, pos_idx, row_mask, keep_values=None, generator=None,
                 masks=None, i_all: Optional[torch.Tensor] = None):
        """InfoNCE between two 0.1-dropout views of the batch's positive
        items, over the whole padded batch (padded rows stay in every
        denominator; only their own terms are masked). ``masks``: the two
        views' masks, drawn from ``generator`` when None; ``i_all``: the
        item embeddings where the caller has them."""
        if i_all is None:
            _, i_all = self.embeddings(keep_values)
        e = i_all[pos_idx]
        if masks is None:
            masks = _dropout_masks([e.shape, e.shape], 1 - 0.1, generator,
                                   e.device)
        v1 = _drop(e, masks[0], 0.1)
        v2 = _drop(e, masks[1], 0.1)
        v1 = v1 / (torch.linalg.norm(v1, dim=-1, keepdim=True) + 1e-12)
        v2 = v2 / (torch.linalg.norm(v2, dim=-1, keepdim=True) + 1e-12)
        logits = (v1 @ v2.T) / self.ssl_temp
        per = -torch.log_softmax(logits, -1).diagonal()
        n = torch.clamp(row_mask.sum(), min=1)
        return self.ssl_alpha * (per * row_mask).sum() / n


MMREC_REGISTRY = {
    "BPR": BPRMM,
    "LightGCN": LightGCNMM,
    "LayerGCN": LayerGCNMM,
    "FREEDOM": FREEDOM,
    "BM3": BM3,
    "LATTICE": LATTICE,
    "MMGCN": MMGCN,
    "SLMRec": SLMRec,
}
