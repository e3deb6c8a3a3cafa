"""Sequential recommenders (port of
``segmminterest_tpu/segrec/models/sequential.py``): the ReChorus baselines
for leave-frame ranking.

Behavioral spec: reference ReChorus/src/models/sequential/ and
developing/: SASRec, GRU4Rec, Caser, NARM, FPMC, TiSASRec, ComiRec,
ContraRec, TiMiRec, SRGNN, CLRec, FourierTA, S3Rec (each class names its
lines).

As in the JAX models:
 * every LayerNorm is flax's, epsilon 1e-6 (torch's default is 1e-5);
 * item 0 pads the histories and is a learned row (no ``padding_idx``);
   ContraRec's, TiMiRec's predictor's and S3Rec's tables have one row more,
   the mask token ``item_num``;
 * a masked softmax puts -inf where a slot is masked and then zero where
   the softmax gave NaN (a row with nothing to attend to, as a padded row
   of a final batch): ``torch.where``, never a product with a mask, so the
   gradient stays finite (NaN * 0 is NaN); no ``scaled_dot_product_attention``,
   which does not return zeros for such rows;
 * ComiRec and TiMiRec's pretrain stage score with the interest closest to
   the first candidate in training and with the max over interests in
   evaluation (``self.training``); ``torch.argmax`` takes the first of
   tied interests, as ``jnp.argmax`` does;
 * the models' own losses are returned in the ``losses`` dict under the
   names the flax models sow them (``contrarec_ccc``, ``clrec_infonce``,
   ``timirec_kl``, ``s3rec_pretrain``), pre-weighted.

One difference at a degenerate point: a padded row's sequence vector is
zero, and ContraRec and CLRec normalise it; ``jnp.linalg.norm``'s
gradient there is NaN, which makes the JAX models' gradients NaN on a
padded final batch though the row's terms are masked out, where
``torch.linalg.norm``'s is 0 and the port's gradients are those of the
real rows alone.

Dropout is flax's, drawn from the ``generator`` the caller passes in
training (:func:`..layers.dropout`). GRU4Rec, NARM, ContraRec's GRU encoder
and TiMiRec's predictor run DIEN's :class:`MaskedGRU`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import dropout, normal_param, uniform_param
from .dien import MaskedGRU

LN_EPS = 1e-6   # flax nn.LayerNorm's epsilon


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def masked_softmax(scores: torch.Tensor, keep: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """softmax over ``dim`` of ``scores`` where ``keep``, -inf elsewhere, in
    fp32; NaN (nothing kept) -> 0."""
    scores = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    p = torch.softmax(scores.float(), dim=dim).to(scores.dtype)
    return torch.where(torch.isnan(p), torch.zeros_like(p), p)


def _last(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, L, E) -> (B, E) at position clip(length - 1, 0, L - 1)."""
    idx = torch.clamp(lengths.long() - 1, 0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _dot(u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """(B, E) x (B, I, E) -> (B, I), as the JAX models' product summed."""
    return (u[:, None, :] * i).sum(-1)


def _l2norm(t: torch.Tensor) -> torch.Tensor:
    return t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-12)


def _position(lengths: torch.Tensor, valid: torch.Tensor,
              history_max: int) -> torch.Tensor:
    """Distance from the sequence end, 0 at padding, clipped to
    history_max (SASRec.py:forward)."""
    L = valid.shape[1]
    pos = (lengths.long()[:, None]
           - torch.arange(L, device=valid.device)[None, :]) * valid.long()
    return torch.clamp(pos, 0, history_max)


class TransformerBlock(nn.Module):
    """utils/layers.py TransformerLayer: MHA (kq_same=False) + post-LN FFN
    (the JAX ``_TransformerBlock``)."""

    def __init__(self, d_model: int, d_ff: int, n_heads: int,
                 dropout: float = 0.0):
        super().__init__()
        self.n_heads, self.dropout = n_heads, dropout
        self.q_linear = nn.Linear(d_model, d_model)
        self.k_linear = nn.Linear(d_model, d_model)
        self.v_linear = nn.Linear(d_model, d_model)
        self.ln1 = layer_norm(d_model)
        self.ff1 = nn.Linear(d_model, d_ff)
        self.ff2 = nn.Linear(d_ff, d_model)
        self.ln2 = layer_norm(d_model)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``attn_mask`` broadcasts to (B, heads, L, L); ``generator``
        None: no dropout."""
        B, L, D = x.shape
        dk = D // self.n_heads

        def split(t):
            return t.reshape(B, L, self.n_heads, dk).transpose(1, 2)
        q, k, v = (split(self.q_linear(x)), split(self.k_linear(x)),
                   split(self.v_linear(x)))
        scores = q @ k.transpose(-1, -2) / math.sqrt(dk)
        probs = masked_softmax(scores, attn_mask)
        ctx = (probs @ v).transpose(1, 2).reshape(B, L, D)
        ctx = self.ln1(dropout(ctx, self.dropout, generator) + x)
        out = self.ff2(F.relu(self.ff1(ctx)))
        return self.ln2(dropout(out, self.dropout, generator) + ctx)


def _gen(module: nn.Module, generator):
    return generator if module.training else None


class SASRecModel(nn.Module):
    """SASRec.py: causal transformer over the history (position = distance
    from the end, a causal mask only), read at position length - 1."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 num_layers: int = 1, num_heads: int = 4,
                 history_max: int = 20, dropout: float = 0.0):
        super().__init__()
        self.history_max = history_max
        self.i_embeddings = nn.Embedding(item_num, emb_size)
        self.p_embeddings = nn.Embedding(history_max + 1, emb_size)
        for b in range(num_layers):
            self.add_module(f"block_{b}", TransformerBlock(
                emb_size, emb_size, num_heads, dropout))
        self.num_layers = num_layers

    def forward(self, feed, feat_table=None, generator=None):
        history = feed["history_item_id"].long()
        lengths = feed["lengths"].long()
        L = history.shape[1]
        valid = history > 0
        his = self.i_embeddings(history) + self.p_embeddings(
            _position(lengths, valid, self.history_max))
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=his.device))
        gen = _gen(self, generator)
        for b in range(self.num_layers):
            his = getattr(self, f"block_{b}")(his, causal, gen)
        his = his * valid[:, :, None].to(his.dtype)
        return _dot(_last(his, lengths),
                    self.i_embeddings(feed["item_id"].long())), {}


class GRU4RecModel(nn.Module):
    """GRU4Rec.py: a GRU over the history, its last hidden state through a
    Dense head."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 hidden_size: int = 100, dropout: float = 0.0):
        super().__init__()
        self.i_embeddings = nn.Embedding(item_num, emb_size)
        self.rnn = MaskedGRU(hidden_size, input_size=emb_size)
        self.out = nn.Linear(hidden_size, emb_size)

    def forward(self, feed, feat_table=None, generator=None):
        his = self.i_embeddings(feed["history_item_id"].long())
        _, last_h = self.rnn(his, feed["lengths"].long())
        return _dot(self.out(last_h),
                    self.i_embeddings(feed["item_id"].long())), {}


class CaserModel(nn.Module):
    """Caser.py: the history's embeddings as an image; a vertical
    convolution over time and horizontal ones of window heights 1..L,
    max-pooled, then the user embedding beside them. The history is padded
    with item 0 to ``history_max`` rows, whose (learned) embeddings the
    convolutions read. ``conv_h_{h}`` is stored (h, E, num_horizon), as the
    JAX param, and read as (h·E, num_horizon); ``conv_v`` (history_max,
    num_vertical)."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 num_horizon: int = 16, num_vertical: int = 8, L: int = 4,
                 history_max: int = 20, dropout: float = 0.0):
        super().__init__()
        self.emb_size, self.L, self.history_max = emb_size, L, history_max
        self.num_horizon, self.num_vertical = num_horizon, num_vertical
        self.dropout = dropout
        self.i_embeddings = nn.Embedding(item_num, emb_size)
        width = 0
        if num_vertical > 0:
            normal_param(self, "conv_v", (history_max, num_vertical), 0.01)
            width += num_vertical * emb_size
        if num_horizon > 0:
            for h in range(1, L + 1):
                normal_param(self, f"conv_h_{h}",
                             (h, emb_size, num_horizon), 0.01)
                self.register_parameter(f"conv_h_bias_{h}", nn.Parameter(
                    torch.zeros(num_horizon)))
            width += L * num_horizon
        self.fc = nn.Linear(width, emb_size)
        self.u_embeddings = nn.Embedding(user_num, emb_size)
        self.i_out = nn.Embedding(item_num, 2 * emb_size)

    def forward(self, feed, feat_table=None, generator=None):
        history = feed["history_item_id"].long()
        B, L = history.shape
        if self.history_max > L:
            history = F.pad(history, (0, self.history_max - L))
        his = self.i_embeddings(history)        # (B, maxL, E)
        E, T = self.emb_size, his.shape[1]
        outs = []
        if self.num_vertical > 0:
            out_v = torch.einsum("ble,lv->bve", his, self.conv_v.to(his.dtype))
            outs.append(out_v.reshape(B, -1))
        if self.num_horizon > 0:
            hs = []
            for h in range(1, self.L + 1):
                w = getattr(self, f"conv_h_{h}").reshape(h * E,
                                                         self.num_horizon)
                windows = torch.stack(
                    [his[:, t:t + h].reshape(B, -1)
                     for t in range(T - h + 1)], 1)
                conv = F.relu(windows @ w.to(his.dtype)
                              + getattr(self, f"conv_h_bias_{h}"))
                hs.append(conv.max(1).values)
            outs.append(torch.cat(hs, -1))
        z = dropout(torch.cat(outs, -1), self.dropout,
                    _gen(self, generator))
        z = F.relu(self.fc(z))
        u = self.u_embeddings(feed["user_id"].long())
        return _dot(torch.cat([z, u], -1),
                    self.i_out(feed["item_id"].long())), {}


class NARMModel(nn.Module):
    """NARM.py: a global GRU (last hidden = the session's intent) and a
    local GRU whose per-step outputs are pooled by sigmoid energies (not a
    softmax, NARM.py:73-79), concatenated and projected to the item
    space."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 hidden_size: int = 100, attention_size: int = 50,
                 dropout: float = 0.0):
        super().__init__()
        self.i_embeddings = nn.Embedding(item_num, emb_size)
        self.encoder_g = MaskedGRU(hidden_size, input_size=emb_size)
        self.encoder_l = MaskedGRU(hidden_size, input_size=emb_size)
        self.A1 = nn.Linear(hidden_size, attention_size, bias=False)
        self.A2 = nn.Linear(hidden_size, attention_size, bias=False)
        self.attention_out = nn.Linear(attention_size, 1, bias=False)
        self.out = nn.Linear(2 * hidden_size, emb_size, bias=False)

    def forward(self, feed, feat_table=None, generator=None):
        history = feed["history_item_id"].long()
        lengths = feed["lengths"].long()
        his = self.i_embeddings(history)
        _, hidden_g = self.encoder_g(his, lengths)
        output_l, _ = self.encoder_l(his, lengths)
        energy = self.attention_out(torch.sigmoid(
            self.A1(hidden_g)[:, None, :] + self.A2(output_l)))
        energy = energy * (history > 0)[..., None].to(energy.dtype)
        c_l = (energy * output_l).sum(1)
        pred = self.out(torch.cat([hidden_g, c_l], 1))
        return _dot(pred, self.i_embeddings(feed["item_id"].long())), {}


class FPMCModel(nn.Module):
    """FPMC.py: user x candidate plus last item x candidate bilinear terms;
    the last item is the history's final valid position."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        self.ui_embeddings = nn.Embedding(user_num, emb_size)
        self.iu_embeddings = nn.Embedding(item_num, emb_size)
        self.li_embeddings = nn.Embedding(item_num, emb_size)
        self.il_embeddings = nn.Embedding(item_num, emb_size)

    def forward(self, feed, feat_table=None, generator=None):
        i_ids = feed["item_id"].long()
        history = feed["history_item_id"].long()
        last_item = _last(history[..., None], feed["lengths"])[:, 0]
        ui = self.ui_embeddings(feed["user_id"].long())
        li = self.li_embeddings(last_item)
        return (_dot(ui, self.iu_embeddings(i_ids))
                + _dot(li, self.il_embeddings(i_ids))), {}


class TiSASRecModel(nn.Module):
    """TiSASRec.py: SASRec with relative positions and personalised time
    intervals |t_i - t_j| // user_min_interval (clamped to ``time_max``;
    int64 milliseconds, kept integer) as additive key / value embeddings
    inside the causal attention (TimeIntervalMultiHeadAttention
    :118-176)."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 num_layers: int = 1, num_heads: int = 4,
                 time_max: int = 512, history_max: int = 20,
                 dropout: float = 0.0):
        super().__init__()
        E = emb_size
        self.num_layers, self.num_heads = num_layers, num_heads
        self.time_max, self.history_max = time_max, history_max
        self.dropout = dropout
        self.i_embeddings = nn.Embedding(item_num, E)
        self.p_k_embeddings = nn.Embedding(history_max + 1, E)
        self.p_v_embeddings = nn.Embedding(history_max + 1, E)
        self.t_k_embeddings = nn.Embedding(time_max + 1, E)
        self.t_v_embeddings = nn.Embedding(time_max + 1, E)
        for b in range(num_layers):
            for n in ("q", "k", "v"):
                self.add_module(f"{n}_linear_{b}", nn.Linear(E, E))
            self.add_module(f"ln1_{b}", layer_norm(E))
            self.add_module(f"ff1_{b}", nn.Linear(E, E))
            self.add_module(f"ff2_{b}", nn.Linear(E, E))
            self.add_module(f"ln2_{b}", layer_norm(E))

    def forward(self, feed, feat_table=None, generator=None):
        history = feed["history_item_id"].long()
        t_history = feed["history_times"].long()
        user_min_t = torch.clamp(feed["user_min_intervals"].long(), min=1)
        lengths = feed["lengths"].long()
        B, L = history.shape
        H = self.num_heads
        E = self.i_embeddings.embedding_dim
        dk = E // H
        valid = history > 0
        his = self.i_embeddings(history)
        position = _position(lengths, valid, self.history_max)
        pos_k = self.p_k_embeddings(position)
        pos_v = self.p_v_embeddings(position)
        interval = torch.abs(t_history[:, :, None] - t_history[:, None, :])
        interval = torch.clamp(
            torch.div(interval, user_min_t[:, None, None],
                      rounding_mode="floor"), 0, self.time_max)
        inter_k = self.t_k_embeddings(interval)      # (B, L, L, E)
        inter_v = self.t_v_embeddings(interval)
        ik = inter_k.reshape(B, L, L, H, dk).permute(0, 3, 1, 2, 4)
        iv = inter_v.reshape(B, L, L, H, dk).permute(0, 3, 1, 2, 4)
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=his.device))
        gen = _gen(self, generator)

        def split(t):
            return t.reshape(B, L, H, dk).transpose(1, 2)
        for b in range(self.num_layers):
            q = split(getattr(self, f"q_linear_{b}")(his))
            k = split(getattr(self, f"k_linear_{b}")(his) + pos_k)
            v = split(getattr(self, f"v_linear_{b}")(his) + pos_v)
            scores = q @ k.transpose(-1, -2)
            scores = scores + (q[:, :, :, None, :] * ik).sum(-1)
            scores = scores / math.sqrt(dk)
            # the reference subtracts the global max first (TiSASRec.py:172):
            # softmax is shift-invariant
            probs = masked_softmax(scores, causal)
            ctx = probs @ v + (probs[..., None] * iv).sum(-2)
            ctx = ctx.transpose(1, 2).reshape(B, L, E)
            x = getattr(self, f"ln1_{b}")(
                dropout(ctx, self.dropout, gen) + his)
            ff = getattr(self, f"ff2_{b}")(
                F.relu(getattr(self, f"ff1_{b}")(x)))
            his = getattr(self, f"ln2_{b}")(
                dropout(ff, self.dropout, gen) + x)
        his = his * valid[:, :, None].to(his.dtype)
        return _dot(_last(his, lengths),
                    self.i_embeddings(feed["item_id"].long())), {}


def _interests(his: torch.Tensor, his_pos: torch.Tensor, valid, W1, W2
               ) -> torch.Tensor:
    """K attention heads over the history -> (B, K, E) interests
    (ComiRec.py / TiMiRec.py MultiInterestExtractor)."""
    attn = W2(torch.tanh(W1(his_pos)))                        # (B, L, K)
    attn = masked_softmax(attn.transpose(-1, -2), valid[:, None, :])
    return (his[:, None, :, :] * attn[..., None]).sum(-2)


def _multi_interest_scores(module: nn.Module, interests, i_vectors):
    """Training: each row's interest closest to its first candidate
    (argmax, the first of ties) scores every candidate (ComiRec.py:83-88);
    evaluation: the max over interests per candidate."""
    if module.training:
        target_pred = (interests * i_vectors[:, :1]).sum(-1)     # (B, K)
        sel = torch.argmax(target_pred, -1)
        user_vector = interests[torch.arange(interests.shape[0],
                                             device=sel.device), sel]
        return _dot(user_vector, i_vectors)
    return (interests[:, None, :, :]
            * i_vectors[:, :, None, :]).sum(-1).max(-1).values


class ComiRecModel(nn.Module):
    """ComiRec.py: multi-interest extraction, K attention heads over the
    (position-embedded) history."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 attn_size: int = 8, K: int = 2, add_pos: bool = True,
                 history_max: int = 20, dropout: float = 0.0):
        super().__init__()
        self.add_pos, self.history_max = add_pos, history_max
        self.i_embeddings = nn.Embedding(item_num, emb_size)
        if add_pos:
            self.p_embeddings = nn.Embedding(history_max + 1, emb_size)
        self.W1 = nn.Linear(emb_size, attn_size)
        self.W2 = nn.Linear(attn_size, K)

    def forward(self, feed, feat_table=None, generator=None):
        history = feed["history_item_id"].long()
        valid = history > 0
        his = self.i_embeddings(history)
        his_pos = his
        if self.add_pos:
            his_pos = his + self.p_embeddings(_position(
                feed["lengths"], valid, self.history_max))
        interests = _interests(his, his_pos, valid, self.W1, self.W2)
        return _multi_interest_scores(
            self, interests, self.i_embeddings(feed["item_id"].long())), {}


class ContraRecModel(nn.Module):
    """ContraRec (sequential/ContraRec.py): a sequence encoder trained with
    the runner's context-target contrastive loss (``ContraRec``: a
    temperature softmax over the candidates) plus a context-context SupCon
    loss over the two augmented views of the history
    (``history_item_id_a`` / ``_b``, the feeds' ``augment_history``),
    computed over the batch in training and returned pre-weighted by
    ``gamma`` as ``contrarec_ccc`` (:85-106). Encoders: BERT4Rec (a
    bidirectional transformer, :250-276; its blocks never drop out, as in
    the JAX model) or GRU4Rec. The item table has the mask token's row
    ``item_num``."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 encoder: str = "BERT4Rec", num_layers: int = 2,
                 num_heads: int = 2, history_max: int = 20,
                 gamma: float = 1.0, ccc_temp: float = 0.2,
                 dropout: float = 0.0):
        super().__init__()
        self.encoder, self.gamma, self.ccc_temp = encoder, gamma, ccc_temp
        self.num_layers = num_layers
        self.i_embeddings = nn.Embedding(item_num + 1, emb_size)
        if encoder == "GRU4Rec":
            self.rnn = MaskedGRU(128, input_size=emb_size)
            self.enc_out = nn.Linear(128, emb_size, bias=False)
        else:
            self.p_embeddings = nn.Embedding(history_max + 1, emb_size)
            for b in range(num_layers):
                self.add_module(f"block_{b}", TransformerBlock(
                    emb_size, emb_size, num_heads, dropout))

    def encode(self, his: torch.Tensor, lengths: torch.Tensor):
        if self.encoder == "GRU4Rec":
            return self.enc_out(self.rnn(his, lengths)[1])
        L = his.shape[1]
        valid = torch.arange(L, device=his.device)[None, :] < lengths[:, None]
        x = his + self.p_embeddings(
            torch.arange(L, device=his.device)[None, :] * valid.long())
        for b in range(self.num_layers):
            x = getattr(self, f"block_{b}")(x, valid[:, None, None, :])
        return _last(x * valid[:, :, None].to(x.dtype), lengths)

    def forward(self, feed, feat_table=None, generator=None):
        lengths = feed["lengths"].long()
        i_ids = feed["item_id"].long()
        his_vector = self.encode(
            self.i_embeddings(feed["history_item_id"].long()), lengths)
        prediction = _dot(his_vector, self.i_embeddings(i_ids))
        losses = {}
        if "history_item_id_a" in feed and self.training:
            feats = [_l2norm(self.encode(self.i_embeddings(feed[k].long()),
                                         lengths))
                     for k in ("history_item_id_a", "history_item_id_b")]
            ccc = self.contra_loss(torch.stack(feats, 1), i_ids[:, 0],
                                   feed["row_mask"])
            losses["contrarec_ccc"] = self.gamma * ccc
        return prediction, losses

    def contra_loss(self, features: torch.Tensor, labels: torch.Tensor,
                    row_mask: torch.Tensor) -> torch.Tensor:
        """SupCon over two views (ContraLoss :141-193); padded rows out of
        the anchors, the positives and the denominator."""
        B, dt = features.shape[0], features.dtype
        pos_mask = (labels[:, None] == labels[None, :]).to(dt).repeat(2, 2)
        feats = torch.cat([features[:, 0], features[:, 1]], 0)
        logits = feats @ feats.T / self.ccc_temp
        logits = logits - logits.max(1, keepdim=True).values.detach()
        rm2 = row_mask.to(dt).repeat(2)
        valid_pair = rm2[:, None] * rm2[None, :]
        self_mask = 1.0 - torch.eye(2 * B, dtype=dt, device=feats.device)
        logits_mask = self_mask * valid_pair
        pos_mask = pos_mask * logits_mask
        exp_logits = torch.exp(logits) * logits_mask
        log_prob = logits - torch.log(exp_logits.sum(1, keepdim=True)
                                      + 1e-10)
        mean_log_prob = (pos_mask * log_prob).sum(1) / (pos_mask.sum(1)
                                                        + 1e-10)
        n = torch.clamp(rm2.sum(), min=1)
        return -self.ccc_temp * (mean_log_prob * rm2).sum() / n


class TiMiRecModel(nn.Module):
    """TiMiRec (sequential/TiMiRec.py): target-interest distillation.

    ``stage='pretrain'``: the multi-interest extractor alone (position
    embedding and one transformer layer), trained and evaluated as ComiRec
    (:116-127). ``stage='finetune'``: a GRU interest predictor and its
    projection give pred_intent (B, K); the user vector is the
    softmax(pred_intent) blend of the extractor's interests (:128-143), and
    in training the KL between pred_intent and the detached cosine
    target_intent, times temp², is returned as ``timirec_kl``
    (:146-157). Only the stage's modules exist, as only they exist in the
    JAX params, so the pretrain state loads into a finetune model by the
    runner's partial load."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 attn_size: int = 8, K: int = 2, add_pos: bool = True,
                 add_trm: bool = True, temp: float = 1.0, n_layers: int = 1,
                 stage: str = "finetune", history_max: int = 20,
                 dropout: float = 0.0):
        super().__init__()
        if stage not in ("pretrain", "finetune"):
            raise ValueError(f"TiMiRec stage {stage}")
        E = emb_size
        self.add_pos, self.add_trm, self.temp = add_pos, add_trm, temp
        self.n_layers, self.stage, self.history_max = n_layers, stage, \
            history_max
        self.i_embeddings = nn.Embedding(item_num, E)
        if add_pos:
            self.p_embeddings = nn.Embedding(history_max + 1, E)
        if add_trm:
            self.transformer = TransformerBlock(E, E, 1, dropout)
        self.W1 = nn.Linear(E, attn_size)
        self.W2 = nn.Linear(attn_size, K)
        if stage == "finetune":
            self.predictor_i_embeddings = nn.Embedding(item_num + 1, E)
            self.predictor_rnn = MaskedGRU(E)
            for i in range(n_layers - 1):
                self.add_module(f"proj_{i}", nn.Linear(E, E))
            self.proj_final = nn.Linear(E, K)

    def forward(self, feed, feat_table=None, generator=None):
        history = feed["history_item_id"].long()
        lengths = feed["lengths"].long()
        valid = history > 0
        gen = _gen(self, generator)
        # MultiInterestExtractor (:163-199)
        his = self.i_embeddings(history)
        if self.add_pos:
            his = his + self.p_embeddings(_position(lengths, valid,
                                                    self.history_max))
        if self.add_trm:
            his = self.transformer(his, valid[:, None, None, :], gen)
            his = his * valid[:, :, None].to(his.dtype)
        interests = _interests(his, his, valid, self.W1, self.W2)
        i_vectors = self.i_embeddings(feed["item_id"].long())
        if self.stage == "pretrain":
            return _multi_interest_scores(self, interests, i_vectors), {}

        # InterestPredictor + proj (:128-143)
        _, x = self.predictor_rnn(self.predictor_i_embeddings(history),
                                  lengths)
        for i in range(self.n_layers - 1):
            x = F.relu(dropout(getattr(self, f"proj_{i}")(x), 0.5, gen))
        pred_intent = self.proj_final(x)
        losses = {}
        if self.training:
            target_intent = (_l2norm(interests)
                             * _l2norm(i_vectors[:, 0])[:, None, :]).sum(-1)
            # KL(pred || target) * temp^2, batchmean (:146-157)
            p_log = torch.log_softmax(pred_intent / self.temp, 1)
            q = torch.softmax(target_intent.detach() / self.temp, 1)
            rm = feed["row_mask"].to(torch.float32)
            kl = (q * (torch.log(torch.clamp(q, 1e-12, 1.0)) - p_log)).sum(1)
            kl = (kl * rm).sum() / torch.clamp(rm.sum(), min=1)
            losses["timirec_kl"] = self.temp * self.temp * kl
        user_vector = (interests
                       * torch.softmax(pred_intent, -1)[:, :, None]).sum(-2)
        return _dot(user_vector, i_vectors), losses


class SRGNNModel(nn.Module):
    """SRGNN (developing/SRGNN.py): a session-graph GNN over the feed's
    per-row graph (``srgnn_items``: the unique nodes, item 0 among them
    where the history pads; ``srgnn_A``: [L, 2L] in / out normalised
    adjacency; ``srgnn_alias``: position -> node), a gated cell
    (:103-148) and a last-node + attention readout (:88-97). ``w_ih``
    (3E, 2E) and ``w_hh`` (3E, E) are raw parameters used as ``x @ w.T``,
    stored as the JAX params are (not Dense kernels)."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 num_layers: int = 1, dropout: float = 0.0):
        super().__init__()
        E = emb_size
        self.num_layers = num_layers
        std = 1.0 / math.sqrt(E)
        self.i_embeddings = nn.Embedding(item_num, E)
        self.linear_edge_in = nn.Linear(E, E)
        self.linear_edge_out = nn.Linear(E, E)
        for name, shape in (("w_ih", (3 * E, 2 * E)), ("w_hh", (3 * E, E)),
                            ("b_ih", (3 * E,)), ("b_hh", (3 * E,)),
                            ("b_iah", (E,)), ("b_ioh", (E,))):
            uniform_param(self, name, shape, std)
        self.linear1 = nn.Linear(E, E)
        self.linear2 = nn.Linear(E, E)
        self.linear3 = nn.Linear(E, 1, bias=False)
        self.linear_transform = nn.Linear(2 * E, E)

    def forward(self, feed, feat_table=None, generator=None):
        history = feed["history_item_id"].long()
        lengths = feed["lengths"].long()
        alias = feed["srgnn_alias"].long()
        hidden = self.i_embeddings(feed["srgnn_items"].long())
        A = feed["srgnn_A"].to(hidden.dtype)
        B, L = history.shape
        for _ in range(self.num_layers):
            a_in = A[:, :, :L] @ self.linear_edge_in(hidden) + self.b_iah
            a_out = A[:, :, L:] @ self.linear_edge_out(hidden) + self.b_ioh
            gi = torch.cat([a_in, a_out], -1) @ self.w_ih.T + self.b_ih
            gh = hidden @ self.w_hh.T + self.b_hh
            i_r, i_i, i_n = gi.chunk(3, -1)
            h_r, h_i, h_n = gh.chunk(3, -1)
            reset = torch.sigmoid(i_r + h_r)
            inp = torch.sigmoid(i_i + h_i)
            new = torch.tanh(i_n + reset * h_n)
            hidden = (1 - inp) * hidden + inp * new
        seq_hidden = torch.gather(
            hidden, 1, alias[..., None].expand(-1, -1, hidden.shape[-1]))
        ht = _last(seq_hidden, lengths)
        alpha = self.linear3(torch.sigmoid(
            self.linear1(ht)[:, None, :] + self.linear2(seq_hidden)))
        valid = (history > 0).to(hidden.dtype)
        a = (alpha * seq_hidden * valid[:, :, None]).sum(1)
        his_vector = self.linear_transform(torch.cat([a, ht], 1))
        return _dot(his_vector,
                    self.i_embeddings(feed["item_id"].long())), {}


class CLRecModel(nn.Module):
    """CLRec (developing/CLRec.py): a BERT4Rec encoder scored against the
    candidates; training minimises only the in-batch InfoNCE between the
    sequence vector and the first candidate's vector (:63-108), returned as
    ``clrec_infonce`` (the runner's ``CLRec`` route adds nothing)."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 temp: float = 0.2, num_layers: int = 2, num_heads: int = 2,
                 history_max: int = 20, dropout: float = 0.0):
        super().__init__()
        self.temp, self.num_layers = temp, num_layers
        self.i_embeddings = nn.Embedding(item_num, emb_size)
        self.p_embeddings = nn.Embedding(history_max + 1, emb_size)
        for b in range(num_layers):
            self.add_module(f"block_{b}", TransformerBlock(
                emb_size, emb_size, num_heads, dropout))

    def forward(self, feed, feat_table=None, generator=None):
        history = feed["history_item_id"].long()
        lengths = feed["lengths"].long()
        L = history.shape[1]
        ar = torch.arange(L, device=history.device)[None, :]
        valid = ar < lengths[:, None]
        his = self.i_embeddings(history) + self.p_embeddings(
            ar * valid.long())
        gen = _gen(self, generator)
        for b in range(self.num_layers):
            his = getattr(self, f"block_{b}")(his, valid[:, None, None, :],
                                              gen)
        his_vector = _last(his * valid[:, :, None].to(his.dtype), lengths)
        i_vectors = self.i_embeddings(feed["item_id"].long())
        prediction = _dot(his_vector, i_vectors)
        losses = {}
        if self.training:
            logits = _l2norm(his_vector) @ _l2norm(i_vectors[:, 0]).T \
                / self.temp
            logits = logits - logits.max(1, keepdim=True).values.detach()
            rm = feed["row_mask"].to(logits.dtype)
            # padded rows leave both the positives and the denominator
            exp_l = torch.exp(logits) * rm[None, :]
            log_prob = logits - torch.log(exp_l.sum(1, keepdim=True)
                                          + 1e-10)
            losses["clrec_infonce"] = -(torch.diagonal(log_prob) * rm).sum() \
                / torch.clamp(rm.sum(), min=1)
        return prediction, losses


class FourierTAModel(nn.Module):
    """FourierTA (developing/FourierTA.py): target attention over the
    history whose weights decay by a learned truncated-Fourier function of
    the log-normalised time delta (idft_decay :84-110); user + attended
    context scored against the candidates, plus an item bias. delta_n =
    max(log2(delta_t / t_scalar + 1e-6), 0) in fp32 (KDAReader.norm_time)."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 t_scalar: int = 60, dropout: float = 0.0):
        super().__init__()
        E = emb_size
        self.t_scalar, self.dropout = t_scalar, dropout
        self.user_embeddings = nn.Embedding(user_num, E)
        self.item_embeddings = nn.Embedding(item_num, E)
        self.A = nn.Linear(E, 10)
        self.A_out = nn.Linear(10, 1, bias=False)
        normal_param(self, "freq_real", (E,), 0.01)
        normal_param(self, "freq_imag", (E,), 0.01)
        self.W1 = nn.Linear(E, E)
        self.W2 = nn.Linear(E, E)
        self.layer_norm = layer_norm(E)
        self.item_bias = nn.Embedding(item_num, 1)

    def forward(self, feed, feat_table=None, generator=None):
        i_ids = feed["item_id"].long()
        history = feed["history_item_id"].long()
        delta_n = torch.clamp(torch.log2(
            feed["history_delta_t"].to(torch.float32) / self.t_scalar
            + 1e-6), min=0.0)
        u_vectors = self.user_embeddings(feed["user_id"].long())
        i_vectors = self.item_embeddings(i_ids)
        his = self.item_embeddings(history)
        valid = (history > 0)[:, None, :]
        # attention energies (FourierTemporalAttention.forward :112-126)
        q = his[:, None, :, :] * i_vectors[:, :, None, :]
        att = self.A_out(torch.tanh(self.A(q)))[..., 0]
        att = att - att.max().detach()
        att = masked_softmax(att, valid)
        # truncated-Fourier decay (idft_decay :84-99)
        d_f = self.freq_real.shape[0]
        freq = torch.linspace(0, 1, d_f, device=att.device,
                              dtype=self.freq_real.dtype) / 2.0
        freqs = torch.cat([freq, -freq])
        x_real = torch.cat([self.freq_real, self.freq_real])
        x_imag = torch.cat([self.freq_imag, -self.freq_imag])
        w = 2.0 * math.pi * freqs * delta_n.to(freqs.dtype)[..., None]
        decay = torch.clamp((torch.cos(w) * x_real
                             - torch.sin(w) * x_imag).mean(-1) / 2.0, 0, 1)
        att = att * torch.where(valid, decay[:, None, :],
                                torch.zeros_like(decay[:, None, :]))
        context = att @ his                              # (B, I, E)
        res = context
        context = self.W2(F.relu(self.W1(context)))
        context = dropout(context, self.dropout, _gen(self, generator))
        context = self.layer_norm(res + context)
        i_bias = self.item_bias(i_ids)[..., 0]
        return ((u_vectors[:, None, :] + context) * i_vectors).sum(-1) \
            + i_bias, {}


class S3RecModel(nn.Module):
    """S3Rec (developing/S3Rec.py): self-supervised pretrain, then a
    BERT4Rec scorer.

    A pretrain batch (``mask_seq``... ``seq_len``, the feeds'
    ``s3rec_pretrain``) gives masked-item prediction — a sigmoid bilinear
    score of the encoder output against the positive and negative items at
    the masked positions — and segment prediction — the encoded context
    with a masked span against the encoded positive and negative segments —
    each as -log sigmoid(pos - neg), weighted by ``mip_weight`` and
    ``sp_weight`` and returned as ``s3rec_pretrain`` (:59-113); the scores
    are zeros (B, 1). ``mip_norm`` and ``sp_norm`` exist only where
    ``pretrain`` is set (stage 1), as the JAX params hold them only after a
    pretrain init: stage 2 loads stage 1's state by the runner's partial
    load. The item table has the mask token's row ``item_num``."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 num_layers: int = 2, num_heads: int = 2,
                 mip_weight: float = 0.2, sp_weight: float = 0.5,
                 history_max: int = 20, dropout: float = 0.2,
                 pretrain: bool = False):
        super().__init__()
        E = emb_size
        self.item_num, self.num_layers, self.dropout = item_num, num_layers, \
            dropout
        self.mip_weight, self.sp_weight = mip_weight, sp_weight
        self.pretrain = pretrain
        self.i_embeddings = nn.Embedding(item_num + 1, E)
        self.p_embeddings = nn.Embedding(history_max + 1, E)
        for b in range(num_layers):
            self.add_module(f"block_{b}", TransformerBlock(
                E, E, num_heads, dropout))
        self.layer_norm = layer_norm(E)
        if pretrain:
            self.mip_norm = nn.Linear(E, E)
            self.sp_norm = nn.Linear(E, E)

    def encode(self, seq_ids, lengths, gen):
        his = self.i_embeddings(seq_ids.long())
        L = his.shape[1]
        ar = torch.arange(L, device=his.device)[None, :]
        valid = ar < lengths[:, None]
        x = his + self.p_embeddings(ar * valid.long())
        x = dropout(self.layer_norm(x), self.dropout, gen)
        for b in range(self.num_layers):
            x = getattr(self, f"block_{b}")(x, valid[:, None, None, :], gen)
        return x * valid[:, :, None].to(x.dtype), valid

    def forward(self, feed, feat_table=None, generator=None):
        gen = _gen(self, generator)
        if "mask_seq" in feed:
            if not self.pretrain:
                raise ValueError("S3Rec: a pretrain batch needs the model "
                                 "built with pretrain=True (stage 1)")
            return self._pretrain(feed, gen)
        lengths = feed["lengths"].long()
        his_vector = _last(self.encode(feed["history_item_id"], lengths,
                                       gen)[0], lengths)
        return _dot(his_vector,
                    self.i_embeddings(feed["item_id"].long())), {}

    def _pretrain(self, feed, gen):
        lengths = feed["seq_len"].long()
        seq_out, valid = self.encode(feed["mask_seq"], lengths, gen)
        rm = feed["row_mask"].to(seq_out.dtype)
        pos_v = self.i_embeddings(feed["pos_item"].long())
        neg_v = self.i_embeddings(feed["neg_item"].long())
        mip = self.mip_norm(seq_out)
        pos_score = torch.sigmoid((mip * pos_v).sum(-1))
        neg_score = torch.sigmoid((mip * neg_v).sum(-1))
        mip_dis = torch.sigmoid(pos_score - neg_score)
        mip_mask = ((feed["mask_seq"].long() == self.item_num)
                    & valid).to(seq_out.dtype) * rm[:, None]
        mip_loss = (-torch.log(torch.clamp(mip_dis, 1e-7, 1.0))
                    * mip_mask).sum()

        def seg(key):
            return _last(self.encode(feed[key], lengths, gen)[0], lengths)
        ctx = self.sp_norm(seg("mask_seg_seq"))
        ps = torch.sigmoid((ctx * seg("pos_seg")).sum(-1))
        ns = torch.sigmoid((ctx * seg("neg_seg")).sum(-1))
        sp_dis = torch.sigmoid(ps - ns)
        sp_loss = (-torch.log(torch.clamp(sp_dis, 1e-7, 1.0)) * rm).sum()
        loss = self.mip_weight * mip_loss + self.sp_weight * sp_loss
        zeros = torch.zeros((feed["mask_seq"].shape[0], 1),
                            dtype=seq_out.dtype, device=seq_out.device)
        return zeros, {"s3rec_pretrain": loss}
