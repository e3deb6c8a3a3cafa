"""DIEN (port of ``segmminterest_tpu/segrec/models/dien.py``; reference
SegRec/models/context_seq/DIEN.py:19-260).

An interest-extractor GRU over the history, target attention, and an
evolving GRU modulated by the attention (AUGRU / AGRU / AIGRU). The GRUs
are written as a plain loop over the history steps (:class:`MaskedGRU`,
torch's gate layout in two Denses ``x2h`` / ``h2h``, not ``nn.GRU``); the
carry freezes beyond each row's length, so the last hidden state is
torch's packed-sequence output.

Quirks kept (PARITY.md):
 * the target attention's softmax runs over the flattened BATCH axis, not
   the history axis (DIEN.py:118-124, softmax(dim=-2)); a padded final
   batch's rows are excluded with -inf, so a row's score depends on the
   other rows of its batch;
 * gru_type "AGRU" is the AUGRU cell (DIEN.py:DynamicGRU), and every type
   but "AIGRU" runs it.

The extractor GRU sees the same history for every candidate of a row: it
runs once per row and is broadcast over the candidates (the JAX model
runs it per candidate on repeated rows; the values are the same).

``alpha_aux`` > 0 adds the auxiliary next-item BCE (DIEN.py:143,174-192)
in training, pre-weighted, as ``losses["aux_loss"]``; it reads the
``history_neg_*`` feeds (``feeds.py``'s ``neg_history``) and falls back
to the positive history where they are absent, as the JAX model does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..layers import MLPBlock, normal_param
from .din import _EmbedDict


class GRUCell(nn.Module):
    """One masked GRU / AUGRU step (``_GRUStep``): torch's gate layout,
    r/z/n (GRU) or u/r/n (AUGRU, the update gate scaled by the step's
    attention)."""

    def __init__(self, hidden: int, cell_type: str = "gru",
                 input_size: Optional[int] = None):
        super().__init__()
        self.hidden, self.cell_type = hidden, cell_type
        self.x2h = nn.Linear(input_size or hidden, 3 * hidden)
        self.h2h = nn.Linear(hidden, 3 * hidden)

    def forward(self, h, gx, valid, attn=None):
        """(N, H) carry, (N, 3H) input gates, (N,) valid -> (carry,
        output), both frozen / zero where the step is past the row."""
        gh = self.h2h(h)
        if self.cell_type == "augru":
            xu, xr, xn = gx.chunk(3, -1)
            hu, hr, hn = gh.chunk(3, -1)
            u = torch.sigmoid(xu + hu) * attn[:, None]
            r = torch.sigmoid(xr + hr)
            n = torch.tanh(xn + r * hn)
            h_new = h + u * (n - h)
        else:
            xr, xz, xn = gx.chunk(3, -1)
            hr, hz, hn = gh.chunk(3, -1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h_new = (1 - z) * n + z * h
        v = valid[:, None]
        return (torch.where(v, h_new, h),
                torch.where(v, h_new, torch.zeros_like(h_new)))


class MaskedGRU(nn.Module):
    """GRU / AUGRU over (N, L, input_size) with per-row lengths -> (outputs
    (N, L, hidden), last hidden (N, hidden)); ``input_size`` defaults to
    ``hidden`` (flax infers it from the input)."""

    def __init__(self, hidden: int, cell_type: str = "gru",
                 input_size: Optional[int] = None):
        super().__init__()
        self.cell = GRUCell(hidden, cell_type, input_size)

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor,
                attn: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        N, L, _ = xs.shape
        valid = torch.arange(L, device=xs.device)[None, :] < \
            lengths[:, None]
        gx = self.cell.x2h(xs)
        h = torch.zeros((N, self.cell.hidden), dtype=xs.dtype,
                        device=xs.device)
        outs = []
        for t in range(L):
            h, o = self.cell(h, gx[:, t], valid[:, t],
                             None if attn is None else attn[:, t])
            outs.append(o)
        return torch.stack(outs, 1), h


def batch_axis_attention(interest: torch.Tensor, attentionW: torch.Tensor,
                         target: torch.Tensor, row_mask: torch.Tensor
                         ) -> torch.Tensor:
    """einsum("nlh,hk,nk->nl") softmaxed over the N rows (the reference's
    dim=-2), rows where ``row_mask`` is false at -inf."""
    prod = torch.einsum("nlh,nh->nl", interest, target @ attentionW.T)
    prod = torch.where(row_mask[:, None], prod,
                       torch.full_like(prod, -torch.inf))
    return torch.softmax(prod.float(), dim=0).to(interest.dtype)


class DIENModel(nn.Module):

    def __init__(self, user_features: Sequence[str],
                 item_features: Sequence[str],
                 situation_features: Sequence[str],
                 feature_max: Dict[str, int], emb_size: int = 64,
                 evolving_gru_type: str = "AGRU",
                 fcn_hidden_layers: Sequence[int] = (64,),
                 aux_hidden_layers: Sequence[int] = (64,),
                 alpha_aux: float = 0.0,
                 add_historical_situations: bool = False,
                 dropout: float = 0.0, fcn_extra: int = 0):
        super().__init__()
        self.user_features = list(user_features)
        self.item_features = list(item_features)
        self.situation_features = list(situation_features)
        self.alpha_aux = alpha_aux
        self.hist_situs = bool(add_historical_situations
                               and self.situation_features)
        self.aigru = evolving_gru_type == "AIGRU"
        d = emb_size
        self.embedding_dict = _EmbedDict(
            self.user_features + self.item_features
            + self.situation_features, feature_max, d)
        gsz = self.gsz = d * (len(self.item_features)
                              + (len(self.situation_features)
                                 if self.hist_situs else 0))
        self.gru = MaskedGRU(gsz)
        normal_param(self, "attentionW", (gsz, gsz))
        self.evolving_gru = MaskedGRU(gsz, "gru" if self.aigru else "augru")
        n_ctx = d * (len(self.user_features) + len(self.situation_features))
        self.fcn_net = MLPBlock(fcn_extra + n_ctx + 4 * gsz,
                                fcn_hidden_layers, output_dim=1,
                                dropout=dropout)
        if alpha_aux > 0:
            self.aux_net = MLPBlock(2 * gsz, aux_hidden_layers, output_dim=1,
                                    dropout=dropout)

    def _stack(self, feed, names, prefix=""):
        ed = self.embedding_dict
        return torch.stack([ed.lookup(f, feed[prefix + f]) for f in names],
                           dim=-2)

    def trunk(self, feed, generator, extra: Optional[torch.Tensor] = None):
        """The DIEN trunk: (scores (B, I), losses); ``extra`` (B, I, k) is
        put first in the FCN's input (CAN's co-action features)."""
        B, I = feed["item_id"].shape
        lengths = feed["lengths"]
        target_emb = self._stack(feed, self.item_features)
        history_emb = self._stack(feed, self.item_features, "history_")
        if self.hist_situs:
            cur_situ = self._stack(feed, self.situation_features)
            target_emb = torch.cat(
                [target_emb, cur_situ[:, None].expand(
                    (B, I) + cur_situ.shape[1:])], dim=-2)
            history_emb = torch.cat(
                [history_emb, self._stack(feed, self.situation_features,
                                          "history_")], dim=-2)
        target_emb = target_emb.reshape(B, I, -1)
        history_emb = history_emb.reshape(B, history_emb.shape[1], -1)
        user_emb = self._stack(feed, self.user_features).reshape(B, -1)
        # the situation context stays in the FCN input when it is also
        # appended to the history and the target (DIEN.py:93-94)
        situ_emb = (self._stack(feed, self.situation_features).reshape(B, -1)
                    if self.situation_features else None)

        L, gsz = history_emb.shape[1], self.gsz
        interest_row, _ = self.gru(history_emb, lengths)   # (B, L, gsz)
        interest = interest_row[:, None].expand(B, I, L, gsz) \
            .reshape(B * I, L, gsz)
        len2d = lengths[:, None].expand(B, I).reshape(-1)
        rm2d = feed["row_mask"][:, None].expand(B, I).reshape(-1)
        attention = batch_axis_attention(
            interest, self.attentionW, target_emb.reshape(B * I, gsz), rm2d)
        # AIGRU scales the evolving GRU's input by the attention, the
        # others gate its update with it
        if self.aigru:
            h_out = self.evolving_gru(interest * attention[..., None],
                                      len2d)[1]
        else:
            h_out = self.evolving_gru(interest, len2d, attn=attention)[1]
        h_out = h_out.reshape(B, I, gsz)

        def over_items(t):
            return t[:, None].expand((B, I) + t.shape[1:])
        history_sum = history_emb.sum(-2)
        parts = [] if extra is None else [extra]
        parts.append(over_items(user_emb))
        if situ_emb is not None:
            parts.append(over_items(situ_emb))
        parts += [target_emb, over_items(history_sum),
                  target_emb * history_sum[:, None], h_out]
        predictions = self.fcn_net(torch.cat(parts, -1), generator)[..., 0]
        losses = {}
        if self.alpha_aux > 0 and self.training:
            losses["aux_loss"] = self.alpha_aux * self.aux_loss(
                feed, interest_row, history_emb, lengths, generator)
        return predictions, losses

    def forward(self, feed: Dict[str, torch.Tensor],
                feat_table: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        return self.trunk(feed, generator)

    def aux_loss(self, feed, interest, pos_emb, lengths, generator):
        """The auxiliary next-item BCE (DIEN.py:174-192) of the (B, L, E)
        interest states against the next positive and negative items."""
        ed = self.embedding_dict
        neg_emb = torch.stack(
            [ed.lookup(f, feed.get("history_neg_" + f,
                                   feed["history_" + f]))
             for f in self.item_features], dim=-2)
        if self.hist_situs:
            # negatives keep the positive history's situations
            # (DIEN.py:100-104)
            neg_emb = torch.cat(
                [neg_emb, self._stack(feed, self.situation_features,
                                      "history_")], dim=-2)
        neg_emb = neg_emb.reshape(neg_emb.shape[0], neg_emb.shape[1], -1)
        L = interest.shape[1]
        pos_in = torch.cat([interest[:, :-1], pos_emb[:, 1:]], -1)
        neg_in = torch.cat([interest[:, :-1], neg_emb[:, 1:]], -1)
        pos_p = torch.sigmoid(self.aux_net(pos_in, generator))[..., 0]
        neg_p = torch.sigmoid(self.aux_net(neg_in, generator))[..., 0]
        pad = (torch.arange(L, device=lengths.device)[None, :]
               < lengths[:, None])[:, 1:]
        eps = 1e-12
        ce_pos = -torch.log(torch.clamp(pos_p, eps, 1.0))
        ce_neg = -torch.log(torch.clamp(1 - neg_p, eps, 1.0))
        per_row = ((ce_pos + ce_neg) * pad).sum(-1) / (pad.sum(-1) + 1e-9)
        return per_row.mean()
