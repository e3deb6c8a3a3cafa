"""Impression-list reranking (port of ``segmminterest_tpu/segrec/rerank.py``):
reader, metrics, base rankers, the rerankers PRM, SetRank and MIR, and the
impression runner.

Behavioral spec: reference SkipPredBaseline/ReChorus/src/...:
 * helpers/ImpressionReader.py:27-129 — rows sharing (user, time) form one
   impression with positive / negative item lists; groups without positives
   or without negatives are dropped;
 * helpers/ImpressionRunner.py:18-133 — listwise NDCG/MAP/HR over the
   padded [pos | neg] candidate axis with the eps tie-break that ranks
   positives BELOW equal-scoring negatives (:90-94) and a stable mergesort
   (:97), on the host in float64;
 * models/BaseRerankerModel.py:15-133 — rerankers wrap a pretrained base
   ranker whose scores, user vector and item vectors feed the reranker;
 * models/reranker/{PRM,SetRank,MIR}.py — the three rerankers.

No pandas: ``groupby(sort=False)`` and ``pd.unique`` are reproduced with
numpy (groups and values in order of first appearance).

Every impression is padded to a fixed [pos_len | neg_len] candidate axis
and the final batch is padded by WRAPPING real rows (``row_mask`` marks the
real ones): the listwise losses average over every row, the wrapped copies
included, as in the JAX package; evaluation drops them.

A reranker holds its ranker as the child ``ranker`` (the flax tree's scope
``ranker``), evaluated inside the reranker's forward. The ranker's
parameters stay ``nn.Parameter``s in the reranker's optimizer; unless
``tuneranker``, its outputs are detached, so they get zero gradients, and
``--l2`` still moves them, as ``stop_gradient`` and
``optax.add_decayed_weights`` do in the JAX runner.

As in the JAX models: flax LayerNorms (epsilon 1e-6); a masked softmax
puts -inf by ``torch.where`` and zero where it gave NaN (a fully masked
row); ``_rank_positions`` is a double stable argsort (tied ranker scores,
padded slots among them, keep their slot order). MIR's BiLSTM is flax's
``OptimizedLSTMCell`` run by ``nn.RNN`` over the whole padded history
(zero initial state, no sequence lengths; the backward cell reads the
sequence reversed, padding first), its cells the flax tree's
``OptimizedLSTMCell_0`` (forward) and ``OptimizedLSTMCell_1`` (backward):
input projections without a bias, hidden ones with one.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Iterator

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..engine.checkpoint import msgpack_restore
from ..models.convert import segrec_state_dict
from .impression import IMPRESSION_LOSSES
from .layers import dropout, leaky_relu, normal_param
from .models.sequential import (TransformerBlock, _gen, layer_norm,
                                masked_softmax)
from .runner import RankingRunner

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Impression data (ImpressionReader.py:27-129)

def _first_seen_groups(*cols):
    """``groupby(cols, sort=False)``: the row indices of each key, keys in
    order of first appearance, rows in frame order."""
    n = len(cols[0])
    if n == 0:
        return []
    keys = np.stack([np.asarray(c) for c in cols], 1)
    _, first, inverse = np.unique(keys, axis=0, return_index=True,
                                  return_inverse=True)
    inverse = inverse.reshape(-1)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    order = np.argsort(rank[inverse], kind="stable")
    bounds = np.flatnonzero(np.diff(rank[inverse][order])) + 1
    return np.split(order, bounds)


def _unique_in_order(values: np.ndarray) -> np.ndarray:
    """``pd.unique``: the distinct values in order of first appearance."""
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def build_impressions(corpus, phase: str, pos_len: int, neg_len: int,
                      history_max: int = 0) -> Dict[str, np.ndarray]:
    """Group the phase's rows into fixed-shape impressions.

    Reference ``_append_impression_info`` (ImpressionReader.py:52-121):
    rows sharing (user_id, time) form one impression; positives are the
    label-1 items, negatives the others; impressions lacking either side
    are dropped. Item lists are deduplicated in order; lengths are clipped
    to pos_len / neg_len (BaseImpressionModel.Dataset:176-179).

    With ``history_max`` > 0 the per-user stream of POSITIVE interactions
    across all phases (time-ascending) supplies ``history_items`` /
    ``history_times`` of items strictly earlier than the impression time,
    and the NEGATIVE stream likewise ``neg_history_items`` /
    ``neg_history_times`` / ``neg_lengths`` (ImpressionSeqReader.py:18-57,
    BaseImpressionModel.py:237-253).
    """
    df = corpus.data_df[phase]
    if "label" not in df:
        raise ValueError("impression data must have binary labels "
                         "(ImpressionReader.py:41) — use the *_CTR dataset")

    streams: Dict[str, Dict[int, tuple]] = {"": {}, "neg_": {}}
    if history_max > 0:
        cols = ("user_id", "item_id", "time", "label")
        all_df = {c: np.concatenate([np.asarray(corpus.data_df[k][c])
                                     for k in ("train", "dev", "test")])
                  for c in cols}
        order = np.lexsort([all_df["time"], all_df["user_id"]])
        all_df = {c: v[order] for c, v in all_df.items()}
        for prefix, positive in (("", True), ("neg_", False)):
            sel = (all_df["label"] == 1) == positive
            users, items = all_df["user_id"][sel], all_df["item_id"][sel]
            times = all_df["time"][sel]
            for rows in _first_seen_groups(users):
                streams[prefix][int(users[rows[0]])] = (items[rows],
                                                        times[rows])

    users, times, pos_items, neg_items, pos_num, neg_num = \
        [], [], [], [], [], []
    label, item = np.asarray(df["label"]), np.asarray(df["item_id"])
    for rows in _first_seen_groups(df["user_id"], df["time"]):
        is_pos = label[rows] == 1
        pos = _unique_in_order(item[rows][is_pos])
        neg = _unique_in_order(item[rows][~is_pos])
        if len(pos) == 0 or len(neg) == 0:
            continue
        users.append(int(df["user_id"][rows[0]]))
        times.append(int(df["time"][rows[0]]))
        p = np.zeros(pos_len, np.int32)
        p[:min(len(pos), pos_len)] = pos[:pos_len]
        n = np.zeros(neg_len, np.int32)
        n[:min(len(neg), neg_len)] = neg[:neg_len]
        pos_items.append(p)
        neg_items.append(n)
        pos_num.append(min(len(pos), pos_len))
        neg_num.append(min(len(neg), neg_len))

    R = len(users)
    data = {
        "user_id": np.asarray(users, np.int32),
        "time": np.asarray(times, np.int64),
        "item_id": np.concatenate(
            [np.stack(pos_items) if R else np.zeros((0, pos_len), np.int32),
             np.stack(neg_items) if R else np.zeros((0, neg_len), np.int32)],
            axis=1),
        "pos_num": np.asarray(pos_num, np.int32),
        "neg_num": np.asarray(neg_num, np.int32),
    }
    if history_max > 0:
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        for prefix, stream in streams.items():
            his = np.zeros((R, history_max), np.int32)
            his_t = np.zeros((R, history_max), np.int64)
            lengths = np.zeros(R, np.int32)
            for i in range(R):
                its, tts = stream.get(int(data["user_id"][i]), empty)
                # the stream is time-ascending: the strictly earlier
                # interactions are a prefix of it
                k = int(np.searchsorted(tts, data["time"][i], side="left"))
                lo = max(0, k - history_max)
                lengths[i] = k - lo
                his[i, :k - lo] = its[lo:k]
                his_t[i, :k - lo] = tts[lo:k]
            data[f"{prefix}history_items"] = his
            data[f"{prefix}history_times"] = his_t
            data[f"{prefix}lengths"] = lengths
    return data


def impression_targets(pos_num: np.ndarray, neg_num: np.ndarray,
                       pos_len: int, neg_len: int) -> np.ndarray:
    """{1 pos, 0 neg, -1 pad} labels (ImpressionRunner.py:187-190)."""
    pos = 2 * (np.arange(pos_len)[None, :] < pos_num[:, None]).astype(
        np.int32) - 1
    neg = (np.arange(neg_len)[None, :] < neg_num[:, None]).astype(
        np.int32) - 1
    return np.concatenate([pos, neg], axis=1)


class ImpressionFeedBuilder:
    """Fixed-shape impression batches; the final batch wrap-pads real
    rows. The numpy ``Generator`` (the shuffle) is the JAX builder's."""

    def __init__(self, corpus, phase: str, pos_len: int = 20,
                 neg_len: int = 20, history_max: int = 0, seed: int = 0):
        self.corpus = corpus
        self.phase = phase
        self.pos_len = pos_len
        self.neg_len = neg_len
        self.history_max = history_max
        self.data = build_impressions(corpus, phase, pos_len, neg_len,
                                      history_max)
        self.rng = np.random.default_rng(seed)
        self.task = "impression"

    def __len__(self):
        return len(self.data["user_id"])

    def actions_before_epoch(self):  # negatives are pre-defined (:199-211)
        pass

    def batches(self, batch_size: int,
                shuffle: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self)
        order = np.arange(n)
        if shuffle:
            self.rng.shuffle(order)
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            row_mask = np.ones(batch_size, bool)
            if len(idx) < batch_size:
                row_mask[len(idx):] = False
                extra = order[np.arange(batch_size - len(idx)) % max(n, 1)]
                idx = np.concatenate([idx, extra])
            feed = {k: v[idx] for k, v in self.data.items()}
            feed["target"] = impression_targets(
                feed["pos_num"], feed["neg_num"], self.pos_len, self.neg_len)
            feed["row_mask"] = row_mask
            yield feed


# ---------------------------------------------------------------------------
# Listwise metrics (ImpressionRunner.py:18-133)

def _hr_at_k(labels, valid_num, k):
    """ImpressionRunner.py:18-30."""
    ind = np.arange(labels.shape[1]) < valid_num[:, None]
    labels = labels * ind
    num_hits = labels[:, :k].sum(1)
    positive_num = labels.sum(1)
    positive_num[positive_num == 0] = 1
    positive_num[positive_num > k] = k
    hr = num_hits / positive_num
    hr[hr > 0] = 1
    return hr


def _dcg_at_k(labels, k):
    labels = labels[:, :k]
    return (labels / np.log2(np.arange(2, labels.shape[1] + 2))).sum(1)


def _ndcg_at_k(labels, valid_num, k):
    """ImpressionRunner.py:39-51."""
    ind = np.arange(labels.shape[1]) < valid_num[:, None]
    labels = labels * ind
    dcg = _dcg_at_k(labels, k)
    ideal = _dcg_at_k(np.sort(labels, axis=1)[:, ::-1], k)
    ideal[ideal == 0] = 1
    return dcg / ideal


def _ap_at_k(labels, valid_num, k):
    """ImpressionRunner.py:53-66."""
    ind = np.arange(labels.shape[1]) < valid_num[:, None]
    labels = labels * ind
    cum = np.cumsum(labels, axis=1).astype(np.float64)
    cum[:, k:] = 0
    precision = cum / np.arange(1, labels.shape[1] + 1)
    positive_num = labels.sum(1)
    positive_num[positive_num == 0] = 1
    positive_num[positive_num > k] = k
    return (precision * labels).sum(1) / positive_num


def evaluate_impressions(predictions: np.ndarray, pos_num: np.ndarray,
                         neg_num: np.ndarray, pos_len: int, topk,
                         metrics=("NDCG", "MAP", "HR")):
    """ImpressionRunner.evaluate_method (:74-133).

    ``predictions`` must already be -inf at padded candidate slots. The eps
    subtraction on the positive block makes equal-scoring positives rank
    BELOW negatives (:89-94); mergesort keeps the remaining order stable."""
    preds = predictions - 1e-6 * (np.arange(predictions.shape[1])[None, :]
                                  < pos_len)
    sort_idx = (-preds).argsort(axis=1, kind="mergesort")
    pos_cliped = np.minimum(pos_num, pos_len)
    neg_cliped = np.minimum(neg_num, predictions.shape[1] - pos_len)
    whole_len = pos_cliped + neg_cliped
    labels = (np.arange(pos_len)[None, :]
              < pos_cliped[:, None]).astype(int)
    pad = np.zeros((labels.shape[0], predictions.shape[1] - pos_len), int)
    labels = np.concatenate([labels, pad], axis=1)
    labels = np.take_along_axis(labels, sort_idx, axis=1)
    out = {}
    fns = {"NDCG": _ndcg_at_k, "MAP": _ap_at_k, "HR": _hr_at_k}
    for m in metrics:
        for k in topk:
            out[f"{m}@{k}"] = float(fns[m](labels, whole_len, k).mean())
    return out


# ---------------------------------------------------------------------------
# Base rankers ({BPRMF,SASRec}Impression: general/BPRMF.py:34-46,65-80 and
# sequential/SASRec.py forward over impression feeds); each returns
# (scores, u_v, i_v, his_v)

class BPRMFImpressionRanker(nn.Module):
    """BPRMFBase.forward (general/BPRMF.py:34-46): dot-product scores,
    u_v = user vector broadcast per candidate, i_v = item vectors, his_v
    the history's item vectors (None without a history)."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64):
        super().__init__()
        self.u_embeddings = nn.Embedding(user_num, emb_size)
        self.i_embeddings = nn.Embedding(item_num, emb_size)

    def forward(self, feed, generator=None):
        u_v1 = self.u_embeddings(feed["user_id"].long())
        i_v = self.i_embeddings(feed["item_id"].long())
        scores = (u_v1[:, None, :] * i_v).sum(-1)
        u_v = u_v1[:, None, :].expand(i_v.shape)
        his_v = (self.i_embeddings(feed["history_items"].long())
                 if "history_items" in feed else None)
        return scores, u_v, i_v, his_v


class SASRecImpressionRanker(nn.Module):
    """SASRecImpression (sequential/SASRec.py:110-128): causal transformer
    over the positive history; u_v = the sequence vector broadcast."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 num_layers: int = 1, num_heads: int = 4,
                 history_max: int = 20):
        super().__init__()
        self.history_max, self.num_layers = history_max, num_layers
        self.i_embeddings = nn.Embedding(item_num, emb_size)
        self.p_embeddings = nn.Embedding(history_max + 1, emb_size)
        for b in range(num_layers):
            self.add_module(f"block_{b}", TransformerBlock(
                emb_size, emb_size, num_heads, 0.0))

    def forward(self, feed, generator=None):
        his_ids = feed["history_items"].long()
        lengths = feed["lengths"].long()
        B, L = his_ids.shape
        ar = torch.arange(L, device=his_ids.device)
        valid = ar[None, :] < lengths[:, None]
        # position counts back from the sequence end (SASRec.py:59-62)
        position = (lengths[:, None] - ar[None, :] - 1) * valid.long()
        x = self.i_embeddings(his_ids) + self.p_embeddings(
            torch.clamp(position, 0, self.history_max))
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=x.device))
        attn_mask = causal[None, None] & valid[:, None, None, :]
        for b in range(self.num_layers):
            x = getattr(self, f"block_{b}")(x, attn_mask)
        x = x * valid[:, :, None].to(x.dtype)
        idx = torch.clamp(lengths - 1, 0, L - 1)
        his_vector = x[torch.arange(B, device=x.device), idx]
        i_v = self.i_embeddings(feed["item_id"].long())
        scores = (his_vector[:, None, :] * i_v).sum(-1)
        u_v = his_vector[:, None, :].expand(i_v.shape)
        return scores, u_v, i_v, self.i_embeddings(his_ids)


IMPRESSION_RANKERS = {
    "BPRMF": BPRMFImpressionRanker,
    "SASRec": SASRecImpressionRanker,
}


# ---------------------------------------------------------------------------
# Shared reranker plumbing (BaseRerankerModel.py:68-84 collate)

def _slot_valid(pos_num, neg_num, pos_len, cand_len):
    ar = torch.arange(cand_len, device=pos_num.device)[None, :]
    return torch.where(ar < pos_len, ar < pos_num.long()[:, None],
                       (ar - pos_len) < neg_num.long()[:, None])


def _rank_positions(scores):
    """position = double argsort of descending scores (:80-81), stable as
    ``jnp.argsort`` is."""
    order = torch.argsort(-scores, dim=1, stable=True)
    return torch.argsort(order, dim=1, stable=True)


def _run_ranker(model, feed, generator):
    """The reranker's ranker outputs, detached unless ``tuneranker``
    (BaseRerankerModel.py:64-66)."""
    out = model.ranker(feed, generator=generator)
    if not model.tuneranker:
        out = tuple(None if o is None else o.detach() for o in out)
    return out


class MAB(nn.Module):
    """SetRank.py:29-56 MAB: torch-MHA (with out_proj) + post-LN FFN."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int = 128,
                 dropout: float = 0.0):
        super().__init__()
        self.n_heads, self.dropout = n_heads, dropout
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, nn.Linear(d_model, d_model))
        self.norm1 = layer_norm(d_model)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm2 = layer_norm(d_model)

    def forward(self, q, k, v, key_pad, generator=None):
        B, Lq, D = q.shape
        Lk = k.shape[1]
        H = self.n_heads
        dk = D // H

        def split(t, L):
            return t.reshape(B, L, H, dk).transpose(1, 2)
        qh = split(self.q_proj(q), Lq)
        kh = split(self.k_proj(k), Lk)
        vh = split(self.v_proj(v), Lk)
        scores = qh @ kh.transpose(-1, -2) / math.sqrt(dk)
        keep = (torch.ones_like(scores, dtype=torch.bool) if key_pad is None
                else ~key_pad[:, None, None, :])
        probs = masked_softmax(scores, keep)
        ctx = (probs @ vh).transpose(1, 2).reshape(B, Lq, D)
        ctx = self.out_proj(ctx)
        x = self.norm1(q + dropout(ctx, self.dropout, generator))
        ff = self.linear2(dropout(F.relu(self.linear1(x)), self.dropout,
                                  generator))
        return self.norm2(x + dropout(ff, self.dropout, generator))


class PRMModel(nn.Module):
    """PRM (reranker/PRM.py:29-97): candidates + ranker PV vectors +
    ordinal position embedding (of the ranker-score rank) through
    transformer encoder blocks to a scalar score per slot."""

    def __init__(self, item_num: int, ranker: nn.Module,
                 ranker_emb_size: int, pos_len: int = 20, neg_len: int = 20,
                 emb_size: int = 64, n_blocks: int = 4, num_heads: int = 4,
                 num_hidden_unit: int = 64, dropout: float = 0.0,
                 tuneranker: bool = False):
        super().__init__()
        self.pos_len, self.n_blocks = pos_len, n_blocks
        self.tuneranker = tuneranker
        C = pos_len + neg_len
        self.ranker = ranker
        self.i_embeddings = nn.Embedding(item_num, emb_size)
        self.ordinal_position_embedding = nn.Embedding(
            C, emb_size + 2 * ranker_emb_size)
        self.rFF0 = nn.Linear(emb_size + 2 * ranker_emb_size,
                              num_hidden_unit)
        for b in range(n_blocks):
            self.add_module(f"encoder_{b}", MAB(num_hidden_unit, num_heads,
                                                128, dropout))
        self.rFF1 = nn.Linear(num_hidden_unit, 1)

    def forward(self, feed, generator=None):
        gen = _gen(self, generator)
        scores, u_v, i_v, _ = _run_ranker(self, feed, gen)
        C = feed["item_id"].shape[1]
        valid = _slot_valid(feed["pos_num"], feed["neg_num"], self.pos_len,
                            C)
        position = _rank_positions(torch.where(valid, scores,
                                               torch.full_like(scores,
                                                               -torch.inf)))
        i_vec = self.i_embeddings(feed["item_id"].long())
        di = torch.cat([i_vec, u_v, i_v], dim=2)
        pi = self.ordinal_position_embedding(position)
        # positionafter=0 (PRM.py:48,81-83): add position BEFORE rFF0
        x = self.rFF0(di + pi)
        for b in range(self.n_blocks):
            x = getattr(self, f"encoder_{b}")(x, x, x, ~valid, gen)
        return self.rFF1(x)[..., 0]


class SetRankModel(nn.Module):
    """SetRank (reranker/SetRank.py:82-156): MSAB or IMSAB blocks (induced
    set attention with 20 inducing points ``I_{b}``, :67-80);
    positionafter=1 adds the position embedding AFTER rFF0
    (:104,143-145)."""

    def __init__(self, item_num: int, ranker: nn.Module,
                 ranker_emb_size: int, pos_len: int = 20, neg_len: int = 20,
                 emb_size: int = 64, n_blocks: int = 4, num_heads: int = 4,
                 num_hidden_unit: int = 64, setrank_type: str = "IMSAB",
                 m_clusters: int = 20, dropout: float = 0.0,
                 tuneranker: bool = False):
        super().__init__()
        self.pos_len, self.n_blocks = pos_len, n_blocks
        self.setrank_type, self.tuneranker = setrank_type, tuneranker
        C = pos_len + neg_len
        self.ranker = ranker
        self.i_embeddings = nn.Embedding(item_num, emb_size)
        self.rFF0 = nn.Linear(emb_size + 2 * ranker_emb_size,
                              num_hidden_unit)
        self.ordinal_position_embedding = nn.Embedding(C, num_hidden_unit)
        for b in range(n_blocks):
            if setrank_type == "MSAB":
                self.add_module(f"encoder_{b}", MAB(
                    num_hidden_unit, num_heads, 128, dropout))
            else:
                normal_param(self, f"I_{b}", (m_clusters, num_hidden_unit),
                             0.01)
                for s in ("mab1", "mab2"):
                    self.add_module(f"encoder_{b}_{s}", MAB(
                        num_hidden_unit, num_heads, 128, dropout))
        self.rFF1 = nn.Linear(num_hidden_unit, 1)

    def forward(self, feed, generator=None):
        gen = _gen(self, generator)
        scores, u_v, i_v, _ = _run_ranker(self, feed, gen)
        C = feed["item_id"].shape[1]
        valid = _slot_valid(feed["pos_num"], feed["neg_num"], self.pos_len,
                            C)
        position = _rank_positions(torch.where(valid, scores,
                                               torch.full_like(scores,
                                                               -torch.inf)))
        i_vec = self.i_embeddings(feed["item_id"].long())
        di = torch.cat([i_vec, u_v, i_v], dim=2)
        x = self.rFF0(di) + self.ordinal_position_embedding(position)
        key_pad = ~valid
        B = x.shape[0]
        for b in range(self.n_blocks):
            if self.setrank_type == "MSAB":
                x = getattr(self, f"encoder_{b}")(x, x, x, key_pad, gen)
            else:  # IMSAB (SetRank.py:67-80)
                inducing = getattr(self, f"I_{b}")
                I_r = inducing[None].expand(B, *inducing.shape)
                h = getattr(self, f"encoder_{b}_mab1")(I_r, x, x, key_pad,
                                                       gen)
                x = getattr(self, f"encoder_{b}_mab2")(x, h, h, None, gen)
        return self.rFF1(x)[..., 0]


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: gates i, f, g, o from the input's
    bias-free Dense (``ii``, ``if``, ``ig``, ``io``) plus the hidden
    state's Dense with a bias (``hi``...); c' = f c + i g, h' = o tanh(c')."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in self.GATES:
            self.add_module(f"i{g}", nn.Linear(input_size, hidden,
                                               bias=False))
            self.add_module(f"h{g}", nn.Linear(hidden, hidden))

    def forward(self, x: torch.Tensor, reverse: bool = False):
        """(B, L, input) -> (B, L, hidden), from zero state; ``reverse``
        runs from the last step and returns the outputs in the input's
        order (``nn.RNN(reverse=True, keep_order=True)``)."""
        mods = [getattr(self, f"i{g}") for g in self.GATES]
        hmods = [getattr(self, f"h{g}") for g in self.GATES]
        w_i = torch.cat([m.weight for m in mods], 0)
        w_h = torch.cat([m.weight for m in hmods], 0)
        b_h = torch.cat([m.bias for m in hmods], 0)
        xi = x @ w_i.t()
        B, L, _ = x.shape
        h = x.new_zeros(B, self.hidden)
        c = x.new_zeros(B, self.hidden)
        out = [None] * L
        for t in (range(L - 1, -1, -1) if reverse else range(L)):
            z = h @ w_h.t() + b_h
            zi, zf, zg, zo = (z + xi[:, t]).split(self.hidden, dim=-1)
            c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
            h = torch.sigmoid(zo) * torch.tanh(c)
            out[t] = h
        return torch.stack(out, 1)


class MIRModel(nn.Module):
    """MIR (reranker/MIR.py:19-180): intra-set attention over candidates,
    BiLSTM over the (positive) history, and set-to-list SLAttention with a
    learned per-user time-decay on the affinity matrix."""

    def __init__(self, item_num: int, ranker: nn.Module,
                 ranker_emb_size: int, pos_len: int = 20, neg_len: int = 20,
                 emb_size: int = 64, num_heads: int = 4,
                 num_hidden_unit: int = 64, dropout: float = 0.0,
                 tuneranker: bool = False):
        super().__init__()
        self.pos_len, self.dropout = pos_len, dropout
        self.tuneranker = tuneranker
        E, Er, H = emb_size, ranker_emb_size, num_hidden_unit
        self.ranker = ranker
        self.i_embeddings = nn.Embedding(item_num, E)
        self.intra_set = MAB(E + Er, num_heads, 128, dropout)
        self.OptimizedLSTMCell_0 = LSTMCell(E + Er, H)
        self.OptimizedLSTMCell_1 = LSTMCell(E + Er, H)
        v_dim, q_dim = 2 * (E + Er), (E + Er) + 2 * H
        normal_param(self, "w_b", (q_dim, v_dim), 0.01)
        normal_param(self, "w_v", (v_dim, 1), 0.01)
        normal_param(self, "w_q", (q_dim, 1), 0.01)
        self.fc_decay1 = nn.Linear(Er, 32)
        self.fc_decay2 = nn.Linear(32, 1)
        d = (E + Er) + v_dim + q_dim
        for units, name in ((500, "fc1"), (200, "fc2"), (80, "fc3")):
            self.add_module(name, nn.Linear(d, units))
            d = units
        self.fc4 = nn.Linear(d, 1)

    def forward(self, feed, generator=None):
        gen = _gen(self, generator)
        scores, u_v, i_v_r, his_v_r = _run_ranker(self, feed, gen)
        C = feed["item_id"].shape[1]
        valid = _slot_valid(feed["pos_num"], feed["neg_num"], self.pos_len,
                            C)
        i_v = torch.cat([self.i_embeddings(feed["item_id"].long()), i_v_r],
                        dim=2)
        his_ids = feed["history_items"].long()
        his_v = torch.cat([self.i_embeddings(his_ids), his_v_r], dim=2)
        seq_v = u_v[:, 0, :]

        # intra-set MHA over candidates (MIR.py:140-149); masked rows zeroed
        attn_i = self.intra_set(i_v, i_v, i_v, ~valid, gen)
        attn_i = attn_i * valid[:, :, None].to(attn_i.dtype)
        seq = torch.cat([i_v, attn_i], dim=2)              # [B, C, 2(E+Er)]

        # intra-list BiLSTM over history (MIR.py:153-157)
        bilstm_his = torch.cat([self.OptimizedLSTMCell_0(his_v),
                                self.OptimizedLSTMCell_1(his_v,
                                                         reverse=True)], -1)
        usr_seq = torch.cat([bilstm_his, his_v], dim=2)

        # time interval transform (MIR.py:161-167)
        ht = feed["history_times"].to(seq.dtype)
        times = (ht > 0).to(seq.dtype)
        tmax = ht.max(1, keepdim=True).values - ht
        tmax = torch.log2(tmax + 1)
        tmax = tmax + tmax.max(1, keepdim=True).values + 1

        # SLAttention (MIR.py:19-79)
        c1 = (usr_seq @ self.w_b) @ seq.transpose(1, 2)     # [B, L, C]
        theta = leaky_relu(self.fc_decay2(leaky_relu(self.fc_decay1(seq_v))))
        pos = (tmax * times)[:, :, None]
        decay = torch.exp(-theta[:, :, None] * pos)
        c = torch.tanh(c1 * decay + c1)
        B = seq.shape[0]
        hv_1 = (seq @ self.w_v).expand(B, C, C)
        hq_1 = (usr_seq @ self.w_q).expand(B, usr_seq.shape[1], C) \
            .transpose(1, 2)                                 # [B, C, L]
        h_v = torch.tanh(hv_1 + hq_1 @ c)
        h_q = torch.tanh(hq_1 + hv_1 @ c.transpose(1, 2))
        v = torch.softmax(h_v, dim=-1) @ seq
        q = torch.softmax(h_q, dim=-1) @ usr_seq
        final = torch.cat([i_v, v, q], dim=2)
        # flax LayerNorm(use_bias=False, use_scale=False), epsilon 1e-6
        final = F.layer_norm(final, final.shape[-1:], eps=1e-6)
        for name in ("fc1", "fc2", "fc3"):
            final = dropout(F.relu(getattr(self, name)(final)),
                            self.dropout, gen)
        return self.fc4(final)[..., 0]


RERANKERS = {"PRM": PRMModel, "SetRank": SetRankModel, "MIR": MIRModel}


# ---------------------------------------------------------------------------
# Runner (ImpressionRunner.py:68-197)

class ImpressionRunner(RankingRunner):
    """The JAX package's ``make_impression_runner``: listwise train / eval
    over impression feeds with RankingRunner's steps, optimizer and early
    stop, the loss ``IMPRESSION_LOSSES[loss_n]`` over the {1, 0, -1}
    target (ImpressionRunner.fit :173-197) and ``evaluate_impressions``.
    A bare ranker's forward is (scores, u_v, i_v, his_v): its scores are
    taken."""
    task = "impression"

    def __init__(self, model: nn.Module, cfg, pos_len: int, neg_len: int,
                 device=None):
        super().__init__(model, cfg, device=device)
        self.pos_len, self.neg_len = pos_len, neg_len

    def _forward(self, batch, generator=None):
        out = self.model(batch, generator=generator)
        if isinstance(out, tuple):
            out = out[0]
        return out, {}

    def _loss(self, predictions, batch):
        return IMPRESSION_LOSSES[self.cfg.loss_n](
            predictions, batch["target"], self.pos_len)

    def predict(self, builder, state=None):
        self.load(state)
        preds, pos_nums, neg_nums = [], [], []
        for feed in builder.batches(self.cfg.eval_batch_size,
                                    shuffle=False):
            keep = feed["row_mask"]
            preds.append(self.eval_scores(feed)[keep])
            pos_nums.append(feed["pos_num"][keep])
            neg_nums.append(feed["neg_num"][keep])
        return (np.concatenate(preds), np.concatenate(pos_nums),
                np.concatenate(neg_nums))

    def evaluate(self, builder, state=None, topk=None, metrics=None):
        predictions, pos_num, neg_num = self.predict(builder, state)
        C = predictions.shape[1]
        ar = np.arange(C)[None, :]
        valid = np.where(ar < self.pos_len, ar < pos_num[:, None],
                         (ar - self.pos_len) < neg_num[:, None])
        predictions = np.where(valid, predictions, -np.inf)
        return evaluate_impressions(
            predictions, pos_num, neg_num, self.pos_len, topk or self.topk,
            metrics or self.metrics)

    def load_ranker(self, path: str):
        """Absorb a pretrained base ranker (a ``.pt`` state_dict of the
        port's, or the JAX runner's ``.msgpack`` params) into the
        reranker's ``ranker``: the entries of the same name and shape
        (BaseRerankerModel.load_ranker :40-66), then a fresh optimizer."""
        ranker = getattr(self.model, "ranker", None)
        if ranker is None:
            raise KeyError("model has no nested ranker")
        own = ranker.state_dict()
        if path.endswith(".msgpack"):
            with open(path, "rb") as f:
                loaded = segrec_state_dict(ranker, msgpack_restore(f.read()),
                                           partial=True)
        else:
            loaded = torch.load(path, map_location="cpu", weights_only=True)
            loaded = {k: v for k, v in loaded.items()
                      if k in own and own[k].shape == v.shape}
        with torch.no_grad():
            for k, v in loaded.items():
                own[k].copy_(v)
        self.optimizer = self._build_optimizer()
        logger.info("Load ranker from %s (%d of %d entries)", path,
                    len(loaded), len(own))
