"""Knowledge-aware ReChorus family (port of ``segmminterest_tpu/segrec/kg.py``):
CFKG, SLRCPlus, Chorus, KDA, their metadata, feeds, losses and Chorus's
runner.

Behavioral spec: reference SkipPredBaseline/ReChorus/src/...:
 * helpers/KGReader.py:31-73 — item_meta.csv r_* columns become
   (head, relation, tail) triplets (relation 0 reserved for the virtual
   buy/self relation); with include_attr the i_* attribute columns add
   attribute entities stacked after the items plus share_attr_dict;
 * helpers/KDAReader.py:26-106 — per-relation time-interval histograms,
   log2-normalized (norm_time :33-37), DFT'd (:26-31) into the initial
   frequency-domain decay representation freq_x;
 * models/general/CFKG.py — TransE scores over a joint user+entity graph,
   margin ranking loss over (pos, pos, neg-tail, neg-head) quadruples;
 * models/sequential/SLRCPlus.py — Hawkes base-intensity MF + per-relation
   excitation kernels (mixture of exponential + normal pdfs);
 * models/sequential/Chorus.py — stage 1 TransE pretrain over reversed
   relations, stage 2 relation-shifted item representations gated by
   relation-specific temporal kernels; KG params get a scaled lr
   (:179-196);
 * models/sequential/KDA.py — relational dynamic aggregation with
   inverse-DFT decay (:265-303), self-attention over the relation axis,
   DistMult KG task trained jointly (gamma-weighted, :178-190: returned in
   the model's ``losses`` as ``kda_kg``, which the runner adds).

No pandas: ``read_csv``, ``groupby`` (keys ascending), the left merge with
the item metadata (the interactions' order) and ``DataFrame.sample`` (a
``RandomState(seed).choice`` of row numbers) are reproduced with numpy.
The feeds' numpy ``Generator`` calls are the JAX builder's, in the same
order, so the negatives are the same bits. The relational intervals
(SLRCPlus.py:91-116, Chorus.py:230-239: for each candidate and relation,
the most recent history item linked to it) are computed for a whole batch
at once: a membership test of (history item, relation, candidate) keys in
the triplet set, the last match's time, the JAX builder's float64
arithmetic cast to float32 as it stores it.

As in the JAX models: KDA's ``attention - attention.max()`` is one max over
the whole batch; its masked softmax over the history puts -inf by
``torch.where`` and zero where a row has no history (NaN); its LayerNorms
are flax's (epsilon 1e-6); KDA's initial frequencies are
``kda_freq_init``'s complex128 cast to fp32 parameters (``freq_real``,
``freq_imag``), or drawn from N(0, 0.01) with ``--freq_rand 1``.
"""

from __future__ import annotations

import ast
import math
import os.path as osp
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.reader import groups, read_csv
from .feeds import FeedBuilder
from .layers import dropout, normal_param
from .models.sequential import layer_norm


def _relation_list(v) -> list:
    """A cell of an r_* column: a python-list string, or nothing."""
    if isinstance(v, str) and v:
        return ast.literal_eval(v)
    return []


# ---------------------------------------------------------------------------
# KG metadata (KGReader.py:31-73)

class KGMeta:
    def __init__(self, path: str, dataset: str, sep: str = "\t",
                 include_attr: bool = False, n_items: int = 0):
        meta_path = osp.join(path, dataset, "item_meta.csv")
        df = read_csv(meta_path, sep=sep)
        for c in df:
            if c.startswith("r_"):
                df[c] = [_relation_list(v) for v in df[c]]
        self.item_meta_df = df
        self.n_items = n_items

        self.item_relations = [c for c in df if c.startswith("r_")]
        if not self.item_relations:
            raise ValueError(
                f"{meta_path} has no r_* relation columns; regenerate with "
                "build_segrec_data --kg_meta 1 (KGReader.py requires them)")
        self.triplet_set = set()
        heads, relations, tails = [], [], []
        for idx in range(len(df["item_id"])):
            head_item = int(df["item_id"][idx])
            for r_idx, r in enumerate(self.item_relations):
                for tail_item in df[r][idx]:
                    heads.append(head_item)
                    tails.append(int(tail_item))
                    relations.append(r_idx + 1)  # 0 is the virtual relation
                    self.triplet_set.add((head_item, r_idx + 1,
                                          int(tail_item)))

        self.attr_relations: List[str] = []
        self.attr_max: List[int] = []
        self.share_attr_dict: Dict[int, list] = {}
        if include_attr:
            self.attr_relations = [c for c in df if c.startswith("i_")]
            for r_idx, attr in enumerate(self.attr_relations):
                base = n_items + int(np.sum(self.attr_max))
                relation_idx = len(self.item_relations) + r_idx + 1
                for item, val in zip(df["item_id"], df[attr]):
                    if val != 0:
                        heads.append(int(item))
                        tails.append(int(val + base))
                        relations.append(relation_idx)
                        self.triplet_set.add(
                            (int(item), relation_idx, int(val + base)))
                for val, rows in groups(df[attr]):
                    self.share_attr_dict[int(val + base)] = \
                        df["item_id"][rows].tolist()
                self.attr_max.append(int(df[attr].max()) + 1)

        self.relations = self.item_relations + self.attr_relations
        self.relation_df = {"head": np.asarray(heads, np.int64),
                            "relation": np.asarray(relations, np.int64),
                            "tail": np.asarray(tails, np.int64)}
        self.n_relations = len(self.relations) + 1
        self.n_entities = int(max(
            [n_items] + heads + tails)) + 1 if heads else n_items
        # head -> {(relation, tail)} for fast interval lookups
        self.head_index: Dict[int, set] = {}
        for h, r, t in self.triplet_set:
            self.head_index.setdefault(h, set()).add((r, t))


def norm_time(a, t_scalar: int) -> np.ndarray:
    """KDAReader.norm_time (:33-37)."""
    norm_t = np.log2(np.asarray(a, np.float64) / t_scalar + 1e-6)
    return np.maximum(norm_t, 0)


def kda_freq_init(corpus, kg: KGMeta, n_dft: int = 64, t_scalar: int = 60):
    """KDAReader._time_interval_cnt + _cal_freq_x (:53-106): per-relation
    time-interval distributions, log-binned, DFT'd with folded negative
    frequencies. Returns (freq_x complex (R, n_dft//2+1), n_dft).

    The interactions are ``corpus.all_df`` (train, dev, test) with each
    item's attribute values beside them (NaN for an item without
    metadata), walked by user ascending, rows in order; each relation's
    interval is the time since the user's most recent earlier interaction
    linked to the target by it."""
    interval_dict: Dict[str, list] = {"virtual": []}
    for rel in kg.relations:
        interval_dict[rel] = []

    meta = kg.item_meta_df
    all_df = corpus.all_df
    users, all_times, all_iids = (np.asarray(all_df["user_id"]),
                                  np.asarray(all_df["time"]),
                                  np.asarray(all_df["item_id"]))
    attr_vals = {}
    if kg.attr_relations:
        # the left merge on item_id: each row's item's values, NaN where
        # the metadata has no such item
        top = int(max(np.max(meta["item_id"]), np.max(all_iids)))
        row = np.full(top + 1, -1, np.int64)
        row[np.asarray(meta["item_id"], np.int64)] = np.arange(
            len(meta["item_id"]))
        at = row[all_iids]
        for attr in kg.attr_relations:
            col = np.asarray(meta[attr], np.float64)
            attr_vals[attr] = np.where(at >= 0, col[np.maximum(at, 0)],
                                       np.nan)
    # (relation, tail) -> the heads linked to it
    tail_index: Dict[tuple, set] = {}
    for h, r, t in kg.triplet_set:
        tail_index.setdefault((r, t), set()).add(h)
    for _, rows in groups(users):
        times, iids = all_times[rows], all_iids[rows]
        interval_dict["virtual"].extend(
            [t for t in (times[1:] - times[:-1]) if t > 0])
        for attr in kg.attr_relations:
            vals = attr_vals[attr][rows]
            keep = ~np.isnan(vals)
            for _, sub in groups(vals[keep]):
                dt = times[keep][sub]
                interval_dict[attr].extend(
                    [t for t in (dt[1:] - dt[:-1]) if t > 0])
        for r_idx, relation in enumerate(kg.item_relations):
            for target_idx in range(1, len(iids))[::-1]:
                target_i, target_t = iids[target_idx], times[target_idx]
                linked = tail_index.get((r_idx + 1, int(target_i)))
                if not linked:
                    continue
                for source_idx in range(target_idx)[::-1]:
                    delta_t = target_t - times[source_idx]
                    if delta_t > 0 and int(iids[source_idx]) in linked:
                        interval_dict[relation].append(delta_t)
                        break

    distributions = []
    for col in ["virtual"] + kg.relations:
        intervals = norm_time(interval_dict[col] or [1], t_scalar)
        bin_num = int(max(intervals.max(), 0)) + 1
        ns = np.zeros(bin_num)
        for inter in intervals:
            ns[int(inter)] += 1
        distributions.append(ns / max(ns.max(), 1))
        min_dft = 2 ** (int(np.log2(bin_num) + 1))
        n_dft = max(n_dft, min_dft)
    freq_x = np.empty((kg.n_relations, n_dft // 2 + 1), dtype=complex)
    for i, dist in enumerate(distributions):
        fx = np.fft.fft(dist, n_dft)
        freq_x[i] = 2 * fx[: n_dft // 2 + 1]
    return freq_x, n_dft


def _lookup_table(keys, values, width=None) -> np.ndarray:
    """A dense int64 table over the keys (rows of zeros elsewhere)."""
    keys = np.asarray(keys, np.int64)
    values = np.asarray(values, np.int64)
    shape = (int(keys.max()) + 1 if len(keys) else 1,)
    table = np.zeros(shape + values.shape[1:], np.int64)
    table[keys] = values
    return table


def _lookup(table, ids) -> np.ndarray:
    ids = np.asarray(ids, np.int64)
    inside = (ids >= 0) & (ids < len(table))
    out = table[np.where(inside, ids, 0)]
    if out.ndim > ids.ndim:
        return np.where(inside[..., None], out, 0)
    return np.where(inside, out, 0)


# ---------------------------------------------------------------------------
# KG feed builder

class KGFeedBuilder(FeedBuilder):
    """Ranking feeds augmented with the per-model KG inputs.

    kg_mode:
     * 'cfkg'       — train phase yields (head, tail, relation) quadruple
       batches over relation_df + interactions (CFKG.py:78-129); eval is the
       standard ranking feed recast as (user buy item) triples in-model.
     * 'chorus_kg'  — Chorus stage-1 pretrain quadruples over the REVERSED
       relation_df (Chorus.py:212-221).
     * 'slrc'       — + relational_interval with the slot-0 repeat-consumption
       gap (SLRCPlus.py:91-116).
     * 'chorus'     — + relational_interval (no slot 0) + category_id
       (Chorus.py:222-242).
     * 'kda'        — + item_val entity values, normalized history_delta_t,
       and per-row DistMult quadruples resampled per epoch
       (KDA.py:192-262).
    """

    def __init__(self, corpus, phase, kg: KGMeta, kg_mode: str,
                 time_scalar: int = 60 * 60 * 24 * 100,
                 category_col: str = "i_category",
                 t_scalar: int = 60, num_neg_kg: int = 1,
                 neg_head_p: float = 0.5, **kwargs):
        super().__init__(corpus, phase, **kwargs)
        self.kg = kg
        self.kg_mode = kg_mode
        self.time_scalar = time_scalar
        self.t_scalar = t_scalar
        self.num_neg_kg = num_neg_kg
        self.neg_head_p = neg_head_p
        self.relation_num = len(kg.item_relations) + 1

        df = kg.item_meta_df
        item_ids = np.asarray(df["item_id"]).astype(int)
        if category_col in df:
            self.item2cate = _lookup_table(
                item_ids, np.asarray(df[category_col]).astype(int))
            self.category_num = int(np.max(df[category_col])) + 1
        else:
            self.item2cate, self.category_num = None, 1

        # KDA item -> per-relation entity value (KDA.py:198-207)
        if kg_mode == "kda":
            vals = np.zeros((len(item_ids), kg.n_relations), np.int64)
            for idx, r in enumerate(kg.attr_relations):
                base = kg.n_items + int(np.sum(kg.attr_max[:idx]))
                vals[:, 1 + len(kg.item_relations) + idx] = \
                    np.asarray(df[r]).astype(int) + base
            self.item_val = _lookup_table(item_ids, vals)

        self._kg_train = (phase == "train"
                          and kg_mode in ("cfkg", "chorus_kg"))
        if self._kg_train:
            rel = kg.relation_df
            if kg_mode == "cfkg":
                self.kg_rows = {
                    "head": np.concatenate([rel["head"], self.user_id]),
                    "relation": np.concatenate(
                        [rel["relation"],
                         np.zeros(len(self.user_id), np.int64)]),
                    "tail": np.concatenate([rel["tail"], self.item_id])}
            else:
                self.kg_rows = dict(rel)
            self.neg_heads = np.zeros(len(self.kg_rows["head"]), int)
            self.neg_tails = np.zeros(len(self.kg_rows["head"]), int)
        if kg_mode in ("slrc", "chorus"):
            # the (head, relation, tail) keys of the item relations
            trip = np.asarray([t for t in kg.triplet_set
                               if 1 <= t[1] < self.relation_num],
                              np.int64).reshape(-1, 3)
            self._n_ent = max(kg.n_entities, corpus.n_items,
                              int(trip.max()) + 1 if len(trip) else 0) + 1
            self._trip_keys = self._key(trip[:, 0], trip[:, 1], trip[:, 2])

    def _key(self, h, r, t):
        return (np.asarray(h, np.int64) * (self.relation_num + 1)
                + r) * self._n_ent + np.asarray(t, np.int64)

    # -- lengths ---------------------------------------------------------
    def __len__(self):
        if self._kg_train:
            return len(self.kg_rows["head"])
        return super().__len__()

    # -- per-epoch sampling ---------------------------------------------
    def actions_before_epoch(self):
        if self._kg_train:
            self._sample_kg_negatives()
            return
        super().actions_before_epoch()
        if self.kg_mode == "kda" and self.phase == "train":
            self._sample_kda_kg()

    def _sample_kg_negatives(self):
        """CFKG.Dataset.actions_before_epoch (:114-129) / Chorus stage-1
        (:244-253): rejection-sample corrupted heads/tails."""
        kg, rng = self.kg, self.rng
        heads = self.kg_rows["head"]
        tails = self.kg_rows["tail"]
        rels = self.kg_rows["relation"]
        n_items = self.corpus.n_items
        hi = n_items if self.kg_mode == "chorus_kg" else \
            (kg.n_entities if kg.attr_relations else n_items)
        clicked = self.corpus.train_clicked_set
        for i in range(len(heads)):
            self.neg_tails[i] = rng.integers(1, n_items)
            if self.kg_mode == "cfkg" and rels[i] == 0:
                self.neg_heads[i] = rng.integers(1, self.corpus.n_users)
                while self.neg_tails[i] in clicked.get(heads[i], set()):
                    self.neg_tails[i] = rng.integers(1, n_items)
                while tails[i] in clicked.get(self.neg_heads[i], set()):
                    self.neg_heads[i] = rng.integers(1, self.corpus.n_users)
            else:
                self.neg_heads[i] = rng.integers(1, max(hi, 2))
                while (heads[i], rels[i], self.neg_tails[i]) \
                        in kg.triplet_set:
                    self.neg_tails[i] = rng.integers(1, max(hi, 2))
                while (self.neg_heads[i], rels[i], tails[i]) \
                        in kg.triplet_set:
                    self.neg_heads[i] = rng.integers(1, max(hi, 2))

    def _sample_kda_kg(self):
        """KDA.Dataset.generate_kg_data + neg sampling (:221-262). The
        relation rows are ``relation_df.sample(n, replace, random_state)``:
        ``RandomState(seed).choice`` of row numbers."""
        kg, rng = self.kg, self.rng
        n = super().__len__()
        rel = kg.relation_df
        replace = n > len(rel["head"])
        pick = np.random.RandomState(int(rng.integers(0, 2 ** 31 - 1))) \
            .choice(len(rel["head"]), size=n, replace=replace)
        vals = np.zeros(n, int)
        heads = rel["head"][pick].copy()
        tails = rel["tail"][pick].copy()
        rels = rel["relation"][pick]
        attr_sel = tails >= kg.n_items
        vals[attr_sel] = tails[attr_sel]
        for i in np.where(attr_sel)[0]:
            share = kg.share_attr_dict[int(tails[i])]
            tails[i] = share[rng.integers(len(share))]
        neg_heads = rng.integers(1, kg.n_items, size=(n, self.num_neg_kg))
        neg_tails = rng.integers(1, kg.n_items, size=(n, self.num_neg_kg))
        for i in range(n):
            item_item = tails[i] <= kg.n_items and not attr_sel[i]
            for j in range(self.num_neg_kg):
                if rng.random() < self.neg_head_p:
                    t = tails[i] if item_item else vals[i]
                    while (neg_heads[i][j], rels[i], t) in kg.triplet_set:
                        neg_heads[i][j] = rng.integers(1, kg.n_items)
                    neg_tails[i][j] = tails[i]
                else:
                    while True:
                        h = heads[i] if item_item else neg_tails[i][j]
                        t = neg_tails[i][j] if item_item else vals[i]
                        if (h, rels[i], t) not in kg.triplet_set:
                            break
                        neg_tails[i][j] = rng.integers(1, kg.n_items)
                    neg_heads[i][j] = heads[i]
        self._kda_kg = dict(head=heads, tail=tails, relation=rels,
                            value=vals, neg_heads=neg_heads,
                            neg_tails=neg_tails)

    # -- assembly --------------------------------------------------------
    def _kg_batch(self, idx, B):
        n_real = len(idx)

        def pad(a):
            if n_real == B:
                return a
            out = np.zeros((B,) + a.shape[1:], a.dtype)
            out[:n_real] = a
            return out

        heads = self.kg_rows["head"][idx]
        tails = self.kg_rows["tail"][idx]
        rels = self.kg_rows["relation"][idx]
        nh, nt = self.neg_heads[idx], self.neg_tails[idx]
        head_id = np.stack([heads, heads, heads, nh], 1)
        tail_id = np.stack([tails, tails, nt, tails], 1)
        if self.kg_mode == "chorus_kg":
            # reversed: the wanted relations are is_complement_of /
            # is_substitute_of (Chorus.py:219-221)
            head_id, tail_id = tail_id, head_id
        else:
            # CFKG entity indexing: users first, then entities (:98-109)
            head_id = np.where(rels[:, None] > 0,
                               head_id + self.corpus.n_users, head_id)
            tail_id = tail_id + self.corpus.n_users
        return {
            "head_id": pad(head_id.astype(np.int64)),
            "tail_id": pad(tail_id.astype(np.int64)),
            "relation_id": pad(np.repeat(rels[:, None], 4,
                                         1).astype(np.int64)),
            "row_mask": pad(np.ones(n_real, bool)),
        }

    def _relational_intervals(self, idx, items, with_repeat):
        """SLRCPlus.Dataset._get_feed_dict (:91-116) / Chorus (:230-239):
        per candidate, slot 0 the time since its last repeat in the history
        (with_repeat), slot r since the most recent history item h with
        (h, r, candidate) a triplet; -1 where there is none; in units of
        time_scalar."""
        n, I = items.shape
        R = self.relation_num
        out = np.full((n, I, R), -1.0, np.float32)
        if n == 0:
            return out
        L = self.hist_items.shape[1]
        hist = self.hist_items[idx]
        times = self.hist_times[idx]
        t = np.asarray(self.time)[idx]
        in_hist = np.arange(L)[None, :] < self.hist_len[idx][:, None]
        steps = np.arange(L)

        def latest(match):
            """(n, I, L) matches -> each candidate's latest slot, or -1."""
            match = match & in_hist[:, None, :]
            return np.where(match, steps, -1).max(-1)

        def put(r_idx, j):
            found = j >= 0
            jj = np.maximum(j, 0)
            gap = (t[:, None] - np.take_along_axis(times, jj, 1)) \
                / self.time_scalar
            out[..., r_idx] = np.where(found, gap, -1.0)

        if with_repeat:
            put(0, latest(hist[:, None, :] == items[:, :, None]))
        for r_idx in range(1, R):
            keys = self._key(hist[:, None, :], r_idx, items[:, :, None])
            put(r_idx, latest(np.isin(keys, self._trip_keys)))
        return out

    def _assemble(self, idx, B):
        if self._kg_train:
            return self._kg_batch(idx, B)
        feed = super()._assemble(idx, B)
        n_real = len(idx)
        items = feed["item_id"][:n_real]

        def pad(a):
            if n_real == B:
                return a
            out = np.zeros((B,) + a.shape[1:], a.dtype)
            out[:n_real] = a
            return out

        if self.kg_mode == "slrc":
            feed["relational_interval"] = pad(
                self._relational_intervals(idx, items, with_repeat=True))
        elif self.kg_mode == "chorus":
            feed["relational_interval"] = pad(
                self._relational_intervals(idx, items, with_repeat=False))
            cate = (_lookup(self.item2cate, items)
                    if self.item2cate is not None else np.zeros_like(items))
            feed["category_id"] = pad(cate.astype(np.int64))
        elif self.kg_mode == "kda":
            feed["item_val"] = pad(_lookup(self.item_val, items))
            feed["history_delta_t"] = pad(norm_time(
                np.maximum(feed["history_delta_t"][:n_real], 0),
                self.t_scalar).astype(np.float32))
            if self.phase == "train":
                d = self._kda_kg
                feed["head_id"] = pad(np.concatenate(
                    [d["head"][idx, None], d["neg_heads"][idx]],
                    1).astype(np.int64))
                feed["tail_id"] = pad(np.concatenate(
                    [d["tail"][idx, None], d["neg_tails"][idx]],
                    1).astype(np.int64))
                feed["relation_id"] = pad(d["relation"][idx].astype(
                    np.int64))
                feed["value_id"] = pad(d["value"][idx].astype(np.int64))
        return feed


# ---------------------------------------------------------------------------
# Models (each returns (scores, losses))

def _norm_pdf(x, mu, sigma):
    return torch.exp(-0.5 * ((x - mu) / sigma) ** 2) \
        / (sigma * math.sqrt(2 * math.pi))


def _exp_pdf(x, beta):
    return beta * torch.exp(-beta * x)


def _transe(e_emb, r_emb, head_ids, tail_ids, rel_ids):
    h, t, r = e_emb(head_ids.long()), e_emb(tail_ids.long()), \
        r_emb(rel_ids.long())
    return -((h + r - t) ** 2).sum(-1)


class CFKGModel(nn.Module):
    """CFKG (general/CFKG.py:28-76): TransE over users+entities."""

    def __init__(self, user_num: int, entity_num: int, relation_num: int,
                 emb_size: int = 64, margin: float = 0.0):
        super().__init__()
        self.user_num = user_num
        self.e_embeddings = nn.Embedding(user_num + entity_num, emb_size)
        self.r_embeddings = nn.Embedding(relation_num, emb_size)

    def forward(self, feed, feat_table=None, generator=None):
        if "head_id" in feed:
            return _transe(self.e_embeddings, self.r_embeddings,
                           feed["head_id"], feed["tail_id"],
                           feed["relation_id"]), {}
        # eval: (user, buy, item) with items shifted past users (:100-109)
        tail_ids = feed["item_id"].long() + self.user_num
        head_ids = feed["user_id"].long()[:, None].expand(tail_ids.shape)
        return _transe(self.e_embeddings, self.r_embeddings, head_ids,
                       tail_ids, torch.zeros_like(tail_ids)), {}


def cfkg_margin_loss(predictions, row_mask, margin):
    """nn.MarginRankingLoss(margin)(pos, neg, 1) over the (B, 4) quadruple
    layout (CFKG.py:70-76): pos = cols 0:2, neg = cols 2:4."""
    pos = predictions[:, :2]
    neg = predictions[:, 2:4]
    per = torch.clamp(-(pos - neg) + margin, min=0.0)
    rm = row_mask.to(predictions.dtype)[:, None]
    return (per * rm).sum() / torch.clamp(rm.sum() * 2.0, min=1.0)


class SLRCPlusModel(nn.Module):
    """SLRC+ (sequential/SLRCPlus.py:28-89): MF base intensity + Hawkes
    excitation with per-(item, relation) kernel mixtures."""

    def __init__(self, user_num: int, item_num: int, relation_num: int,
                 emb_size: int = 64):
        super().__init__()
        self.global_alpha = nn.Parameter(torch.zeros(()))
        for name in ("alphas", "pis", "mus", "betas", "sigmas"):
            self.add_module(name, nn.Embedding(item_num, relation_num))
        self.user_bias = nn.Embedding(user_num, 1)
        self.item_bias = nn.Embedding(item_num, 1)
        self.u_embeddings = nn.Embedding(user_num, emb_size)
        self.i_embeddings = nn.Embedding(item_num, emb_size)

    def forward(self, feed, feat_table=None, generator=None):
        i_ids = feed["item_id"].long()
        u_ids = feed["user_id"].long()
        r_int = feed["relational_interval"].to(self.global_alpha.dtype)
        alphas = self.global_alpha + self.alphas(i_ids)
        pis = self.pis(i_ids) + 0.5
        mus = self.mus(i_ids) + 1.0
        betas = torch.clamp(self.betas(i_ids) + 1.0, 1e-10, 10.0)
        sigmas = torch.clamp(self.sigmas(i_ids) + 1.0, 1e-10, 10.0)
        mask = (r_int >= 0).to(r_int.dtype)
        delta_t = r_int * mask
        decay = pis * _exp_pdf(delta_t, betas) \
            + (1 - pis) * _norm_pdf(delta_t, mus, sigmas)
        excitation = (alphas * decay * mask).sum(-1)
        u_bias = self.user_bias(u_ids)
        i_bias = self.item_bias(i_ids)[..., 0]
        base = (self.u_embeddings(u_ids)[:, None, :]
                * self.i_embeddings(i_ids)).sum(-1) + u_bias + i_bias
        return base + excitation, {}


class ChorusModel(nn.Module):
    """Chorus (sequential/Chorus.py:26-177): a stage-1 batch (``head_id``)
    scores TransE over the item table, a recommendation batch the
    relation-shifted, time-gated item vectors."""

    def __init__(self, user_num: int, item_num: int, relation_names: tuple,
                 category_num: int = 1, emb_size: int = 64,
                 margin: float = 1.0, stage: int = 2,
                 base_method: str = "BPR"):
        super().__init__()
        R = len(relation_names) + 1
        self.relation_names = tuple(relation_names)
        self.gmf = base_method.upper().strip() == "GMF"
        self.i_embeddings = nn.Embedding(item_num, emb_size)
        self.r_embeddings = nn.Embedding(R, emb_size)
        self.u_embeddings = nn.Embedding(user_num, emb_size)
        self.betas = nn.Embedding(category_num, R)
        self.sigmas = nn.Embedding(category_num, R)
        self.mus = nn.Embedding(category_num, R)
        self.user_bias = nn.Embedding(user_num, 1)
        self.item_bias = nn.Embedding(item_num, 1)
        self.prediction = nn.Linear(emb_size, 1, bias=False)

    def forward(self, feed, feat_table=None, generator=None):
        if "head_id" in feed:  # stage-1 KG pretrain batch (TransE, :155-166)
            return _transe(self.i_embeddings, self.r_embeddings,
                           feed["head_id"], feed["tail_id"],
                           feed["relation_id"]), {}
        u_ids = feed["user_id"].long()
        i_ids = feed["item_id"].long()
        c_ids = feed["category_id"].long()
        u_vec = self.u_embeddings(u_ids)
        i_vec = self.i_embeddings(i_ids)
        r_int = feed["relational_interval"].to(i_vec.dtype)
        betas = torch.clamp(self.betas(c_ids) + 1.0, 1e-10, 10.0)
        sigmas = torch.clamp(self.sigmas(c_ids) + 1.0, 1e-10, 10.0)
        mus = self.mus(c_ids) + 1.0
        mask = (r_int >= 0).to(r_int.dtype)
        dt = r_int * mask

        # relation-specific kernels (:100-120)
        decays = []
        for r_idx in range(len(self.relation_names) + 1):
            delta, beta = dt[:, :, r_idx], betas[:, :, r_idx]
            sigma, mu = sigmas[:, :, r_idx], mus[:, :, r_idx]
            name = self.relation_names[r_idx - 1] if r_idx > 0 else ""
            if r_idx > 0 and "complement" in name:
                decay = _norm_pdf(delta, 0.0, beta)
            elif r_idx > 0 and "substitute" in name:
                decay = -_norm_pdf(delta, 0.0, beta) \
                    + _norm_pdf(delta, mu, sigma)
            else:
                decay = _exp_pdf(delta, beta)
            decays.append(torch.clamp(decay, -1.0, 1.0))
        temporal_decay = torch.stack(decays, 2) * mask

        ri = i_vec[:, :, None, :] + self.r_embeddings.weight[None, None]
        chorus_vec = i_vec + (temporal_decay[..., None] * ri).sum(2)
        if self.gmf:
            return self.prediction(u_vec[:, None, :] * chorus_vec)[..., 0], {}
        u_bias = self.user_bias(u_ids)
        i_bias = self.item_bias(i_ids)[..., 0]
        return (u_vec[:, None, :] * chorus_vec).sum(-1) + u_bias + i_bias, {}


class KDAModel(nn.Module):
    """KDA (sequential/KDA.py:24-190,265-303). The DistMult KG objective is
    computed in the forward of a train batch (``head_id``), pre-weighted by
    gamma, and returned as the loss ``kda_kg``."""

    def __init__(self, user_num: int, item_num: int, entity_num: int,
                 relation_num: int, freq_dim: int,
                 freq_real_init=None, freq_imag_init=None,
                 emb_size: int = 64, num_layers: int = 1, num_heads: int = 1,
                 attention_size: int = 10, pooling: str = "average",
                 include_val: bool = True, gamma: float = 1.0,
                 dropout: float = 0.0):
        super().__init__()
        E, R = emb_size, relation_num
        self.num_layers, self.num_heads = num_layers, num_heads
        self.pooling, self.include_val = pooling, include_val
        self.gamma, self.dropout, self.freq_dim = gamma, dropout, freq_dim
        self.entity_embeddings = nn.Embedding(entity_num, E)
        self.relation_embeddings = nn.Embedding(R, E)
        for name, init in (("freq_real", freq_real_init),
                           ("freq_imag", freq_imag_init)):
            if init is None:
                normal_param(self, name, (R, freq_dim), 0.01)
            else:
                self.register_parameter(name, nn.Parameter(torch.from_numpy(
                    np.asarray(init, np.float32).copy())))
        self.user_embeddings = nn.Embedding(user_num, E)
        for layer in range(num_layers):
            for name in ("attn_q", "attn_k", "attn_v"):
                self.add_module(f"{name}_{layer}", nn.Linear(E, E,
                                                             bias=False))
            self.add_module(f"W1_{layer}", nn.Linear(E, E))
            self.add_module(f"W2_{layer}", nn.Linear(E, E))
            self.add_module(f"layer_norm_{layer}", layer_norm(E))
        if pooling == "attention":
            self.A = nn.Linear(E, attention_size)
            self.A_out = nn.Linear(attention_size, 1, bias=False)
        self.item_bias = nn.Embedding(item_num, 1)
        freqs = np.concatenate([np.linspace(0, 1, freq_dim) / 2.0,
                                -np.linspace(0, 1, freq_dim) / 2.0])
        # 2 pi times the frequencies in fp32, as the JAX model multiplies
        self.register_buffer("two_pi_freqs", torch.from_numpy(
            np.float32(2.0 * np.pi) * freqs.astype(np.float32)),
            persistent=False)

    def forward(self, feed, feat_table=None, generator=None):
        gen = generator if self.training else None
        e_emb, r_emb = self.entity_embeddings, self.relation_embeddings
        u_vec = self.user_embeddings(feed["user_id"].long())
        i_ids = feed["item_id"].long()
        i_vec = e_emb(i_ids)
        v_vec = e_emb(feed["item_val"].long())
        history = feed["history_item_id"].long()
        his_vec = e_emb(history)
        dtype = i_vec.dtype
        delta_t_n = feed["history_delta_t"].to(dtype)
        B, H = history.shape
        E, R = i_vec.shape[-1], self.freq_real.shape[0]

        # relational dynamic aggregation (:287-303)
        r_vectors = r_emb.weight
        if self.include_val:
            ri = (r_vectors[None, None] + v_vec) * i_vec[:, :, None, :]
        else:
            ri = r_vectors[None, None] * i_vec[:, :, None, :]
        attention = torch.einsum("bhe,bire->bihr", his_vec, ri)
        attention = attention - attention.max()
        valid = (history > 0)[:, None, :, None]
        attention = torch.where(valid, attention,
                                torch.full_like(attention, -torch.inf))
        attention = torch.softmax(attention, dim=-2)
        attention = torch.where(torch.isnan(attention),
                                torch.zeros_like(attention), attention)

        # inverse-DFT decay (:276-285), conjugate-symmetric fold
        x_real = torch.cat([self.freq_real, self.freq_real], -1)
        x_imag = torch.cat([self.freq_imag, -self.freq_imag], -1)
        w = self.two_pi_freqs.to(dtype) * delta_t_n[..., None]  # B, H, 2F
        real_part = torch.cos(w)[:, :, None, :] * x_real[None, None]
        imag_part = torch.sin(w)[:, :, None, :] * x_imag[None, None]
        decay = (real_part - imag_part).mean(-1) / 2.0          # B, H, R
        decay = torch.clamp(decay, 0, 1)[:, None] * valid.to(dtype)
        attention = attention * decay
        context = torch.einsum("bhe,bihr->bire", his_vec, attention)

        # self-attention over the relation axis (:128-137)
        I = i_ids.shape[1]
        x = context.reshape(B * I, R, E)
        heads = self.num_heads
        dk = E // heads

        def split(t):
            return t.reshape(B * I, R, heads, dk).transpose(1, 2)
        for layer in range(self.num_layers):
            residual = x
            q = split(getattr(self, f"attn_q_{layer}")(x))
            k = split(getattr(self, f"attn_k_{layer}")(x))
            v = split(getattr(self, f"attn_v_{layer}")(x))
            probs = torch.softmax((q @ k.transpose(-1, -2))
                                  / math.sqrt(dk), dim=-1)
            ctx = (probs @ v).transpose(1, 2).reshape(B * I, R, E)
            ctx = getattr(self, f"W2_{layer}")(
                F.relu(getattr(self, f"W1_{layer}")(ctx)))
            ctx = dropout(ctx, self.dropout, gen)
            x = getattr(self, f"layer_norm_{layer}")(residual + ctx)
        context = x.reshape(B, I, R, E)

        # pooling (:142-150)
        if self.pooling == "attention":
            query = context * u_vec[:, None, None, :]
            att = self.A_out(torch.tanh(self.A(query)))[..., 0]
            att = torch.softmax(att - att.max(), dim=-1)
            his_vector = (context * att[..., None]).sum(-2)
        elif self.pooling == "max":
            his_vector = context.max(-2).values
        else:
            his_vector = context.mean(-2)

        i_bias = self.item_bias(i_ids)[..., 0]
        prediction = ((u_vec[:, None, :] + his_vector) * i_vec).sum(-1) \
            + i_bias
        losses = {}
        if "head_id" in feed:   # train: joint DistMult objective (:160-190)
            h = e_emb(feed["head_id"].long())
            t = e_emb(feed["tail_id"].long())
            val = e_emb(feed["value_id"].long())
            rel = r_emb(feed["relation_id"].long())
            rv = (rel + val) if self.include_val else rel
            kg_pred = (h * rv[:, None, :] * t).sum(-1)
            pos, neg = kg_pred[:, 0], kg_pred[:, 1:]
            neg_softmax = torch.softmax(neg, dim=1)
            rm = feed["row_mask"].to(dtype)
            s = (torch.sigmoid(pos[:, None] - neg) * neg_softmax).sum(1)
            kg_loss = -(torch.log(torch.clamp(s, 1e-8, 1 - 1e-8)) * rm).sum() \
                / torch.clamp(rm.sum(), min=1)
            losses["kda_kg"] = self.gamma * kg_loss
        return prediction, losses


KG_MODELS = {"CFKG": CFKGModel, "SLRCPlus": SLRCPlusModel,
             "Chorus": ChorusModel, "KDA": KDAModel}


def make_chorus_runner(model, cfg, lr_scale: float, feat_table=None,
                       device=None):
    """Chorus's stage-2 runner (Chorus.customize_parameters :179-196):
    Adam whatever ``--optimizer``, in three groups: a parameter with
    "bias" anywhere in its name (user_bias, item_bias) at lr without
    weight decay, the pretrained KG tables (i_embeddings, r_embeddings) at
    lr * lr_scale, the rest at lr; ``--l2`` on the latter two."""
    from .runner import RankingRunner

    class ChorusRunner(RankingRunner):
        def _group(self, name: str) -> str:
            parts = name.split(".")
            if any("bias" in p for p in parts):
                return "bias"
            if any(p in ("i_embeddings", "r_embeddings") for p in parts):
                return "kg"
            return "main"

        def _decays(self, name: str) -> bool:
            return self._group(name) != "bias"

        def _build_optimizer(self):
            lr = self.cfg.lr
            rates = {"main": lr, "kg": lr * lr_scale, "bias": lr}
            groups_ = {k: [] for k in rates}
            for name, p in self.model.named_parameters():
                groups_[self._group(name)].append(p)
            return torch.optim.Adam([{"params": ps, "lr": rates[k]}
                                     for k, ps in groups_.items() if ps],
                                    lr=lr)

    return ChorusRunner(model, cfg, feat_table=feat_table, device=device)
