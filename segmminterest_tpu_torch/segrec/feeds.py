"""Fixed-shape feed construction for SegRec models (port of
``segmminterest_tpu/segrec/feeds.py``; host-only numpy).

Behavioral spec: reference SegRec/models/BaseModel.py (Dataset hierarchy
:111-412) and BaseContextModel.py (:15-184):
 * ranking train feeds: item_ids = [target] + num_neg sampled negatives,
   rejection-sampled outside the user's train clicked set (:292-300);
 * ranking eval feeds: [target] + the csv's fixed neg_items list;
 * CTR feeds: single item + binary label;
 * context features appended per feed (user/situation scalars, item vectors);
 * c_interest_weight: Task-1 logits looked up by "{uid}-{iid}-{time}" — all
   candidates share the target's slice unless an eval_neg_weight table is
   given (:242-288); missing keys fall back to ones;
 * item_frame_lines: per-candidate int32 line ids of the segment feature
   table (-1 where there is none), gathered on the device by the model.

Batches are numpy dicts of one static shape per phase (the final batch
padded, ``row_mask`` marks real rows), key for key and dtype for dtype the
JAX builder's; the numpy ``Generator`` calls are the JAX builder's, in the
same order, so negatives and shuffles are the same bits.

``neg_history`` (DIEN's auxiliary loss, on where ``--alpha_aux`` > 0)
draws one uniform negative per history slot of the train split each epoch,
never the positive there (DIEN.py:206-216), before the ranking negatives
and from the same generator, as the JAX builder does.

The sequential models' feeds:
 * ``augment_history`` (ContraRec, train split): two augmented views of
   each row's history, ``history_item_id_a`` / ``_b`` (Dataset.augment
   :108-135), drawn per row at batch time, view a then view b, each a
   ``beta`` then a ``random`` draw and then a ``shuffle`` or an
   ``integers`` one;
 * ``session_graph`` (SRGNN): each row's session graph, ``srgnn_items``,
   ``srgnn_A`` and ``srgnn_alias`` (SRGNN.py:42-76);
 * ``s3rec_pretrain`` (S3Rec stage 1, train split): the users' histories
   cut into ``history_max`` chunks, a batch of masked-item and segment
   views drawn per position and per segment (S3Rec.py:118-165), no
   candidates;
 * ``test_all`` (full-sort evaluation): [target] + every item id 1 ..
   n_items - 1 as the candidates (BaseModel.py:231-235).

The KG feeds (``kg.KGFeedBuilder``) and the impression feeds
(``rerank.ImpressionFeedBuilder``) build on these.
"""

from __future__ import annotations

import json
from typing import Dict, Iterator, Optional

import numpy as np

from .corpus import Corpus

CLIP_NUM = 40
# the ROADMAP item that ports the route of the JAX package still missing
QUEUE_MULTI_GPU = "ROADMAP Queue A item 6 (multi-GPU)"


class ClipWeights:
    """Task-1 interest-logit lookup (BaseModel.py:129-139,242-288)."""

    def __init__(self, clip_weight_path: str,
                 id2user: Optional[Dict[str, str]] = None,
                 id2item: Optional[Dict[str, str]] = None,
                 neg_weight_path: str = ""):
        with open(clip_weight_path) as f:
            self.table = json.load(f)
        self.id2user = id2user
        self.id2item = id2item
        self.neg_table = None
        if neg_weight_path:
            with open(neg_weight_path) as f:
                self.neg_table = json.load(f)
        self.freedom_keys = "FREEDOM" in clip_weight_path

    def _key(self, uid, iid, time):
        u = self.id2user[str(uid)] if self.id2user else uid
        i = self.id2item[str(iid)] if self.id2item else iid
        if self.freedom_keys:
            return f"{u}-{i}"
        return f"{u}-{i}-{time}"

    def target_slice(self, uid, iid, time) -> np.ndarray:
        key = self._key(uid, iid, time)
        if key in self.table:
            return np.asarray(self.table[key], np.float32)
        return np.ones(CLIP_NUM, np.float32)

    def neg_slice(self, uid, iid, time) -> np.ndarray:
        key = self._key(uid, iid, time)
        if self.neg_table is not None and key in self.neg_table:
            return np.asarray(self.neg_table[key], np.float32)
        raise KeyError(f"Key {key} not found in eval_neg_weight")


class FeedBuilder:
    """One split -> shuffled fixed-shape batches."""

    def __init__(self, corpus: Corpus, phase: str, task: str = "ranking",
                 num_neg: int = 1, history_max: int = 20,
                 include_history: bool = False,
                 neg_history: bool = False,
                 augment_history: bool = False,
                 beta_a: int = 3, beta_b: int = 3,
                 session_graph: bool = False,
                 s3rec_pretrain: bool = False,
                 s3rec_mask_ratio: float = 0.2,
                 test_all: bool = False,
                 clip_weights: Optional[ClipWeights] = None,
                 feature_store=None, seed: int = 0):
        self.corpus = corpus
        self.phase = phase
        self.task = task
        self.num_neg = num_neg
        self.history_max = history_max
        self.include_history = include_history
        self.neg_history = neg_history
        self.augment_history = augment_history
        self.beta_a, self.beta_b = beta_a, beta_b
        self.session_graph = session_graph
        self.s3rec_pretrain = s3rec_pretrain and phase == "train"
        self.s3rec_mask_ratio = s3rec_mask_ratio
        if self.s3rec_pretrain:
            self._s3rec_corpus()
        self.test_all = test_all
        self.hist_neg: Optional[np.ndarray] = None
        self.clip_weights = clip_weights
        self.store = feature_store
        self.rng = np.random.default_rng(seed)

        df = corpus.data_df[phase]
        if include_history:
            keep = df["position"] > 0  # SequentialModel.Dataset
            df = {k: v[keep] for k, v in df.items()}
            self._neg_eval = (corpus.neg_items[phase][keep]
                              if corpus.neg_items[phase] is not None else None)
        else:
            self._neg_eval = corpus.neg_items[phase]
        self.user_id = df["user_id"].astype(np.int64)
        self.item_id = df["item_id"].astype(np.int64)
        self.time = df["time"]
        self.position = df["position"].astype(np.int64)
        self.label = (df["label"].astype(np.float32)
                      if "label" in df else None)
        self.situations = {f: df[f] for f in corpus.situation_feature_names}
        self.neg_items_epoch: Optional[np.ndarray] = None

        if clip_weights is not None:
            self.target_clip = np.stack([
                clip_weights.target_slice(u, i, t)
                for u, i, t in zip(self.user_id, self.item_id, self.time)])
        else:
            self.target_clip = None

        if include_history:
            self._build_history()

    def _build_history(self):
        corpus, hmax = self.corpus, self.history_max
        n = len(self.user_id)
        self.hist_items = np.zeros((n, hmax), np.int64)
        self.hist_times = np.zeros((n, hmax), np.int64)
        self.hist_len = np.zeros(n, np.int32)
        self.hist_situs = {f: np.zeros((n, hmax), np.int64)
                           for f in corpus.situation_feature_names}
        # per-user minimum positive time interval (TiSASRec.py:48-53: min
        # over the all-pairs |ti-tj| matrix with zeros masked to 0xFFFF ==
        # min positive adjacent diff of the sorted times, capped at 0xFFFF)
        self.user_min_interval = np.full(corpus.n_users, 0xFFFF, np.int64)
        for uid, times in corpus.user_his_times.items():
            d = np.diff(np.asarray(times, np.int64))
            d = d[d > 0]
            if len(d):
                self.user_min_interval[uid] = min(int(d.min()), 0xFFFF)
        for r in range(n):
            items, times = corpus.history_slice(self.user_id[r],
                                                self.position[r], hmax)
            self.hist_items[r, :len(items)] = items
            self.hist_len[r] = len(items)
            self.hist_times[r, :len(items)] = times
            pos = int(self.position[r])
            lo = max(0, pos - hmax) if hmax > 0 else 0
            for f in corpus.situation_feature_names:
                vals = corpus.user_his_situs[f][int(self.user_id[r])]
                self.hist_situs[f][r, :len(items)] = vals[lo:pos]

    def _s3rec_corpus(self):
        """S3Rec's pretrain corpus (developing/S3Rec.py:118-131): every
        user's history cut into history_max-long chunks, and the users'
        histories end to end, where negative segments are drawn from."""
        hmax = self.history_max
        chunks, lens, long_seq = [], [], []
        for uid in sorted(self.corpus.user_his_items):
            inst = [int(x) for x in self.corpus.user_his_items[uid]]
            long_seq.extend(inst)
            for i0 in range((len(inst) - 1) // hmax + 1):
                tr = inst[i0 * hmax:(i0 + 1) * hmax]
                chunks.append(tr + [0] * (hmax - len(tr)))
                lens.append(len(tr))
        self.s3_item_seq = np.asarray(chunks, np.int64)
        self.s3_seq_len = np.asarray(lens, np.int32)
        self.s3_long_seq = np.asarray(long_seq, np.int64)

    def _augment_seq(self, seq):
        """ContraRec.py:108-124 mask_op / reorder_op over a beta(a, b)
        share of the slots."""
        n = len(seq)
        ratio = self.rng.beta(self.beta_a, self.beta_b)
        sel = int(n * ratio)
        if self.rng.random() > 0.5:
            keep = np.zeros(n, bool)
            keep[:sel] = True
            self.rng.shuffle(keep)
            out = seq.copy()
            out[keep] = self.corpus.n_items  # mask token
            return out
        start = int(self.rng.integers(0, n - sel + 1))
        idx2 = np.arange(n)
        self.rng.shuffle(idx2[start:start + sel])
        return seq[idx2]

    def __len__(self) -> int:
        if self.s3rec_pretrain:
            return len(self.s3_item_seq)
        return len(self.user_id)

    def _s3rec_batch(self, idx: np.ndarray, B: int):
        """Masked-item and segment-prediction views (S3Rec.py:143-165)."""
        hmax = self.s3_item_seq.shape[1]
        n_items = self.corpus.n_items
        mask_token = n_items
        out = {k: np.zeros((B, hmax), np.int64)
               for k in ("mask_seq", "pos_item", "neg_item", "mask_seg_seq",
                         "pos_seg", "neg_seg")}
        seq_len = np.zeros(B, np.int32)
        row_mask = np.zeros(B, bool)
        for r, ri in enumerate(idx):
            n = int(self.s3_seq_len[ri])
            seq = list(self.s3_item_seq[ri, :n])
            seq_set = set(seq)

            def neg():
                it = int(self.rng.integers(1, n_items))
                while it in seq_set:
                    it = int(self.rng.integers(1, n_items))
                return it

            mask_seq, pos_item, neg_item = list(seq), list(seq), list(seq)
            for j in range(n):
                if self.rng.random() < self.s3rec_mask_ratio:
                    mask_seq[j] = mask_token
                    neg_item[j] = neg()
            if n < 2:
                mseg, pseg, nseg = list(seq), list(seq), list(seq)
            else:
                sl = int(self.rng.integers(1, n // 2 + 1))
                st = int(self.rng.integers(0, n - sl))
                nst = int(self.rng.integers(0, len(self.s3_long_seq) - sl))
                tail = [mask_token] * (n - st - sl)
                mseg = seq[:st] + [mask_token] * sl + seq[st + sl:]
                pseg = [mask_token] * st + seq[st:st + sl] + tail
                nseg = ([mask_token] * st
                        + list(self.s3_long_seq[nst:nst + sl]) + tail)
            for key, vals in (("mask_seq", mask_seq), ("pos_item", pos_item),
                              ("neg_item", neg_item), ("mask_seg_seq", mseg),
                              ("pos_seg", pseg), ("neg_seg", nseg)):
                out[key][r, :len(vals)] = vals
            seq_len[r] = n
            row_mask[r] = True
        out["seq_len"] = seq_len
        out["row_mask"] = row_mask
        return out

    def actions_before_epoch(self):
        """Per-epoch negative sampling with clicked-set rejection
        (GeneralModel.Dataset.actions_before_epoch, BaseModel.py:292-300);
        with ``neg_history``, first one uniform negative per history slot
        other than the positive there (DIEN.py:206-216). S3Rec's pretrain
        draws no candidates (S3Rec.py:133-136)."""
        if self.s3rec_pretrain:
            return
        if self.neg_history and self.include_history \
                and self.phase == "train":
            neg_h = self.rng.integers(1, self.corpus.n_items,
                                      size=self.hist_items.shape)
            clash = neg_h == self.hist_items
            while clash.any():
                neg_h[clash] = self.rng.integers(1, self.corpus.n_items,
                                                 size=int(clash.sum()))
                clash = neg_h == self.hist_items
            self.hist_neg = neg_h
        if self.task != "ranking" or self.phase != "train":
            return
        n = len(self)
        neg = self.rng.integers(1, self.corpus.n_items,
                                size=(n, self.num_neg))
        for i, u in enumerate(self.user_id):
            clicked = self.corpus.train_clicked_set.get(u, set())
            for j in range(self.num_neg):
                while neg[i, j] in clicked:
                    neg[i, j] = self.rng.integers(1, self.corpus.n_items)
        self.neg_items_epoch = neg

    def _candidates(self, idx: np.ndarray) -> np.ndarray:
        if self.task == "ctr":
            return self.item_id[idx][:, None]
        if self.phase == "train":
            assert self.neg_items_epoch is not None, \
                "call actions_before_epoch() before iterating the train split"
            return np.concatenate(
                [self.item_id[idx][:, None], self.neg_items_epoch[idx]], axis=1)
        if self.test_all:
            # full-sort evaluation: [target] + every item id
            # (BaseModel.py:231-235; the runner puts clicked items at -inf,
            # BaseRunner.py:254-261)
            all_items = np.arange(1, self.corpus.n_items, dtype=np.int64)
            return np.concatenate(
                [self.item_id[idx][:, None],
                 np.broadcast_to(all_items, (len(idx), len(all_items)))],
                axis=1)
        assert self._neg_eval is not None, \
            f"{self.phase}.csv has no neg_items column (needed for ranking)"
        return np.concatenate(
            [self.item_id[idx][:, None], self._neg_eval[idx]], axis=1)

    def batches(self, batch_size: int, shuffle: bool,
                pad_final: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            B = batch_size if pad_final else len(idx)
            yield (self._s3rec_batch(idx, B) if self.s3rec_pretrain
                   else self._assemble(idx, B))

    def _assemble(self, idx: np.ndarray, B: int) -> Dict[str, np.ndarray]:
        corpus = self.corpus
        n_real = len(idx)

        def pad(a, fill=0):
            if n_real == B:
                return a
            out = np.full((B,) + a.shape[1:], fill, a.dtype)
            out[:n_real] = a
            return out

        items = self._candidates(idx)
        feed: Dict[str, np.ndarray] = {
            "user_id": pad(self.user_id[idx]),
            "item_id": pad(items),
            "row_mask": pad(np.ones(n_real, bool)),
            "time": pad(np.asarray(self.time[idx])),
        }
        if self.label is not None:
            feed["label"] = pad(self.label[idx])
        for f, arr in self.situations.items():
            feed[f] = pad(arr[idx])
        for f in corpus.user_feature_names:
            feed[f] = pad(corpus.user_features_arr[f][self.user_id[idx]])
        for f in corpus.item_feature_names:
            feed[f] = pad(corpus.item_features_arr[f][items])
        if self.target_clip is not None:
            # all candidates share the target's interest slice unless a
            # per-negative table exists (BaseModel.py:242-288)
            tc = self.target_clip[idx]  # (n, 40)
            I = items.shape[1]
            cw = np.repeat(tc[:, None, :], I, axis=1)
            if self.clip_weights.neg_table is not None and I > 2:
                for r in range(n_real):
                    for c in range(1, I):
                        cw[r, c] = self.clip_weights.neg_slice(
                            self.user_id[idx][r], items[r, c],
                            self.time[idx][r])
            feed["c_interest_weight"] = pad(cw.astype(np.float32))
        if self.include_history:
            feed["history_item_id"] = pad(self.hist_items[idx])
            feed["history_times"] = pad(self.hist_times[idx])
            feed["history_delta_t"] = pad(
                np.asarray(self.time[idx])[:, None] - self.hist_times[idx])
            feed["lengths"] = pad(self.hist_len[idx])
            if self.session_graph:
                graph = self._session_graphs(self.hist_items[idx])
                for k, v in graph.items():
                    feed[k] = pad(v)
            if self.augment_history and self.phase == "train":
                # two augmented views a row (ContraRec Dataset.augment: the
                # mask or reorder op over the real slots, a beta-drawn
                # extent; the mask token is n_items)
                for key in ("history_item_id_a", "history_item_id_b"):
                    aug = self.hist_items[idx].copy()
                    for r2 in range(n_real):
                        m2 = int(self.hist_len[idx][r2])
                        if m2 > 0:
                            aug[r2, :m2] = self._augment_seq(aug[r2, :m2])
                    feed[key] = pad(aug)
            feed["user_min_intervals"] = pad(
                self.user_min_interval[self.user_id[idx]])
            # historical item features (ContextSeqCTRModel.Dataset,
            # BaseContextModel.py:173-177)
            for f in corpus.item_feature_names:
                feed["history_" + f] = pad(
                    corpus.item_features_arr[f][self.hist_items[idx]])
            # historical situation values (ContextSeqReader.py:18-42,
            # used when the model sets add_historical_situations)
            for f in corpus.situation_feature_names:
                feed["history_" + f] = pad(self.hist_situs[f][idx])
            if self.hist_neg is not None:
                feed["history_neg_item_id"] = pad(self.hist_neg[idx])
                for f in corpus.item_feature_names:
                    feed["history_neg_" + f] = pad(
                        corpus.item_features_arr[f][self.hist_neg[idx]])
        if self.store is not None and "i_duration" in corpus.item_feature_names:
            # per-candidate segment line ids for the device-side gather
            dur = corpus.item_features_arr["i_duration"][items].astype(np.int64)
            lines = np.full(items.shape + (CLIP_NUM,), -1, np.int32)
            for r in range(n_real):
                for c in range(items.shape[1]):
                    pl = self.store.photo_line_ids(
                        int(items[r, c]), int(min(dur[r, c], CLIP_NUM)),
                        strict=False)
                    lines[r, c, :len(pl)] = pl
            feed["item_frame_lines"] = pad(lines, fill=-1)
        return feed

    @staticmethod
    def _session_graphs(hist: np.ndarray) -> Dict[str, np.ndarray]:
        """SRGNN's session graph of each row (SRGNN.py:42-76): the unique
        item nodes (0 among them where the history pads), the in / out
        normalised adjacency [L, 2L] over the consecutive pairs up to the
        first padding, and each position's node."""
        n, L2 = hist.shape
        alias = np.zeros((n, L2), np.int32)
        items_u = np.zeros((n, L2), np.int64)
        A = np.zeros((n, L2, 2 * L2), np.float32)
        for r2 in range(n):
            seq = hist[r2]
            node = np.unique(seq)
            items_u[r2, :len(node)] = node
            uA = np.zeros((L2, L2))
            for i2 in range(len(seq) - 1):
                if seq[i2 + 1] == 0:
                    break
                u = int(np.where(node == seq[i2])[0][0])
                v = int(np.where(node == seq[i2 + 1])[0][0])
                uA[u][v] = 1
            s_in = uA.sum(0)
            s_in[s_in == 0] = 1
            s_out = uA.sum(1)
            s_out[s_out == 0] = 1
            A[r2] = np.concatenate([uA / s_in, (uA.T / s_out)]).T
            alias[r2] = [int(np.where(node == i3)[0][0]) for i3 in seq]
        return {"srgnn_alias": alias, "srgnn_items": items_u, "srgnn_A": A}
