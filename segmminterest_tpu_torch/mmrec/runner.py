"""MMRec trainer + leave-rank evaluator (port of
``segmminterest_tpu/mmrec/runner.py``).

Behavioral spec: reference SkipPredBaseline/MMRec/src/common/trainer.py
(fit :48-…, eval-step early stopping with stopping_step=20,
best-test-upon-valid tracking :230-302) and utils/topk_evaluator.py
(interest_TopK_{mask,nonmask} :77-151, canonical logit export :152-178).

Training protocol: per-epoch uniform negative sampling of (user, pos, neg)
triplets over the train interactions; full-graph embeddings recomputed per
step on the runner's device; FREEDOM-style degree-sensitive edge dropout
becomes a static-shape per-epoch keep mask with renormalized values. The
numpy draws come in the JAX runner's order from a generator seeded as
its: each epoch a permutation, the negatives, then the keep mask. An
epoch's triplets go to the device once; its losses stay there until the
epoch's mean is read. ``optax.adam`` is ``torch.optim.Adam`` with its
defaults. BM3's and SLMRec's dropout masks come from a torch generator
seeded from ``seed`` (torch's bits, not JAX's).

Evaluation: full-sort embeddings on the device, read to the host once;
per eval interaction the candidate frames of the watched video are scored
there as the JAX runner scores them (float32 numpy dot products) and the
leave frame is ranked by ASCENDING score with permutation tie-breaking
(mask variant pads with +inf and drops completed views).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .graph import knn_edges_device, masked_norm_values
from .models import bpr_triplet_loss

logger = logging.getLogger(__name__)


@dataclass
class MMRecConfig:
    epochs: int = 1000
    stopping_step: int = 20
    learning_rate: float = 1e-3
    batch_size: int = 2048
    valid_metric: str = "hr@5"
    edge_dropout: float = 0.0      # FREEDOM degree-sensitive pruning rate
    seed: int = 2020
    use_mask_eval: bool = True


def interest_topk(interests, view_lengths, durations, mask: bool,
                  rng: Optional[np.random.Generator] = None):
    """interest_TopK_{mask,nonmask} (topk_evaluator.py:77-151): ascending
    rank of the leave position with random tie-breaking."""
    interests = np.asarray(interests, dtype=np.float64)
    bsz, seq_len = interests.shape
    vl = np.asarray(view_lengths).astype(np.int64).flatten()
    dur = np.asarray(durations).astype(np.int64).flatten()
    if mask:
        valid = vl != dur
        interests, vl, dur = interests[valid], vl[valid], dur[valid]
        m = np.arange(seq_len)[None, :] < dur[:, None]
        interests = np.where(m, interests, np.inf)
    else:
        valid = vl < seq_len
        interests, vl = interests[valid], vl[valid]
    bsz = len(vl)
    r = rng if rng is not None else np.random
    permuted = np.stack([r.permutation(seq_len) for _ in range(bsz)]) \
        if bsz else np.zeros((0, seq_len), np.int64)
    predictions = np.take_along_axis(interests, permuted, axis=1)
    sorted_idx = np.argsort(predictions, axis=1)
    target = np.argmax(permuted == vl[:, None], axis=1)
    gt_rank = np.argmax(sorted_idx == target[:, None], axis=1) + 1
    out = {}
    for k in (1, 3, 5, 10):
        hit = (gt_rank <= k).astype(np.float32)
        out[f"hr@{k}"] = float(hit.mean()) if bsz else float("nan")
        out[f"ndcg@{k}"] = float((hit / np.log2(gt_rank + 1)).mean()) \
            if bsz else float("nan")
    return out


class MMRecRunner:
    def __init__(self, model, cfg: MMRecConfig, train_users: np.ndarray,
                 train_items: np.ndarray, n_items: int, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.train_users = train_users.astype(np.int64)
        self.train_items = train_items.astype(np.int64)
        self.n_items = n_items
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = torch.Generator(device=self.device)
        self.optimizer = None
        self.model_name = type(model).__name__
        # LATTICE rebuilds its item-graph STRUCTURE from the learned
        # projections once per epoch / evaluation (lattice.py:137-157)
        self.dynamic_graph = self.model_name == "LATTICE"
        self._knn_k = (len(model.mm_edges) // model.n_items
                       if self.dynamic_graph else 0)
        # the edge-dropout sampling weights, as the JAX runner's (float64)
        p = model.edge_values.cpu().numpy().astype(np.float64)
        self._edge_p = p / p.sum()

    def init_state(self) -> Dict[str, torch.Tensor]:
        """Initial weights from ``cfg.seed``, a fresh Adam, the dropout
        generator reseeded; returns the weights."""
        self.model.reset_parameters(
            torch.Generator().manual_seed(self.cfg.seed))
        self.generator.manual_seed(self.cfg.seed)
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=self.cfg.learning_rate)
        return self.state()

    def state(self) -> Dict[str, torch.Tensor]:
        """A copy of the model's weights."""
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    def _rebuild_edges(self):
        """Current learned kNN structure, or None for static-graph models."""
        if not self.dynamic_graph:
            return None
        with torch.no_grad():
            return knn_edges_device(self.model.projected_features(),
                                    self._knn_k)

    # ------------------------------------------------------------------
    def _loss(self, u_idx, pos_idx, neg_idx, row_mask, keep_values,
              learned_edges=None, masks=None):
        m = self.model
        if self.model_name == "BM3":
            return m.bm3_loss(u_idx, pos_idx, row_mask, keep_values,
                              self.generator, masks)
        if self.dynamic_graph:
            u_all, i_all = m.embeddings(keep_values, learned_edges)
        else:
            u_all, i_all = m.embeddings(keep_values)
        loss = bpr_triplet_loss(u_all[u_idx], i_all[pos_idx], i_all[neg_idx],
                                row_mask)
        loss = loss + m.extra_loss(u_all, i_all, u_idx, pos_idx, neg_idx,
                                   row_mask)
        if self.model_name == "SLMRec":
            loss = loss + m.ssl_loss(pos_idx, row_mask, keep_values,
                                     self.generator, masks, i_all=i_all)
        return loss

    def train_step(self, u_idx, pos_idx, neg_idx, row_mask, keep_values=None,
                   learned_edges=None, masks=None) -> torch.Tensor:
        """One Adam step on a (padded) triplet batch of device tensors;
        ``masks``: BM3's or SLMRec's dropout masks (drawn when None).
        Returns the loss, on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(u_idx, pos_idx, neg_idx, row_mask, keep_values,
                          learned_edges, masks)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _epoch_keep_values(self):
        """FREEDOM degree-sensitive edge pruning as a static keep mask."""
        if self.cfg.edge_dropout <= 0:
            return None
        E = len(self._edge_p)
        keep_n = int(E * (1 - self.cfg.edge_dropout))
        idx = self.rng.choice(E, size=keep_n, replace=False, p=self._edge_p)
        keep = np.zeros(E, bool)
        keep[idx] = True
        return masked_norm_values(
            self.model.edge_u, self.model.edge_i,
            torch.from_numpy(keep).to(self.device), self.model.n_users,
            self.model.n_items)

    def epoch_batches(self):
        """One epoch's draws: (keep_values, (users, positives, negatives,
        row_mask)), numpy arrays padded to whole batches; the padded rows
        index row 0 (its negative ``neg[0]``) with row_mask 0."""
        n = len(self.train_users)
        order = self.rng.permutation(n)
        neg = self.rng.integers(1, self.n_items, size=n)
        keep_values = self._epoch_keep_values()
        pad = -n % self.cfg.batch_size
        idx = np.concatenate([order, np.zeros(pad, np.int64)])
        row_mask = np.ones(n + pad, np.float32)
        row_mask[n:] = 0.0
        return keep_values, (self.train_users[idx], self.train_items[idx],
                             neg[idx], row_mask)

    def fit_epoch(self) -> float:
        keep_values, arrays = self.epoch_batches()
        learned_edges = self._rebuild_edges()
        u, pos, neg, row_mask = (torch.from_numpy(a).to(self.device)
                                 for a in arrays)
        bs, losses = self.cfg.batch_size, []
        for s in range(0, len(u), bs):
            losses.append(self.train_step(
                u[s:s + bs], pos[s:s + bs], neg[s:s + bs],
                row_mask[s:s + bs], keep_values, learned_edges))
        return float(torch.stack(losses).double().mean())

    # ------------------------------------------------------------------
    def _embeddings(self, state=None):
        """Full-graph (user, item) embeddings of ``state`` (None: the
        current weights) as host numpy arrays."""
        if state is not None:
            self.model.load_state_dict(state)
        with torch.no_grad():
            learned = self._rebuild_edges()
            u_all, i_all = (self.model.embeddings(None, learned)
                            if self.dynamic_graph
                            else self.model.embeddings(None))
        return u_all.detach().cpu().numpy(), i_all.detach().cpu().numpy()

    def evaluate(self, state, eval_inters: List[dict],
                 frame_map: Dict[str, List[int]],
                 rng: Optional[np.random.Generator] = None):
        """eval_inters: [{userID, photo_id, view_length, duration}];
        scores come from the full-sort embeddings of ``state`` (None: the
        current weights; a state is loaded into the model)."""
        u_all, i_all = self._embeddings(state)
        interests = np.zeros((len(eval_inters), 40), np.float64)
        vls = np.zeros(len(eval_inters), np.int64)
        durs = np.zeros(len(eval_inters), np.int64)
        for r, inter in enumerate(eval_inters):
            frames = np.asarray(frame_map[str(inter["photo_id"])], np.int64)
            scores = u_all[int(inter["userID"])] @ i_all[frames].T
            interests[r, :len(frames)] = scores
            vls[r] = inter["view_length"]
            durs[r] = min(inter["duration"], 40)
        return interest_topk(interests, vls, durs, self.cfg.use_mask_eval,
                             rng)

    def export_logits(self, state, all_inters: List[dict],
                      frame_map: Dict[str, List[int]]) -> Dict[str, list]:
        """Canonical {user_id-photo_id-time: [40]} export, padding with the
        user's default-item score analogue (here: 0.0) —
        topk_evaluator.save_logits :152-178 mode '0'."""
        u_all, i_all = self._embeddings(state)
        out = {}
        for inter in all_inters:
            frames = np.asarray(frame_map[str(inter["photo_id"])], np.int64)
            scores = u_all[int(inter["userID"])] @ i_all[frames].T
            key = f"{inter['user_id']}-{inter['photo_id']}-{inter['time']}"
            out[key] = [float(x) for x in scores] \
                + [0.0] * (40 - len(frames))
        return out

    def train(self, dev_inters, test_inters, frame_map):
        """fit with eval-step early stopping + best-test-upon-valid
        (trainer.py:230-302). The best state is a copy of the weights."""
        self.init_state()
        eval_rng = np.random.default_rng(self.cfg.seed)
        best_valid, best_valid_result, best_test_upon_valid = None, {}, {}
        best_state = self.state()
        stop_count = 0
        for epoch in range(self.cfg.epochs):
            loss = self.fit_epoch()
            if np.isnan(loss):
                logger.info("NaN loss at epoch %d, stop", epoch)
                break
            valid = self.evaluate(None, dev_inters, frame_map, eval_rng)
            metric = valid[self.cfg.valid_metric]
            test = self.evaluate(None, test_inters, frame_map, eval_rng)
            star = ""
            if best_valid is None or metric > best_valid:
                best_valid, best_valid_result = metric, valid
                best_test_upon_valid = test
                best_state = self.state()
                stop_count = 0
                star = " *"
            else:
                stop_count += 1
            logger.info("epoch %d loss=%.4f valid=%s%s", epoch, loss,
                        {k: round(v, 4) for k, v in valid.items()
                         if k in ("hr@5", "ndcg@5")}, star)
            if stop_count >= self.cfg.stopping_step:
                logger.info("early stop at epoch %d", epoch)
                break
        return best_state, {"best_valid_result": best_valid_result,
                            "best_test_upon_valid": best_test_upon_valid}
