"""SegRec runners: train / eval loops for the ranking and CTR tasks (port of
``segmminterest_tpu/segrec/runner.py``).

Behavioral spec: reference SegRec/helpers/BaseRunner.py (:18-271) and
CTRRunner.py (:20-79):
 * per-epoch negative sampling, then candidate shuffle before the forward and
   un-shuffle of predictions (anti-position-leak, :192-208) — ONLY item_id is
   shuffled, exactly like the reference;
 * ranking loss = softmax-weighted soft BPR (BaseModel.py:212-226); CTR loss
   = BCE on sigmoid outputs (or MSE); optional BCE ranking loss
   (BaseContextModel.py:63-73); the general and sequential models' routes
   (``loss_n``): ContraRec's temperature softmax, BUIR's bootstrap loss,
   DirectAU's alignment / uniformity, and none for CLRec and S3Rec's
   pretrain, whose own terms are the objective; CFKG's and Chorus's
   stage-1 margin loss over TransE quadruples (``cfkg_margin_loss``, the
   ``margin`` of RunnerConfig);
 * full-sort evaluation (``test_all`` feeds): the users' clicked items at
   -inf (BaseRunner.py:254-261);
 * dev-metric early stop: non-increasing window or best-age > patience
   (:220-225);
 * evaluate_method: rank of the first column among candidates with the
   all-equal random fallback (:53-80); CTR: AUC/F1/ACC/LogLoss (:22-43) and
   WUAUC (main.py:101-117); ``LeaveRankingRunner``'s leave-frame variant
   (SkipPredBaseline ReChorus fork, BaseRunner.py:52-114): candidate 0
   ranked by ASCENDING score, ties broken by one ``rng.permutation`` a row
   from the runner's generator, after every draw training made;
 * optimizer by name; ``l2`` is added to the gradient before the update,
   biases excluded (BaseModel.customize_parameters :77-86, torch-Adam-style
   L2, as ``optax.add_decayed_weights`` chains it).

The optimizers are optax's: ``adam`` is ``torch.optim.Adam``, ``sgd``
``torch.optim.SGD``, ``adadelta`` ``torch.optim.Adadelta(rho=0.9,
eps=1e-6)``, ``adagrad`` ``engine/optim.py``'s :class:`Adagrad` (optax's
initial accumulator 0.1 and eps 1e-7).

The runner owns the model, on ``device`` (the card unless the caller asks
for the CPU), and the feature table, put there once; a batch's keys go to
the device each step and the (B, I, 40) frame gather runs there. A state is
a ``state_dict`` snapshot (parameters and BatchNorm statistics) on the
device; ``train`` returns the best one. BatchNorm statistics update in
training from every row of the batch, as the JAX runner's do (the final
batch's padding included); the losses average over real rows only
(``row_mask``).

The numpy ``Generator`` calls are the JAX runner's, in the same order (the
candidate shuffle, one integer per step, the evaluation's tie fallback),
so host shuffles are the same bits; each step's integer seeds the torch
generator that draws the step's dropout masks.

``save_state`` writes a ``.pt`` state_dict; ``load_state`` reads that or
the JAX runner's ``.msgpack`` params (flax ``to_bytes`` of the params
tree, decoded by ``engine/checkpoint.py``), in full or ``partial``.

The training loss adds what the model returns in ``losses`` (the flax
models' sown terms): the contrastive term weighted by
``auxillary_loss_weight``, the others (DCNv2's ``reg_loss``, DIEN's
``aux_loss``) as they are, pre-weighted; then ``model.reg_loss()`` where
the model has one (AFM, xDeepFM). A model with ``momentum_update``
(BUIR) runs it after every optimizer step and ``sync_targets`` before
training, as the JAX runner does. Evaluation hands the model a generator
seeded from ``seed`` for each batch, as the JAX runner hands its evaluation
a fixed ``gumbel`` key: AdaGIN samples its Gumbel noise there too.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..engine.checkpoint import msgpack_restore
from ..engine.evaluation import _auc_score
from ..engine.optim import Adagrad
from ..models.convert import segrec_state_dict
from ..utils.device import resolve_device
from .feeds import FeedBuilder
from .kg import cfkg_margin_loss
from .models.general import direct_au_loss

logger = logging.getLogger(__name__)

DEVICE_KEYS_EXCLUDE = ("time",)


@dataclass
class RunnerConfig:
    epoch: int = 200
    early_stop: int = 10
    lr: float = 1e-3
    l2: float = 0.0
    batch_size: int = 512
    eval_batch_size: int = 512
    optimizer: str = "Adam"
    topk: Tuple[int, ...] = (5, 10, 20, 50)
    metrics: Tuple[str, ...] = ("NDCG", "HR")
    main_metric: str = ""
    # ranking: BPR | BCE | DirectAU | BUIR | ContraRec | CLRec | S3Rec |
    # CFKG | ChorusKG; ctr: BCE | MSE; the impression losses
    # (impression.IMPRESSION_LOSSES) under ImpressionRunner
    loss_n: str = "BPR"
    directau_gamma: float = 1.0
    ctc_temp: float = 1.0        # ContraRec's context-target temperature
    auxillary_loss_weight: float = 0.0
    margin: float = 0.0          # CFKG / Chorus-KG hinge margin
    seed: int = 0


def bpr_loss(predictions, row_mask):
    """Softmax-weighted soft BPR (BaseModel.py:212-226)."""
    pos, neg = predictions[:, 0], predictions[:, 1:]
    neg_softmax = torch.softmax(neg, dim=1)
    s = (torch.sigmoid(pos[:, None] - neg) * neg_softmax).sum(dim=1)
    per_row = -torch.log(torch.clamp(s, 1e-8, 1 - 1e-8))
    return _row_mean(per_row, row_mask)


def bce_ranking_loss(predictions, row_mask):
    """BCE over sigmoid candidate scores (BaseContextModel.py:66-70)."""
    p = torch.sigmoid(predictions)
    pos, neg = p[:, 0], p[:, 1:]
    per_row = -(torch.log(torch.clamp(pos, 1e-12, 1.0))
                + torch.log(torch.clamp(1 - neg, 1e-12, 1.0)).sum(dim=1))
    return _row_mean(per_row, row_mask)


def bce_ctr_loss(probs, labels, row_mask):
    """nn.BCELoss over probabilities (BaseModel.py:345-358)."""
    p = torch.clamp(probs, 1e-7, 1 - 1e-7)
    ce = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    return _row_mean(ce, row_mask)


def mse_ctr_loss(probs, labels, row_mask):
    return _row_mean((probs - labels) ** 2, row_mask)


def _row_mean(per_row, row_mask):
    n = torch.clamp(row_mask.sum(), min=1)
    return torch.where(row_mask, per_row, torch.zeros_like(per_row)).sum() / n


def evaluate_ranking(predictions: np.ndarray, topk, metrics,
                     rng: Optional[np.random.Generator] = None):
    """HR/NDCG of the first-column ground truth (BaseRunner.py:53-80)."""
    gt_rank = (predictions > predictions[:, 0].reshape(-1, 1)).sum(-1) + 1
    if (gt_rank != 1).sum() == 0:
        r = rng if rng is not None else np.random
        pred_rnd = predictions.copy()
        pred_rnd[:, 1:] += r.random(
            (predictions.shape[0], predictions.shape[1] - 1)) * 1e-6
        gt_rank = (pred_rnd > predictions[:, 0].reshape(-1, 1)).sum(-1) + 1
    evaluations = {}
    for k in topk:
        hit = gt_rank <= k
        for metric in metrics:
            key = f"{metric}@{k}"
            if metric == "HR":
                evaluations[key] = float(hit.mean())
            elif metric == "NDCG":
                evaluations[key] = float((hit / np.log2(gt_rank + 1)).mean())
            else:
                raise ValueError(f"Undefined metric {metric}")
    return evaluations


def evaluate_leave_ranking(predictions: np.ndarray, topk, metrics,
                           durations=None, data_name: str = "",
                           rng: Optional[np.random.Generator] = None):
    """Leave-frame ranking (SkipPredBaseline/ReChorus/src/helpers/
    BaseRunner.py:52-114): rank of candidate 0 (the leave frame) by
    ASCENDING score with random-permutation tie-breaking. Duration-mask
    variants push out-of-duration candidates to +inf; 'Default' datasets trim
    the trailing default-item row, 'Fill' ones their filler rows."""
    predictions = np.asarray(predictions, dtype=np.float64)
    bsz, seq_len = predictions.shape
    if (durations is not None and "Default" not in data_name
            and "Fill" not in data_name):
        dur = np.asarray(durations)[:, None]
        mask = np.arange(seq_len)[None, :] < dur
        predictions = np.where(mask, predictions, np.inf)
    elif "Default" in data_name:
        predictions = predictions[:-1]
        bsz -= 1
    elif "Fill" in data_name:
        # Fill datasets append a fixed count of filler rows that the
        # evaluator trims (BaseRunner.py:82-87): 23 for KuaiMM, 36 for
        # KuaiRand
        n_fill = 36 if "KuaiRand" in data_name else 23
        predictions = predictions[:-n_fill]
        bsz -= n_fill
    r = rng if rng is not None else np.random
    permuted = np.stack([r.permutation(seq_len) for _ in range(bsz)]) \
        if bsz else np.zeros((0, seq_len), np.int64)
    shuffled = np.take_along_axis(predictions, permuted, axis=1)
    sorted_indices = np.argsort(shuffled, axis=1)
    target = np.argmax(permuted == 0, axis=1)
    gt_rank = np.argmax(sorted_indices == target[:, None], axis=1) + 1
    evaluations = {}
    for k in topk:
        hit = gt_rank <= k
        for metric in metrics:
            key = f"{metric}@{k}"
            if metric == "HR":
                evaluations[key] = float(hit.mean()) if bsz else float("nan")
            elif metric == "NDCG":
                evaluations[key] = float(
                    (hit / np.log2(gt_rank + 1)).mean()) if bsz else float("nan")
            else:
                raise ValueError(f"Undefined metric {metric}")
    return evaluations


def evaluate_ctr(predictions: np.ndarray, labels: np.ndarray, metrics):
    """AUC/F1/ACC/LogLoss (CTRRunner.py:22-43)."""
    evaluations = {}
    for metric in metrics:
        if metric == "ACC":
            evaluations[metric] = float(
                ((predictions > 0.5).astype(int) == labels.astype(int)).mean())
        elif metric == "AUC":
            evaluations[metric] = _auc_score(labels, predictions)
        elif metric == "F1_SCORE":
            pred_bin = (predictions > 0.5).astype(int)
            tp = ((pred_bin == 1) & (labels == 1)).sum()
            fp = ((pred_bin == 1) & (labels == 0)).sum()
            fn = ((pred_bin == 0) & (labels == 1)).sum()
            prec = tp / max(tp + fp, 1)
            rec = tp / max(tp + fn, 1)
            evaluations[metric] = float(
                2 * prec * rec / max(prec + rec, 1e-12))
        elif metric == "LOG_LOSS":
            p = np.clip(predictions, 1e-7, 1 - 1e-7)
            evaluations[metric] = float(
                -(np.log(p) * labels + np.log(1 - p) * (1 - labels)).mean())
        else:
            raise ValueError(f"Undefined metric {metric}")
    return evaluations


def evaluate_wuauc(predictions, labels, user_ids):
    """Per-user ROC-AUC weighted by interaction count (main.py:101-117)."""
    total, length = 0.0, 0
    for u in np.unique(user_ids):
        sel = user_ids == u
        try:
            auc = _auc_score(labels[sel], predictions[sel])
        except ValueError:
            continue
        total += auc * sel.sum()
        length += sel.sum()
    return total / max(length, 1)


def _is_bias(name: str) -> bool:
    """optax's no-decay mask: the leaf's name ends with "bias"."""
    return name.rsplit(".", 1)[-1].endswith("bias")


class RankingRunner:
    task = "ranking"

    def __init__(self, model: nn.Module, cfg: RunnerConfig, feat_table=None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.metrics = tuple(m.strip().upper() for m in cfg.metrics)
        self.topk = tuple(cfg.topk)
        self.main_metric = cfg.main_metric or \
            f"{self.metrics[0]}@{self.topk[0]}"
        if feat_table is not None and not isinstance(feat_table,
                                                     torch.Tensor):
            feat_table = torch.from_numpy(np.ascontiguousarray(
                feat_table, np.float32))
        self.feat_table = (feat_table.to(self.device)
                           if feat_table is not None else None)
        self.optimizer = self._build_optimizer()
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = torch.Generator(device=self.device)

    # ------------------------------------------------------------------
    def _build_optimizer(self) -> torch.optim.Optimizer:
        params, lr = list(self.model.parameters()), self.cfg.lr
        name = self.cfg.optimizer.lower()
        if name == "adam":
            return torch.optim.Adam(params, lr=lr)
        if name == "adagrad":
            return Adagrad(params, lr)
        if name == "sgd":
            return torch.optim.SGD(params, lr=lr)
        if name == "adadelta":
            return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6)
        raise KeyError(f"unknown optimizer {self.cfg.optimizer}")

    def _decays(self, name: str) -> bool:
        """Whether ``l2`` decays the parameter ``name``."""
        return not _is_bias(name)

    def _loss(self, predictions, batch):
        """The loss route ``loss_n`` (the JAX runner's, route for route).
        BUIR's and DirectAU's read the batch's first candidate column as
        the model saw it, after the candidate shuffle, as the JAX runner's
        do."""
        if "unshuffle" in batch:
            # restore candidate order so column 0 is the target
            # (BaseRunner.py:199-208)
            predictions = torch.gather(predictions, 1, batch["unshuffle"])
        name, rm = self.cfg.loss_n, batch["row_mask"]
        if name in ("CFKG", "ChorusKG"):
            # margin ranking over the (pos, pos, neg-tail, neg-head)
            # quadruples (CFKG.py:70-76 / Chorus.py:168-177)
            return cfkg_margin_loss(predictions, rm, self.cfg.margin)
        if name in ("S3Rec", "CLRec"):
            # the model's own term (its losses) is the whole objective
            # (S3Rec.py:59-113, CLRec.py:61-63)
            return torch.zeros((), dtype=predictions.dtype,
                               device=predictions.device)
        if name == "ContraRec":
            # context-target contrastive: a temperature softmax over the
            # candidates, NLL of column 0 (ContraRec.py:101-105)
            t = self.cfg.ctc_temp
            p = torch.softmax(predictions / t, dim=1)
            per_row = -t * torch.log(torch.clamp(p[:, 0], 1e-12, 1.0))
            rm = rm.to(per_row.dtype)
            return (per_row * rm).sum() / torch.clamp(rm.sum(), min=1)
        if name == "BUIR":
            # the bootstrap loss over online / target tables
            # (general/BUIR.py:101-114)
            return self.model.buir_loss(batch["user_id"],
                                        batch["item_id"][:, 0], rm)
        if name == "DirectAU":
            # alignment / uniformity over the MF tables (general/DirectAU.py)
            return direct_au_loss(
                self.model.u_embeddings(batch["user_id"].long()),
                self.model.i_embeddings(batch["item_id"][:, 0].long()), rm,
                self.cfg.directau_gamma)
        if name == "BCE":
            return bce_ranking_loss(predictions, rm)
        return bpr_loss(predictions, rm)

    def put(self, feed: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch's device keys (all but ``time``) on the device."""
        pin = self.device.type == "cuda"
        out = {}
        for k, v in feed.items():
            if k in DEVICE_KEYS_EXCLUDE:
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory().to(self.device, non_blocking=True)
                      if pin else t)
        return out

    def _forward(self, batch, generator=None):
        return self.model(batch, feat_table=self.feat_table,
                          generator=generator)

    def train_step(self, feed: Dict[str, np.ndarray], seed: int
                   ) -> torch.Tensor:
        """One optimizer step on a host batch (the candidate shuffle already
        applied); ``seed`` seeds the step's dropout masks. Returns the loss
        (on the device)."""
        batch = self.put(feed)
        self.generator.manual_seed(seed)
        self.model.train()
        try:
            out, losses = self._forward(batch, self.generator)
            loss = self._loss(out, batch)
            for name, v in losses.items():
                # the contrastive term is weighted by the runner
                # (BaseRunner.py:210-214)
                w = (self.cfg.auxillary_loss_weight
                     if "contrastive" in name else 1.0)
                loss = loss + w * v
            if hasattr(self.model, "reg_loss"):
                # AFM / xDeepFM's L2 terms (AFM.py:103-106,
                # xDeepFM.py:77-94)
                loss = loss + self.model.reg_loss()
            self.optimizer.zero_grad(set_to_none=True)
            if loss.requires_grad:  # POP's scores depend on no parameter
                loss.backward()
        finally:
            self.model.eval()
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                if p.grad is None:  # unused this step: optax sees zeros
                    p.grad = torch.zeros_like(p)
                if self.cfg.l2 > 0 and self._decays(name):
                    p.grad.add_(p, alpha=self.cfg.l2)
        self.optimizer.step()
        if hasattr(self.model, "momentum_update"):
            # BUIR's target tables follow the online ones (BUIRRunner)
            self.model.momentum_update()
        return loss.detach()

    def eval_scores(self, feed: Dict[str, np.ndarray]) -> np.ndarray:
        """The (B, I) scores of a host batch, deterministic, on the host."""
        self.model.eval()
        self.generator.manual_seed(self.cfg.seed)
        with torch.inference_mode():
            out, _ = self._forward(self.put(feed), self.generator)
        return out.float().cpu().numpy()

    # ------------------------------------------------------------------
    def state(self) -> Dict[str, torch.Tensor]:
        """A snapshot of the model's parameters and statistics."""
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    def load(self, state: Optional[Dict[str, torch.Tensor]]) -> None:
        if state is not None:
            self.model.load_state_dict(state)

    def _shuffled_batch(self, feed):
        """Candidate shuffle of item_id only (BaseRunner.py:192-208)."""
        items = feed["item_id"]
        B, I = items.shape
        perm = np.argsort(self.rng.random((B, I)), axis=-1)
        shuffled = dict(feed)
        shuffled["item_id"] = np.take_along_axis(items, perm, axis=1)
        shuffled["unshuffle"] = np.argsort(perm, axis=-1)
        return shuffled

    def fit(self, builder: FeedBuilder, epoch: int) -> float:
        builder.actions_before_epoch()
        losses = []
        for feed in builder.batches(self.cfg.batch_size, shuffle=True):
            if self.task == "ranking" and "item_id" in feed:
                feed = self._shuffled_batch(feed)
            seed = int(self.rng.integers(0, 2 ** 31 - 1))
            losses.append(float(self.train_step(feed, seed)))
        return float(np.mean(losses)) if losses else float("nan")

    def predict(self, builder: FeedBuilder, state=None) -> np.ndarray:
        self.load(state)
        preds = [self.eval_scores(feed)[feed["row_mask"]]
                 for feed in builder.batches(self.cfg.eval_batch_size,
                                             shuffle=False)]
        predictions = np.concatenate(preds, axis=0)
        if builder.test_all:
            # column j >= 1 scores item id j; the items each user clicked
            # in train and the residual splits leave the ranking
            # (BaseRunner.py:254-261)
            corpus = builder.corpus
            for i, u in enumerate(builder.user_id):
                clicked = (corpus.train_clicked_set.get(u, set())
                           | corpus.residual_clicked_set.get(u, set()))
                predictions[i, list(clicked)] = -np.inf
        return predictions

    def evaluate(self, builder: FeedBuilder, state=None, topk=None,
                 metrics=None):
        predictions = self.predict(builder, state)
        return evaluate_ranking(predictions, topk or self.topk,
                                metrics or self.metrics, rng=self.rng)

    @staticmethod
    def eval_termination(criterion: List[float], patience: int) -> bool:
        if patience <= 0:
            return False
        if len(criterion) > patience:
            window = criterion[-patience:]
            if all(window[i] >= window[i + 1]
                   for i in range(len(window) - 1)):
                return True
        return len(criterion) - criterion.index(max(criterion)) > patience

    def save_state(self, state, path: str):
        """The state_dict as a ``.pt`` file (ReChorus BaseModel.save_model)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save({k: v.cpu() for k, v in state.items()}, path)
        logger.info("Save model to %s", path)

    def load_state(self, path: str, partial: bool = False):
        """Restore a ``.pt`` state_dict or the JAX runner's ``.msgpack``
        params into the model, with a fresh optimizer. ``partial``: only
        the entries present in both with the same shape (ReChorus
        TiMiRec.load_model:92-101 — a finetune absorbs a pretrained
        subset)."""
        own = self.model.state_dict()
        if path.endswith(".msgpack"):
            with open(path, "rb") as f:
                loaded = segrec_state_dict(self.model, msgpack_restore(
                    f.read()), partial=partial)
        else:
            loaded = torch.load(path, map_location="cpu", weights_only=True)
            if partial:
                loaded = {k: v for k, v in loaded.items()
                          if k in own and own[k].shape == v.shape}
            elif set(loaded) != set(own):
                raise KeyError(f"{path}: keys differ from the model's: "
                               f"{sorted(set(loaded) ^ set(own))[:8]}")
        with torch.no_grad():
            for k, v in loaded.items():
                own[k].copy_(v)
        self.optimizer = self._build_optimizer()
        logger.info("Load model from %s%s", path,
                    " (partial)" if partial else "")

    def train(self, builders: Dict[str, FeedBuilder], init_path: str = "",
              do_train: bool = True):
        """Full training loop (BaseRunner.py:120-180). Returns
        (best_state, history dict)."""
        if builders["train"].task == "ranking":
            # the JAX runner samples the train split's negatives once and
            # assembles the first batch, the example it initialises from
            # (ContraRec's views and S3Rec's pretrain views draw there):
            # the same draws here
            builders["train"].actions_before_epoch()
            next(builders["train"].batches(self.cfg.batch_size,
                                           shuffle=False))
        if hasattr(self.model, "sync_targets"):
            # BUIR: online -> target after init, before any load
            self.model.sync_targets()
        if init_path:
            if os.path.exists(init_path):
                self.load_state(init_path, partial=True)
            else:
                logger.info("Train from scratch! (%s missing)", init_path)
        if not do_train:
            return self.state(), {"main_results": [], "dev_results": []}
        main_results: List[float] = []
        dev_results: List[Dict[str, float]] = []
        best_state = self.state()
        try:
            for epoch in range(self.cfg.epoch):
                loss = self.fit(builders["train"], epoch + 1)
                if np.isnan(loss):
                    logger.info("Loss is NaN. Stop training at %d.",
                                epoch + 1)
                    break
                dev_result = self.evaluate(
                    builders["dev"],
                    topk=[int(self.main_metric.split("@")[1])]
                    if "@" in self.main_metric else None)
                dev_results.append(dev_result)
                main_results.append(dev_result[self.main_metric])
                star = ""
                if max(main_results) == main_results[-1]:
                    best_state = self.state()
                    star = " *"
                logger.info("Epoch %-4d loss=%.4f dev=%s%s", epoch + 1, loss,
                            dev_result, star)
                if self.eval_termination(main_results, self.cfg.early_stop):
                    logger.info("Early stop at %d based on dev result.",
                                epoch + 1)
                    break
        except KeyboardInterrupt:
            # graceful exit keeping the best state so far
            # (BaseRunner.py:165-170)
            logger.info("Interrupted; returning best state so far "
                        "(%d completed evals).", len(dev_results))
        best_epoch = int(np.argmax(main_results)) if main_results else -1
        logger.info("Best Iter(dev)=%d dev=%s", best_epoch + 1,
                    dev_results[best_epoch] if dev_results else {})
        return best_state, {"main_results": main_results,
                            "dev_results": dev_results}


class LeaveRankingRunner(RankingRunner):
    """Ranking runner whose evaluation is the leave-frame variant of the
    SkipPredBaseline ReChorus fork (ascending-score rank of the leave frame
    with duration masking by ``c_frame_length`` / default-row trimming)."""

    def __init__(self, model: nn.Module, cfg: RunnerConfig, feat_table=None,
                 data_name: str = "", device=None):
        super().__init__(model, cfg, feat_table, device=device)
        self.data_name = data_name

    def evaluate(self, builder: FeedBuilder, state=None, topk=None,
                 metrics=None):
        predictions = self.predict(builder, state)
        durations = builder.situations.get("c_frame_length")
        return evaluate_leave_ranking(
            predictions, topk or self.topk, metrics or self.metrics,
            durations=durations, data_name=self.data_name, rng=self.rng)


class CTRRunner(RankingRunner):
    task = "ctr"

    def __init__(self, model: nn.Module, cfg: RunnerConfig, feat_table=None,
                 device=None):
        if not cfg.main_metric:
            cfg.main_metric = tuple(m.strip().upper()
                                    for m in cfg.metrics)[0]
        super().__init__(model, cfg, feat_table, device=device)
        self.main_metric = cfg.main_metric

    def _loss(self, predictions, batch):
        probs = torch.sigmoid(predictions[:, 0])
        if self.cfg.loss_n == "MSE":
            return mse_ctr_loss(probs, batch["label"], batch["row_mask"])
        return bce_ctr_loss(probs, batch["label"], batch["row_mask"])

    def predict(self, builder: FeedBuilder, state=None):
        self.load(state)
        preds, labels, users = [], [], []
        for feed in builder.batches(self.cfg.eval_batch_size, shuffle=False):
            out = self.eval_scores(feed)
            rm = feed["row_mask"]
            preds.append(1 / (1 + np.exp(-out[rm, 0])))
            labels.append(feed["label"][rm])
            users.append(feed["user_id"][rm])
        return (np.concatenate(preds), np.concatenate(labels),
                np.concatenate(users))

    def evaluate(self, builder: FeedBuilder, state=None, topk=None,
                 metrics=None):
        predictions, labels, users = self.predict(builder, state)
        out = evaluate_ctr(predictions, labels, metrics or self.metrics)
        out["WUAUC"] = evaluate_wuauc(predictions, labels, users)
        return out
