"""The interest-task engine and the full training loop (port of
``segmminterest_tpu/engine/train.py``: InterestEngine :62-306,
``_valid_model`` :310-346, ``run_training`` :349-600).

Behavioral spec: reference MMinterest/main_for_seq_leave_earlystop_SegMM.py
(train loop :255-354, valid_model :132-186, final test :365-459).

* Parameters and the optimizer state are fp32. The forward and backward run
  in ``compute_dtype``: in bf16 the model holds a working copy (Dense and
  Embedding weights, the positional tables and w_xy in bf16; LayerNorm and
  the learnable bias in fp32, as the flax model uses them), refreshed from
  the fp32 parameters once per step or once per load, and its bf16
  gradients are widened to fp32 for the optimizer. In fp32 the model's
  parameters are the fp32 parameters.
* The optimizer is clip_by_global_norm followed by AdamW, as optax chains
  them (:85-88): the clip is ``g * max_norm / ||g||`` when ``||g|| >=
  max_norm`` (no epsilon), then ``torch.optim.AdamW`` (decoupled decay,
  eps 1e-8).
* The feature table lives on the device, optionally as int8 rows + a
  float32 per-row scale; a pre-quantized (int8, scale) pair already on the
  device is used as it is, without a copy. Batches carry int32 indices; the
  gather, dequantization, masking and L1 normalization run on the device.
* Batches travel host -> device from pinned memory with non-blocking
  copies; ``batch_transform`` starts them in the iterator's prefetch thread.
* Dropout: ``nn.Dropout`` draws from torch's global generator (seeded by
  ``run_training``); the attention kernels' seeds come from a CPU generator
  seeded from ``config.seed``, and the noPos ablation's position
  permutations from another, seeded from ``config.seed + 1``.

Mesh sharding (multi-GPU) is not ported yet.
"""

from __future__ import annotations

import json
import logging
import math
import os.path as osp
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..core import attention
from ..core.numerics import dequantize_rows, l1_normalize, quantize_table_int8
from ..data.dataset import BatchIterator
from ..data.feature_store import FeatureStore
from ..data.reader import SeqReader
from ..models.interest import SegInterestModel
from ..models.losses import compute_loss_dict
from ..utils.config import InterestConfig
from ..utils.device import resolve_device
from .checkpoint import CheckPointer
from .evaluation import (compute_final_result, compute_final_result_watchtime,
                         main_eval_batch, make_results_list, top_k_leave,
                         top_k_leave_mask)

logger = logging.getLogger(__name__)

DEVICE_KEYS = ("label", "user_identity_id", "photo_identity_id", "vid_mask",
               "user_mask", "row_mask", "photo_lines", "user_lines",
               "play_time", "duration")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def device_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: v for k, v in batch.items() if k in DEVICE_KEYS}


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm is at least
    ``max_norm`` every gradient becomes ``(g / norm) * max_norm``. Returns
    the norm (a device scalar; no host sync)."""
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < max_norm
    div = torch.where(keep, torch.ones_like(norm), norm)
    mul = torch.where(keep, torch.ones_like(norm),
                      torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div).mul_(mul)
    return norm


class InterestEngine:
    """Owns the model, the fp32 parameters, the optimizer and the device
    feature table. ``device=None`` means the card."""

    def __init__(self, config: InterestConfig, n_users: int, n_items: int,
                 feature_table=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.feature_mode = feature_table is not None
        self.dtype = _DTYPES[config.compute_dtype]
        if not self.feature_mode and (config.user_input_type != "id"
                                      or config.photo_input_type != "id"):
            raise ValueError(
                f"--user_input_type={config.user_input_type} / "
                f"--photo_input_type={config.photo_input_type} need a "
                "feature table (--memmap and --lineid_map); use id/id "
                "without one")

        self._table_quant = (config.table_quant == "int8"
                             and self.feature_mode)
        self.feat_table: Optional[torch.Tensor] = None
        self.feat_scale: Optional[torch.Tensor] = None
        feat_dim = 1024
        if self.feature_mode:
            if self._table_quant:
                if isinstance(feature_table, tuple):
                    table, scale = (_as_tensor(t) for t in feature_table)
                    if table.dtype != torch.int8 or \
                            scale.dtype != torch.float32:
                        raise ValueError(
                            "pre-quantized feature_table must be (int8 rows, "
                            f"float32 scales); got ({table.dtype}, "
                            f"{scale.dtype})")
                else:
                    table, scale = (torch.from_numpy(a) for a in
                                    quantize_table_int8(feature_table))
                self.feat_scale = scale.to(self.device)
            else:
                table = _as_tensor(np.asarray(feature_table))
                if self.dtype == torch.bfloat16:
                    table = table.to(torch.bfloat16)
            # .to() returns the same tensor when it already lives there
            self.feat_table = table.to(self.device)
            feat_dim = table.shape[1]

        self._dims = (n_users, n_items, feat_dim)
        model = self._new_model(config.seed).to(self.device)
        # the fp32 parameters the optimizer updates: the model's own in fp32,
        # a separate copy when the model works in another dtype
        if self.dtype == torch.float32:
            self.params: Dict[str, torch.Tensor] = dict(
                model.named_parameters())
        else:
            self.params = {n: nn.Parameter(p.detach().clone())
                           for n, p in model.named_parameters()}
            model.to_compute_dtype(self.dtype)
        self.model = model
        self.model.eval()
        self.optimizer = torch.optim.AdamW(
            list(self.params.values()), lr=config.learning_rate,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=config.weight_decay)
        self.seed_generator = torch.Generator().manual_seed(config.seed)
        # noPos's permutations: a stream of their own, as the JAX package
        # folds 1 into its step key for them (train.py:230)
        self.permute_generator = torch.Generator().manual_seed(
            config.seed + 1)
        self.model.set_seed_generator(self.seed_generator,
                                      self.permute_generator)
        self.exposure_prob = torch.tensor(
            config.exposure_prob or [1.0] * 40, dtype=torch.float32,
            device=self.device)
        # the params / optimizer state last written into the model
        self._loaded_params = self.params
        self._opt_state = None
        self.last_grad_norm: Optional[torch.Tensor] = None

    def _new_model(self, seed: int) -> SegInterestModel:
        """The model in fp32 on the host, initialised from ``seed`` (so the
        weights do not depend on the device or the compute dtype)."""
        cfg = self.config
        n_users, n_items, feat_dim = self._dims
        model = SegInterestModel(
            d_model=cfg.d_model, num_heads=cfg.nhead,
            num_layers=cfg.num_layers_enc, ff_dim=cfg.d_model,
            n_users=n_users, n_items=n_items, dropout=cfg.dropout,
            user_input=cfg.user_input_type,
            photo_input=cfg.photo_input_type,
            fusion_heads=cfg.fusion_heads,
            learnable_bias=cfg.learnable_bias, use_pe=cfg.use_pe,
            ablation=cfg.ablation_type, feat_dim=feat_dim,
            fused_attention=cfg.fused_attention, fuse_qkv=cfg.fuse_qkv,
            remat=cfg.remat, remat_scope=cfg.remat_scope,
            fuse_projections=cfg.fuse_projections, fuse_dual=cfg.fuse_dual,
            fuse_layer=cfg.fuse_layer)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return model

    # ------------------------------------------------------------------
    def _refresh_working_copy(self) -> None:
        if self.dtype == torch.float32:
            return
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(self.params[n])

    def _state(self) -> Dict[str, Any]:
        self._opt_state = self.optimizer.state_dict()
        self._loaded_params = self.params
        return {"params": self.params, "opt_state": self._opt_state}

    def init_state(self, seed: Optional[int] = None) -> Dict[str, Any]:
        """Re-initialise the parameters from ``seed`` (when given) with a
        fresh optimizer, and return the state ``{"params", "opt_state"}``:
        the fp32 parameters by name (the engine's own tensors) and the
        optimizer's ``state_dict``."""
        if seed is not None:
            fresh = dict(self._new_model(seed).named_parameters())
            with torch.no_grad():
                for n, p in self.params.items():
                    p.copy_(fresh[n])
            self.optimizer.state.clear()
            self._refresh_working_copy()
        return self._state()

    def _sync(self, state: Dict[str, Any]) -> None:
        """Write a state that is not the engine's current one into the fp32
        parameters (and the working copy) and the optimizer; a state seen
        before costs nothing."""
        if state["params"] is not self._loaded_params:
            with torch.no_grad():
                for n, p in self.params.items():
                    src = state["params"][n]
                    if src is not p:
                        p.copy_(src)
            self._refresh_working_copy()
            self._loaded_params = state["params"]
        opt = state.get("opt_state")
        if opt is not None and opt is not self._opt_state:
            self.optimizer.load_state_dict(opt)
            self._opt_state = opt

    def _model_inputs(self, batch: Dict[str, torch.Tensor]):
        """Device batch -> (usr_image, usr_id, usr_mask, vid_image, vid_id,
        vid_mask); in feature mode the gathers + L1 normalization
        (main_…SegMM.py:272-273) run on the device here."""
        usr_id = batch["user_identity_id"]
        vid_id = batch["photo_identity_id"]
        vid_mask = batch["vid_mask"]
        usr_mask = batch["user_mask"]
        if self.feature_mode:
            def gather(ids):
                ids = ids.clamp(min=0).long()
                if self._table_quant:
                    return dequantize_rows(self.feat_table[ids],
                                           self.feat_scale[ids], self.dtype)
                return self.feat_table[ids]

            photo = gather(batch["photo_lines"])
            photo = photo * vid_mask[..., None].to(photo.dtype)
            user = gather(batch["user_lines"])
            user = user * usr_mask[..., None].to(user.dtype)
            usr_image, vid_image = l1_normalize(user), l1_normalize(photo)
        else:
            usr_image, vid_image = usr_id, vid_id
            usr_mask = torch.ones((usr_id.shape[0], 1), dtype=torch.bool,
                                  device=usr_id.device)
        return usr_image, usr_id, usr_mask, vid_image, vid_id, vid_mask

    def _loss_from_logits(self, logits, batch):
        cfg = self.config
        return compute_loss_dict(
            logits.float(), batch["label"], batch["row_mask"],
            self.exposure_prob, cfg.loss_type_list, cfg.loss_weight,
            cfg.mask_loss)

    def _put(self, v) -> torch.Tensor:
        t = _as_tensor(v)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def batch_transform(self, batch: Dict[str, np.ndarray]):
        """Start the host -> device copy of the device keys and attach the
        device views under '_dev', keeping every host field numpy. Passed as
        BatchIterator(transform=...) so the copy starts in the prefetch
        thread and overlaps device compute."""
        out = dict(batch)
        out["_dev"] = {k: self._put(v)
                       for k, v in device_batch(batch).items()}
        return out

    def put_batch(self, batch) -> Dict[str, torch.Tensor]:
        if "_dev" in batch:
            return batch["_dev"]
        return {k: self._put(v) for k, v in device_batch(batch).items()}

    # ------------------------------------------------------------------
    def train_step(self, state: Dict[str, Any], batch):
        """One optimizer step (train.py:225-236): forward in training mode
        (dropout on), the loss dict, backward, fp32 gradients, clip, AdamW,
        working copy refreshed. Returns ``(state, loss_dict)``; the losses
        stay on the device."""
        self._sync(state)
        dev = self.put_batch(batch)
        self.model.train()
        try:
            logits = self.model(*self._model_inputs(dev))
            loss_dict = self._loss_from_logits(logits, dev)
            self.model.zero_grad(set_to_none=True)
            loss_dict["loss"].backward()
        finally:
            self.model.eval()
        if self.dtype == torch.float32:
            grads = []
            for p in self.params.values():
                if p.grad is None:  # unused this step: optax sees zeros
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
        else:
            grads = []
            for n, w in self.model.named_parameters():
                p = self.params[n]
                p.grad = (w.grad.float() if w.grad is not None
                          else torch.zeros_like(p))
                grads.append(p.grad)
        # the global norm before clipping, for logs and checks
        self.last_grad_norm = clip_by_global_norm_(
            grads, self.config.grad_clip_norm)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.model.zero_grad(set_to_none=True)
        self._refresh_working_copy()
        return self._state(), {k: v.detach() for k, v in loss_dict.items()}

    def eval_step(self, state: Dict[str, Any], batch):
        """Forward of one batch without dropout (train.py:238-245):
        ``(loss_dict, logits (B, 40) fp32, interests)`` with
        ``interests = sigmoid(logits) * exposure_prob``. ``state`` is one
        ``init_state`` or ``train_step`` returned, or a checkpoint loaded
        into one (only its params are read)."""
        self._sync({"params": state["params"]})
        with torch.inference_mode():
            dev = self.put_batch(batch)
            logits = self.model(*self._model_inputs(dev)).float()
            loss_dict = self._loss_from_logits(logits, dev)
            interests = torch.sigmoid(logits) * self.exposure_prob[None, :]
        return loss_dict, logits, interests


# ----------------------------------------------------------------------
def _valid_model(engine: InterestEngine, valid_iter: BatchIterator,
                 total_metrics: Dict[str, list], state,
                 rng: Optional[np.random.Generator] = None,
                 max_batches: Optional[int] = None):
    """Validation pass (main_…SegMM.py:132-186): per-batch loss dict + leave
    ranking metrics, averaged over batches."""
    cfg = engine.config
    tmp: Dict[str, list] = {k: [] for k in total_metrics}
    for step, batch in enumerate(valid_iter):
        if max_batches is not None and step >= max_batches:
            break
        loss_dict, _, interests = engine.eval_step(state, batch)
        loss_dict = {k: float(v) for k, v in loss_dict.items()}
        interests = interests.cpu().numpy()
        gt = batch["label"]
        rm = batch["row_mask"]
        interests, gt = interests[rm], gt[rm]
        view_lengths = (gt == 1).sum(axis=1)
        mask_batch = gt != -2
        if cfg.top_k_mask:
            evaluations = top_k_leave_mask(interests, view_lengths, mask_batch,
                                           permutation=cfg.top_k_permutation,
                                           rng=rng)
        else:
            evaluations = top_k_leave(interests, view_lengths, mask_batch,
                                      permutation=cfg.top_k_permutation,
                                      rng=rng)
        tmp["valid_loss"].append(loss_dict["loss"])
        for key in tmp:
            if key in loss_dict and key != "loss":
                tmp[key].append(loss_dict[key])
            elif key in evaluations:
                tmp[key].append(float(evaluations[key]))
    for key in tmp:
        if tmp[key]:
            total_metrics[key].append(sum(tmp[key]) / len(tmp[key]))
    return total_metrics


def _plot_curves(work_dir, curves) -> None:
    """Train/valid loss curves (main_…SegMM.py:462-470); without matplotlib
    it warns and skips."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning("matplotlib unavailable; skipping loss curves")
        return
    for name, ys in curves:
        plt.figure(figsize=(10, 8))
        plt.plot(range(len(ys)), ys)
        plt.title(name.replace("_", " ").title())
        plt.savefig(osp.join(work_dir, f"{name}.png"))
        plt.close()


def run_training(config: InterestConfig, reader: SeqReader,
                 feature_store: Optional[FeatureStore] = None,
                 work_dir: Optional[str] = None, device=None,
                 feature_table=None) -> Dict[str, Any]:
    """Full train -> validate -> early-stop -> test pipeline
    (main_…SegMM.py:213-459). Returns a dict with the final test metrics and
    the checkpoint directory. ``feature_table`` (e.g. an int8 pair already
    on the card) replaces the store's table; the store still maps segments
    to rows."""
    cfg = config
    work_dir = work_dir or osp.join(cfg.ckpt_dir, cfg.param_dir())
    ckpt = CheckPointer("main_metric", work_dir, mode="max")
    torch.manual_seed(cfg.seed)  # nn.Dropout's masks

    store = feature_store
    if feature_table is None and store is not None:
        feature_table = np.asarray(store.feat)
    engine = InterestEngine(cfg, n_users=reader.n_users,
                            n_items=reader.n_items,
                            feature_table=feature_table, device=device)
    if cfg.fused_attention and cfg.fuse_qkv:
        logger.info("projection-fused attention: K2 version %d "
                    "(SEGMM_ATTN_V2=%d)", 2 if attention.ATTN_V2 else 1,
                    int(attention.ATTN_V2))

    def make_iter(split, batch_size, shuffle, seed):
        return BatchIterator(reader, reader.tables[split], batch_size,
                             shuffle=shuffle, feature_store=store, seed=seed,
                             transform=engine.batch_transform)

    train_iter = make_iter("train", cfg.train_batch_size, True, cfg.seed)
    valid_iter = make_iter("dev", cfg.valid_batch_size, False, cfg.seed)
    test_iter = make_iter("test", cfg.test_batch_size, False, cfg.seed)

    eval_rng = np.random.default_rng(cfg.seed)
    state = engine.init_state()
    start_epoch = 0
    if cfg.load and ckpt.has_latest():
        # resume from latest (CheckPointer mode='latest', preemption
        # recovery): the port's ckpt-latest.pt or the JAX package's
        # ckpt-latest.msgpack, params and AdamW state
        loaded = ckpt.load_checkpoint(state, mode="latest")
        state = loaded["state"]
        start_epoch = int(loaded["num_epochs"])
        logger.info("resumed from %s at epoch %d", work_dir, start_epoch)

    total_train_loss: list = []
    total_metrics: Dict[str, list] = {"train_loss": [], "valid_loss": []}
    for lt in cfg.loss_type_list:
        total_metrics[lt] = []
    for et in cfg.eval_types:
        if et == "TOP_K":
            for k in (1, 3, 5, 10):
                for m in ("HR", "NDCG"):
                    total_metrics[f"{m}@{k}"] = []
        else:
            total_metrics[et] = []

    max_valid_batches = 4 if cfg.debug else None
    logger.info("Evaluation before training")
    total_metrics["train_loss"].append(0.0)
    total_metrics = _valid_model(engine, valid_iter, total_metrics, state,
                                 eval_rng, max_valid_batches)

    train_videos_set = set()
    stop_flag = False
    global_step = 0
    step_times: list = []
    n_interactions = 0
    record_dict_list = []
    equal_num: Dict[str, int] = {}
    profiler, profiled = None, False
    for epoch in range(start_epoch, cfg.epochs):
        if stop_flag:
            break
        epoch_st = time.time()
        if cfg.count_view_completion:
            equal_num.setdefault("train", 0)
            equal_num.setdefault("train_all", 0)
        for local_step, batch in enumerate(train_iter):
            if cfg.debug and local_step > 3:
                break
            if cfg.profile and not profiled and local_step == 2:
                # torch.profiler trace of a few steady-state steps
                profiler = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]
                    + ([torch.profiler.ProfilerActivity.CUDA]
                       if engine.device.type == "cuda" else []),
                    on_trace_ready=torch.profiler.tensorboard_trace_handler(
                        osp.join(work_dir, "profile")))
                profiler.start()
            st = time.time()
            state, loss_dict = engine.train_step(state, batch)
            loss = float(loss_dict["loss"])
            if not math.isfinite(loss):
                logger.error("non-finite loss %.4f at step %d — aborting "
                             "(resume with load=True from ckpt-latest)",
                             loss, global_step)
                stop_flag = True
                break
            if profiler is not None and local_step == 5:
                profiler.stop()
                profiler, profiled = None, True
                logger.info("profiler trace written to %s",
                            osp.join(work_dir, "profile"))
            if cfg.count_view_completion:
                lab = batch["label"][batch["row_mask"]]
                equal_num["train"] += int(
                    ((lab == 1).sum(1) == (lab != -2).sum(1)).sum())
                equal_num["train_all"] += int(batch["row_mask"].sum())
            total_train_loss.append(loss)
            n_interactions += int(batch["row_mask"].sum())
            global_step += 1
            step_times.append(time.time() - st)
            if cfg.eval_cold:
                train_videos_set.update(
                    batch["video_raw"][batch["row_mask"]].tolist())
            if (local_step + 1) % cfg.logging_step == 0:
                logger.info("train_loss=%.6f step=%d step_time=%.4fs",
                            loss, global_step, step_times[-1])
            if (local_step + 1) % cfg.valid_step == 0:
                total_metrics["train_loss"].append(loss)
                total_metrics = _valid_model(engine, valid_iter,
                                             total_metrics, state, eval_rng,
                                             max_valid_batches)
                main_val = total_metrics[cfg.main_metrics][-1]
                logger.info("valid_loss=%.6f %s=%.6f step=%d",
                            total_metrics["valid_loss"][-1],
                            cfg.main_metrics, main_val, global_step)
                ckpt.save_checkpoint(state, epoch,
                                     metric_vals={"main_metric": main_val})
                if cfg.record_train_detail:
                    # gt/interest arrays per validation for offline
                    # inspection (main_…SegMM.py:241-242,314-327)
                    _, _, tr_int = engine.eval_step(state, batch)
                    record_dict_list.append({
                        "epoch": epoch, "step": local_step,
                        "train_loss": loss,
                        "train_gt": batch["label"][batch["row_mask"]],
                        "train_interests":
                            tr_int.cpu().numpy()[batch["row_mask"]]})
                history = total_metrics[cfg.main_metrics]
                if cfg.early_stop > 0:
                    if len(history) > cfg.early_stop:
                        last = history[-cfg.early_stop:]
                        if all(last[0] >= y for y in last[1:]):
                            stop_flag = True
                            break
                    if len(history) - history.index(max(history)) > \
                            cfg.early_stop:
                        stop_flag = True
                        break
        logger.info("epoch %d done in %.1fs avg_loss=%.6f", epoch,
                    time.time() - epoch_st,
                    sum(total_train_loss) / max(len(total_train_loss), 1))
    if profiler is not None:  # fewer than 6 steps in the epoch
        profiler.stop()
    if stop_flag:
        logger.info("Early stop based on dev result.")

    result: Dict[str, Any] = {
        "work_dir": work_dir,
        "valid_metrics": total_metrics,
        "steps": global_step,
        "interactions_per_sec": (n_interactions / sum(step_times[1:])
                                 if len(step_times) > 1 else 0.0),
    }
    if cfg.count_view_completion:
        result["view_completion"] = equal_num
        logger.info("view completion counts: %s", equal_num)
    if cfg.record_train_detail and record_dict_list:
        np.save(osp.join(work_dir, "record_logit_gt.npy"),
                np.asarray(record_dict_list, dtype=object),
                allow_pickle=True)
        with open(osp.join(work_dir, "valid_loss_metrics.json"), "w") as f:
            json.dump(total_metrics, f)
    if cfg.plot_curves and total_train_loss:
        _plot_curves(work_dir, (("train_loss", total_train_loss),
                                ("valid_loss", total_metrics["valid_loss"])))

    if cfg.test_model and global_step > 0:
        state = ckpt.load_checkpoint(state, mode="best")["state"]
        results_list = make_results_list(cfg.eval_types)
        cold_results = (make_results_list(cfg.eval_types)
                        if cfg.eval_cold else None)
        hot_results = (make_results_list(cfg.eval_types)
                       if cfg.eval_cold else None)
        if cfg.watchtime_metrics:
            for rl in (results_list, cold_results, hot_results):
                if rl is not None:
                    rl["duration_lengths"] = []
                    rl["TOP1MSE"] = []
                    rl["MAES"] = []
                    rl["pred_leave"] = []
        saved_logits = [] if cfg.save_logits else None
        for local_step, batch in enumerate(test_iter):
            if cfg.debug and local_step > 3:
                break
            _, logits, interests = engine.eval_step(state, batch)
            rm = batch["row_mask"]
            interests = interests.cpu().numpy()[rm]
            gt = batch["label"][rm]
            if cfg.draw_case and local_step == 0:
                # case-study heatmaps for the first rows of the first test
                # batch (my_evaluation.py:233-262 via --draw_case)
                from .evaluation import draw_hotmap
                fig_dir = osp.join(work_dir, "figure")
                for r in range(min(cfg.draw_case, len(gt))):
                    draw_hotmap(interests[r], np.clip(gt[r], 0, 1),
                                f"{batch['user_raw'][rm][r]}-"
                                f"{batch['video_raw'][rm][r]}", fig_dir)
            if saved_logits is not None:
                saved_logits.append(np.concatenate(
                    [interests, gt,
                     batch["user_raw"][rm][:, None],
                     batch["video_raw"][rm][:, None]], axis=1))
            main_eval_batch(interests, gt, results_list,
                            top_k_mask=cfg.top_k_mask,
                            top_k_permutation=cfg.top_k_permutation,
                            logits=(logits.cpu().numpy()[rm]
                                    if cfg.watchtime_metrics else None),
                            rng=eval_rng)
            if cfg.eval_cold:
                vids = batch["video_raw"][rm]
                cold = ~np.isin(vids, list(train_videos_set))
                if cold.any():
                    main_eval_batch(interests[cold], gt[cold], cold_results,
                                    top_k_mask=cfg.top_k_mask,
                                    top_k_permutation=cfg.top_k_permutation,
                                    rng=eval_rng)
                if (~cold).any():
                    main_eval_batch(interests[~cold], gt[~cold], hot_results,
                                    top_k_mask=cfg.top_k_mask,
                                    top_k_permutation=cfg.top_k_permutation,
                                    rng=eval_rng)
        if cfg.watchtime_metrics:
            n_test = len(results_list.get("view_lengths", []))
            result["test_metrics"] = compute_final_result_watchtime(
                results_list, n_test)
        else:
            result["test_metrics"] = compute_final_result(results_list)
        if cfg.eval_cold:
            result["cold_test_metrics"] = compute_final_result(cold_results)
            result["hot_test_metrics"] = compute_final_result(hot_results)
        if saved_logits is not None and saved_logits:
            arr = np.concatenate(saved_logits, axis=0)
            np.save(osp.join(work_dir, "save_logits_gt_eval.npy"), arr)
        with open(osp.join(work_dir, "final_results.json"), "w") as f:
            json.dump(result["test_metrics"], f, indent=2)
        logger.info("Test result: %s", result["test_metrics"])
    result["kernel_launches"] = log_kernel_launches()
    return result


def log_kernel_launches() -> Dict[str, int]:
    """The attention kernels this process has launched so far (one count
    per wrapper call, core/attention.py:LAUNCHES), logged as JSON."""
    launches = {k: v for k, v in attention.LAUNCHES.items() if v}
    logger.info("kernel launches: %s", json.dumps(launches))
    return launches
