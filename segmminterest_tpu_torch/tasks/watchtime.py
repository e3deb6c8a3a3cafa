"""Watch-time prediction CLI: WLR / D2Q / TPM baselines and Ours (port of
``segmminterest_tpu/tasks/watchtime.py``).

Behavioral spec: reference MMinterest/watchtime/
  main_for_WatchTime_WLR.py  — BCE on play_time > 60th-percentile threshold;
        test: expected watch time = p * duration, HR1 (exact segment match of
        the rounded prediction) + MAE against play clamped to 40.
  main_for_WatchTime_D2Q.py  — MSE regression on min(play/40, 1); test preds
        round(output * 40).
  main_for_WatchTime_TPM.py  — tree label-encoding BCE + MSE on expected
        playtime + variance regularizer (Adam); test preds round(expected).
  main_for_WatchTime_Ours_SegMM.py — the skip-prediction harness with
        watch-time metrics, run by ``--method ours`` through the training
        engine with ``watchtime_metrics`` on (fp32, K1, layer remat in the
        CLI's default config).

The optimizers are the JAX package's: ``optax.adagrad`` (WLR, D2Q) is
written out in :class:`Adagrad` (accumulator from 0.1, ``g * rsqrt(sum +
1e-7)``; torch's Adagrad starts from 0 and divides by ``sqrt(sum) +
1e-10``); ``optax.adam`` is ``torch.optim.Adam`` with its defaults. TPM's
dropout draws from a torch generator seeded with ``--seed``.

  python -m segmminterest_tpu_torch.tasks.watchtime --method wlr \
      --sample_csv inter.csv --min_interactions 30 --num_warmup 10 \
      --epochs 1 [--device cpu]

  # Ours over segment features, on the card
  python -m segmminterest_tpu_torch.tasks.watchtime --method ours \
      --sample_csv inter.csv --memmap feat.dat --lineid_map lineid.json
"""

from __future__ import annotations

import json
import logging
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.dataset import BatchIterator
from ..data.feature_store import FeatureStore
from ..data.reader import SeqReader
from ..engine.optim import Adagrad
from ..engine.train import run_training
from ..models.watchtime import (D2QModel, TreeModel, playtime_percentiles,
                                tpm_encoded_playtime, tpm_loss)
from ..utils.device import resolve_device
from .skip_train import build_parser as _skip_train_parser
from .skip_train import config_from_args

logger = logging.getLogger(__name__)

# the eval list of the watch-time harness (JAX watchtime.py:230-237)
OURS_EVAL_TYPES = "JaccardSim,LeaveMSE,LeaveCTR,LeaveCTR_view,TOP_K"


def _bce(probs, labels, row_mask):
    p = torch.clamp(probs, 1e-7, 1 - 1e-7)
    ce = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    return (ce * row_mask).sum() / torch.clamp(row_mask.sum(), min=1)


def _mse(pred, target, row_mask):
    return ((pred - target).square() * row_mask).sum() \
        / torch.clamp(row_mask.sum(), min=1)


def _early_stop_min(history, patience):
    if patience <= 0 or len(history) <= patience:
        return False
    last = history[-patience:]
    if all(last[0] <= y for y in last[1:]):
        return True
    return len(history) - history.index(min(history)) > patience


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The keys the watch-time models read, on ``device``: ids and the
    duration (clipped to the embedding's 200 rows) as int64, play time and
    row mask as fp32."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)
    return {"user": t(batch["user_identity_id"], torch.int64),
            "item": t(batch["photo_identity_id"], torch.int64),
            "duration": t(np.clip(batch["duration"], 0, 199), torch.int64),
            "play": t(batch["play_time"], torch.float32),
            "row_mask": t(batch["row_mask"], torch.float32)}


def wlr_d2q_loss(model: D2QModel, b: Dict[str, torch.Tensor], method: str,
                 q_threshold: float) -> torch.Tensor:
    """WLR: BCE on play > the 60th-percentile threshold; D2Q: MSE on
    min(play / 40, 1)."""
    out = model(b["user"], b["item"], b["duration"])[:, 0]
    if method == "wlr":
        return _bce(out, (b["play"] > q_threshold).float(), b["row_mask"])
    return _mse(out, torch.clamp(b["play"] / 40.0, max=1.0), b["row_mask"])


def tpm_batch_loss(model: TreeModel, b: Dict[str, torch.Tensor], begins,
                   ends, args, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """TPM's loss on min(play / 40, 1) * 40; dropout only with a
    ``generator``."""
    probs = model(b["user"], b["item"], b["duration"], generator=generator)
    target = torch.clamp(b["play"] / 40.0, max=1.0) * 40.0
    loss, _ = tpm_loss(probs, target, begins, ends, args.wr_bucknum,
                       args.mse_weight, args.var_weight, b["row_mask"])
    return loss


def train_step(model, opt, loss_of: Callable, b) -> torch.Tensor:
    opt.zero_grad(set_to_none=True)
    loss = loss_of(model, b)
    loss.backward()
    opt.step()
    return loss.detach()


def _fit(args, reader, model, opt, train_loss: Callable, eval_loss: Callable,
         device, what: str) -> None:
    """The JAX task's loop (watchtime.py:111-127, :189-205): train steps,
    the mean dev loss every ``valid_step`` steps, early stop on its
    minimum. The losses stay on the device, read only by a validation.
    Logs the mean host ms of a step after the first, its batch's assembly
    and copy included (the copy from pageable memory waits for the step
    before it, so this is the step's time once the loop runs steadily)."""
    def make_iter(split, shuffle):
        return BatchIterator(reader, reader.tables[split], args.batch_size,
                             shuffle=shuffle, seed=args.seed)

    valid_losses, times, stop = [], [], False
    for epoch in range(args.epochs):
        if stop:
            break
        t0 = time.perf_counter()
        for step, batch in enumerate(make_iter("train", True)):
            if args.debug and step > 5:
                break
            train_step(model, opt, train_loss, to_device(batch, device))
            times.append(time.perf_counter() - t0)
            if (step + 1) % args.valid_step == 0:
                with torch.no_grad():
                    vl = float(np.mean([
                        float(eval_loss(model, to_device(b, device)))
                        for b in make_iter("dev", False)]))
                valid_losses.append(vl)
                logger.info("epoch %d step %d valid_loss %.6f", epoch, step,
                            vl)
                if _early_stop_min(valid_losses, args.early_stop):
                    stop = True
                    break
            t0 = time.perf_counter()
    if len(times) > 1:
        logger.info("%s: %d steps at B=%d, %.3f ms a step (steps 2-%d, "
                    "host included)", what, len(times), args.batch_size,
                    1e3 * float(np.mean(times[1:])), len(times))


def _hr1_mae(labels, preds):
    labels, preds = np.concatenate(labels), np.concatenate(preds)
    return (float((labels == preds).mean()),
            float(np.abs(labels - preds).mean()))


def _seeded(args, device, make):
    """A model made under ``--seed`` on the CPU (the same weights on every
    device), then moved to ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        return make().to(device)


class Baseline(NamedTuple):
    """A baseline as the CLI trains it. ``q_threshold``: WLR's and D2Q's
    60th percentile of play time; ``edges``: TPM's bucket begins and ends
    on the device."""
    model: torch.nn.Module
    opt: torch.optim.Optimizer
    train_loss: Callable
    eval_loss: Callable
    q_threshold: Optional[float] = None
    edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def make_baseline(args, reader, method: str, device,
                  dropout: bool = True) -> Baseline:
    """``method``'s model (made under ``--seed`` on the CPU, then moved to
    ``device``), optimizer and losses: WLR and D2Q on :class:`Adagrad`, TPM
    on ``torch.optim.Adam``, its training dropout drawn from a generator
    seeded with ``--seed`` (none with ``dropout`` False)."""
    train_t = reader.tables["train"]
    if method == "tpm":
        begins, ends = (torch.from_numpy(e).to(device) for e in
                        playtime_percentiles(train_t.playing_time,
                                             args.wr_bucknum))
        model = _seeded(args, device, lambda: TreeModel(
            max_item=reader.n_items, max_user=reader.n_users,
            class_num=args.wr_bucknum - 1, dropout=0.2))
        gen = torch.Generator(device=device).manual_seed(args.seed) \
            if dropout else None
        return Baseline(
            model, torch.optim.Adam(model.parameters(),
                                    lr=args.learning_rate),
            lambda m, b: tpm_batch_loss(m, b, begins, ends, args, gen),
            lambda m, b: tpm_batch_loss(m, b, begins, ends, args),
            edges=(begins, ends))
    q_threshold = float(np.quantile(train_t.playing_time / 5000.0, 0.6))
    model = _seeded(args, device, lambda: D2QModel(
        max_item=reader.n_items, max_user=reader.n_users))

    def loss_of(m, b):
        return wlr_d2q_loss(m, b, method, q_threshold)

    return Baseline(model, Adagrad(model.parameters(), args.learning_rate),
                    loss_of, loss_of, q_threshold=q_threshold)


def run_wlr_or_d2q(args, reader, method: str):
    device = resolve_device(args.device)
    base = make_baseline(args, reader, method, device)
    model, q_threshold = base.model, base.q_threshold
    _fit(args, reader, model, base.opt, base.train_loss, base.eval_loss,
         device, method)

    # test (WLR :167-198, D2Q :160-190)
    labels_all, preds_all = [], []
    with torch.no_grad():
        for batch in BatchIterator(reader, reader.tables["test"],
                                   args.batch_size, shuffle=False,
                                   seed=args.seed):
            b = to_device(batch, device)
            out = model(b["user"], b["item"], b["duration"])[:, 0] \
                .cpu().numpy()
            rm = batch["row_mask"]
            play = batch["play_time"].astype(np.float64)
            if method == "wlr":
                label = np.minimum(play, 40).astype(np.int64)
                preds = np.round(out * batch["duration"])
            else:
                label = (np.minimum(play / 40.0, 1.0) * 40).astype(np.int64)
                preds = np.round(out * 40)
            labels_all.append(label[rm])
            preds_all.append(preds[rm])
    hr1, mae = _hr1_mae(labels_all, preds_all)
    return {"HR1": hr1, "MAE": mae, "threshold": q_threshold}


def run_tpm(args, reader):
    device = resolve_device(args.device)
    base = make_baseline(args, reader, "tpm", device)
    model, (begins, ends) = base.model, base.edges
    _fit(args, reader, model, base.opt, base.train_loss, base.eval_loss,
         device, "tpm")

    labels_all, preds_all = [], []
    with torch.no_grad():
        for batch in BatchIterator(reader, reader.tables["test"],
                                   args.batch_size, shuffle=False,
                                   seed=args.seed):
            b = to_device(batch, device)
            probs = model(b["user"], b["item"], b["duration"])
            expected, _ = tpm_encoded_playtime(probs, args.wr_bucknum,
                                               begins, ends)
            expected = expected[:, 0].cpu().numpy()
            rm = batch["row_mask"]
            play = batch["play_time"].astype(np.float64)
            label = (np.minimum(play / 40.0, 1.0) * 40).astype(np.int64)
            labels_all.append(label[rm])
            preds_all.append(np.round(expected)[rm])
    hr1, mae = _hr1_mae(labels_all, preds_all)
    return {"HR1": hr1, "MAE": mae}


def run_ours(args, reader, feature_store: Optional[FeatureStore] = None):
    """The skip-prediction model trained and tested with the watch-time
    metrics; returns its test metrics."""
    cfg = config_from_args(args).replace(eval_type_list=OURS_EVAL_TYPES,
                                         watchtime_metrics=True)
    result = run_training(cfg, reader, feature_store=feature_store,
                          device=args.device)
    logger.info("ours: %d steps at B=%d, %.1f interactions/s (steps 2-%d, "
                "host included)", result["steps"], cfg.train_batch_size,
                result["interactions_per_sec"], result["steps"])
    return result["test_metrics"]


def build_parser():
    """skip_train's parser with the watch-time task's options."""
    p = _skip_train_parser()
    p.add_argument("--method", type=str, default="wlr",
                   choices=["wlr", "d2q", "tpm", "ours"])
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--wr_bucknum", type=int, default=32)
    p.add_argument("--mse_weight", type=float, default=0.2)
    p.add_argument("--var_weight", type=float, default=0.1)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)

    if args.sample_csv:
        reader = SeqReader.from_single_csv(
            args.sample_csv, min_interactions=args.min_interactions,
            num_warmup=args.num_warmup)
    else:
        reader = SeqReader.from_dir(args.path, sep=args.sep)

    if args.method in ("wlr", "d2q"):
        result = run_wlr_or_d2q(args, reader, args.method)
    elif args.method == "tpm":
        result = run_tpm(args, reader)
    else:
        store = None
        if args.memmap and args.lineid_map:
            store = FeatureStore.open(args.memmap, args.lineid_map)
        elif args.user_input_type != "id" or args.photo_input_type != "id":
            raise SystemExit(
                f"--user_input_type={args.user_input_type} / "
                f"--photo_input_type={args.photo_input_type} need segment "
                "CLIP features: pass --memmap and --lineid_map, or use id/id.")
        result = run_ours(args, reader, store)
    print(json.dumps(result, indent=2, default=str))
    return result


if __name__ == "__main__":
    main()
