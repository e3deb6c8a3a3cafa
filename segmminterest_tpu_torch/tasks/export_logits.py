"""Export per-interaction interest logits for Task-2 (SegRec) consumption
(port of ``segmminterest_tpu/tasks/export_logits.py``).

Behavioral spec: reference MMinterest/inference/save_logits_for_all_leave_SegMM.py
(:97-148): load the best checkpoint, run the eval-only forward (raw logits +
bias, no loss) over train/valid/test, and dump a dict keyed
``"{user_id}-{photo_id}-{time_ms}"`` (raw ids) -> 40 logits.

Usage:
  python -m segmminterest_tpu_torch.tasks.export_logits \
      --work_dir <dir with ckpt-*.pt> --sample_csv ... (or --path ...) \
      [--serving 1] [--memmap ... --lineid_map ...] [--device cpu]
      [--fuse_layer 1]

``--fuse_layer 1`` serves each encoder-layer stream through kernel K4; with
``--serving 1`` it supersedes the preset's ``fuse_qkv``, as in the JAX
package (export_logits.py:67). ``SEGMM_ATTN_V2=1`` in the environment runs
the preset's fuse_qkv streams through K6, the weight-interleaved version 2
of K2. The last log line lists the attention kernels launched.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import os.path as osp
from typing import Dict, List

import numpy as np

from ..core import attention
from ..data.dataset import BatchIterator
from ..data.feature_store import FeatureStore
from ..data.reader import SeqReader
from ..engine.checkpoint import CheckPointer
from ..engine.train import InterestEngine, log_kernel_launches
from ..utils.config import InterestConfig
from ..utils.io import dump_logits
from .skip_train import build_parser, config_from_args

logger = logging.getLogger(__name__)

# measured serving latency (ms per batch, batch already on the card) by
# batch size: the flagship both/both model, --serving preset, over a
# 3,920,483-row int8 table. Card: NVIDIA H100 80GB HBM3, power limit
# 700.00 W; measured by chip_smoke.py, phase "serving" ("latency B=...").
# B=128 waits on the host, so it moves with the machine's CPU (31.0 ms in
# another run of the same code).
SERVING_LATENCY_TABLE = ((1024, 106.9), (512, 55.0), (256, 28.8),
                         (128, 20.3))


def apply_serving_preset(cfg: InterestConfig,
                         latency_target_ms: float = 0.0) -> InterestConfig:
    """Pin the serving configuration: int8 feature table + per-row scales,
    projection-fused kernel K2, bfloat16 compute, no remat, and the eval
    batch size from the measured latency table — the largest batch whose
    per-batch latency meets ``latency_target_ms`` (0 = max throughput,
    B=1024)."""
    batch = SERVING_LATENCY_TABLE[0][0]
    if latency_target_ms > 0:
        fitting = [b for b, ms in SERVING_LATENCY_TABLE
                   if ms <= latency_target_ms]
        if fitting:
            batch = max(fitting)
        else:
            batch = SERVING_LATENCY_TABLE[-1][0]
            logger.warning(
                "no measured batch size meets %.1f ms (fastest measured "
                "point: B=%d at %.1f ms) — using B=%d",
                latency_target_ms, *SERVING_LATENCY_TABLE[-1],
                SERVING_LATENCY_TABLE[-1][0])
    return dataclasses.replace(
        cfg, table_quant="int8", fuse_qkv=True, compute_dtype="bfloat16",
        remat=False, test_batch_size=batch)


def export_split_logits(engine: InterestEngine, state,
                        iterator: BatchIterator) -> Dict[str, List[float]]:
    """{uid-pid-time: [40 raw logits]} for one split (reference :105-135)."""
    out: Dict[str, List[float]] = {}
    for batch in iterator:
        _, logits, _ = engine.eval_step(state, batch)
        logits = logits.cpu().numpy()
        rm = batch["row_mask"]
        for uid, pid, tms, row in zip(batch["user_raw"][rm],
                                      batch["video_raw"][rm],
                                      batch["time_ms"][rm], logits[rm]):
            out[f"{uid}-{pid}-{tms}"] = [float(x) for x in row]
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    p = build_parser()
    p.add_argument("--work_dir", type=str, required=True,
                   help="checkpoint dir holding ckpt-latest.pt / "
                        "ckpt-best-*.pt")
    p.add_argument("--ckpt_mode", type=str, default="best",
                   choices=["best", "latest"])
    p.add_argument("--out_dir", type=str, default="saved_logits")
    p.add_argument("--splits", type=str, default="train,dev,test")
    p.add_argument("--pth", type=int, default=0,
                   help="also torch.save the dict as a .pth twin, like the "
                        "reference exporter (PARITY S11)")
    p.add_argument("--parse_work_dir", type=int, default=1,
                   help="re-parse hyperparameters from the work_dir name, "
                        "as the reference inference scripts do "
                        "(save_logits_for_all_leave_SegMM.py:249-259); "
                        "explicit CLI model flags are then overridden")
    p.add_argument("--serving", type=int, default=0,
                   help="pin the serving preset: int8 table, fuse_qkv (K2), "
                        "bfloat16, no remat, eval batch from the measured "
                        "latency table")
    p.add_argument("--latency_target_ms", type=float, default=0.0,
                   help="with --serving: pick the largest measured batch "
                        "size whose per-batch latency meets this target "
                        "(0 = max throughput, B=1024)")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    if args.parse_work_dir:
        try:
            cfg = cfg.with_param_dir(args.work_dir)
            logger.info("parsed hyperparams from work_dir name: %s",
                        cfg.param_dir())
        except ValueError as e:
            logger.warning("%s — using CLI flags instead", e)
    if args.serving:
        cfg = apply_serving_preset(cfg, args.latency_target_ms)
        logger.info("serving preset: int8 table, fuse_qkv (K2 version %d), "
                    "bfloat16, no remat, eval batch %d",
                    2 if attention.ATTN_V2 else 1, cfg.test_batch_size)

    if cfg.sample_csv:
        reader = SeqReader.from_single_csv(
            cfg.sample_csv, history_max=cfg.history_max,
            min_interactions=args.min_interactions,
            num_warmup=args.num_warmup)
    else:
        reader = SeqReader.from_dir(cfg.path, sep=cfg.sep,
                                    history_max=cfg.history_max)
    store = None
    if args.memmap and args.lineid_map:
        store = FeatureStore.open(args.memmap, args.lineid_map)

    engine = InterestEngine(
        cfg, n_users=reader.n_users, n_items=reader.n_items,
        feature_table=np.asarray(store.feat) if store else None,
        device=args.device)
    ckpt = CheckPointer("main_metric", args.work_dir, mode="max")
    state = ckpt.load_checkpoint({"params": engine.init_state()["params"]},
                                 mode=args.ckpt_mode)["state"]

    os.makedirs(args.out_dir, exist_ok=True)
    all_logits: Dict[str, List[float]] = {}
    for split in args.splits.split(","):
        split = split.strip()
        key = {"valid": "dev"}.get(split, split)
        it = BatchIterator(reader, reader.tables[key], cfg.test_batch_size,
                           shuffle=False, feature_store=store, seed=cfg.seed,
                           transform=engine.batch_transform)
        split_logits = export_split_logits(engine, state, it)
        logger.info("%s: %d interactions", split, len(split_logits))
        all_logits.update(split_logits)

    out_path = osp.join(args.out_dir, "interest_logits.json")
    dump_logits(all_logits, out_path, pth=bool(args.pth))
    logger.info("wrote %d logit rows to %s", len(all_logits), out_path)
    log_kernel_launches()
    return out_path


if __name__ == "__main__":
    main()
