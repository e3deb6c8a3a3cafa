"""Command-line entry point of segment-level skip (leave-position) training
(port of ``segmminterest_tpu/tasks/skip_train.py``; the logit exporter
shares ``build_parser`` and ``config_from_args``).

Mirrors reference MMinterest/main_for_seq_leave_earlystop_SegMM.py
(argparse :474-576). Examples:

  # ID-mode training on a sample csv, on the CPU
  python -m segmminterest_tpu_torch.tasks.skip_train --sample_csv inter.csv \
      --user_input_type id --photo_input_type id --d_model 64 \
      --num_layers_enc 2 --nhead 4 --train_batch_size 256 --epochs 2 \
      --device cpu

  # the production training configuration on the card (K2 route, bf16)
  python -m segmminterest_tpu_torch.tasks.skip_train --path SegMM/ \
      --memmap SegMM_feat_memmap.dat \
      --lineid_map SegMM_photoidframeid2lineid.json \
      --compute_dtype bfloat16 --fuse_qkv 1 --table_quant int8 --remat 0

  # the same through the weight-interleaved version 2 of K2 (K6), which the
  # environment selects, as in the JAX package
  SEGMM_ATTN_V2=1 python -m segmminterest_tpu_torch.tasks.skip_train \
      --path SegMM/ --memmap SegMM_feat_memmap.dat \
      --lineid_map SegMM_photoidframeid2lineid.json \
      --compute_dtype bfloat16 --fuse_qkv 1 --table_quant int8 --remat 0

  # each whole encoder-layer stream in one kernel (K4); remat stays off
  python -m segmminterest_tpu_torch.tasks.skip_train --path SegMM/ \
      --memmap SegMM_feat_memmap.dat \
      --lineid_map SegMM_photoidframeid2lineid.json --fuse_layer 1
"""

from __future__ import annotations

import argparse
import json
import logging

from ..data.feature_store import FeatureStore
from ..data.reader import SeqReader
from ..engine.train import run_training
from ..utils.config import InterestConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="segment skip-prediction training")
    d = InterestConfig()
    p.add_argument("--path", type=str, default=d.path)
    p.add_argument("--sep", type=str, default=d.sep)
    p.add_argument("--sample_csv", type=str, default=None,
                   help="single raw interaction csv; performs the reference "
                        "per-user split (slice-0 mode)")
    p.add_argument("--min_interactions", type=int, default=100)
    p.add_argument("--num_warmup", type=int, default=80)
    p.add_argument("--history_max", type=int, default=d.history_max)
    p.add_argument("--memmap", type=str, default=None)
    p.add_argument("--lineid_map", type=str, default=None)
    p.add_argument("--train_batch_size", type=int, default=d.train_batch_size)
    p.add_argument("--valid_batch_size", type=int, default=d.valid_batch_size)
    p.add_argument("--test_batch_size", type=int, default=d.test_batch_size)
    p.add_argument("--d_model", type=int, default=d.d_model)
    p.add_argument("--nhead", type=int, default=d.nhead)
    p.add_argument("--num_layers_enc", type=int, default=d.num_layers_enc)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--user_input_type", type=str, default=d.user_input_type,
                   choices=["id", "image", "both"])
    p.add_argument("--photo_input_type", type=str, default=d.photo_input_type,
                   choices=["id", "image", "both"])
    p.add_argument("--fusion_heads", type=int, default=d.fusion_heads)
    p.add_argument("--learnable_bias", type=int, default=0)
    p.add_argument("--use_pe", type=int, default=1)
    p.add_argument("--ablation_type", type=str, default=d.ablation_type)
    p.add_argument("--learning_rate", type=float, default=d.learning_rate)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--loss_type", type=str, default=d.loss_type)
    p.add_argument("--loss_weight_surviveCE", type=float, default=1.0)
    p.add_argument("--loss_weight_interestBPR", type=float, default=1.0)
    p.add_argument("--loss_weight_interestCE", type=float, default=1.0)
    p.add_argument("--mask_loss", type=int, default=0)
    p.add_argument("--exposure_prob_type", type=str, default="ones",
                   choices=["ones", "statistics"])
    p.add_argument("--exposure_prob_path", type=str,
                   default="SegMM_ExposureProb.json")
    p.add_argument("--valid_step", type=int, default=d.valid_step)
    p.add_argument("--logging_step", type=int, default=d.logging_step)
    p.add_argument("--early_stop", type=int, default=d.early_stop)
    p.add_argument("--main_metrics", type=str, default=d.main_metrics)
    p.add_argument("--eval_type_list", type=str, default=d.eval_type_list)
    p.add_argument("--TOP_K_permutation", type=int, default=1)
    p.add_argument("--TOP_K_mask", type=int, default=0)
    p.add_argument("--eval_cold", type=str, default="", choices=["", "test"])
    p.add_argument("--test_model", type=int, default=1)
    p.add_argument("--save_logits", type=int, default=0)
    p.add_argument("--ckpt_dir", type=str, default=d.ckpt_dir)
    p.add_argument("--load", type=int, default=0,
                   help="resume from ckpt-latest before training")
    p.add_argument("--profile", type=int, default=0,
                   help="write a profiler trace of steps 2-5")
    p.add_argument("--record_train_detail", type=int, default=0)
    p.add_argument("--count_view_completion", type=int, default=0)
    p.add_argument("--plot_curves", type=int, default=0)
    p.add_argument("--draw_case", type=int, default=0,
                   help="save N case-study interest/gt heatmaps at test")
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype,
                   choices=["float32", "bfloat16"])
    p.add_argument("--remat", type=int, default=int(d.remat),
                   help="rematerialize encoder layers on backward")
    p.add_argument("--remat_scope", type=str, default=d.remat_scope,
                   choices=["layer", "attention"],
                   help="remat granularity: whole encoder layer, or the "
                        "attention block only (cheaper recompute, more "
                        "memory; wins at production table size)")
    p.add_argument("--fused_attention", type=int,
                   default=int(d.fused_attention),
                   help="two-block attention kernel (K1)")
    p.add_argument("--fuse_projections", type=int,
                   default=int(d.fuse_projections),
                   help="horizontally fuse the 12 per-stream QKV projections")
    p.add_argument("--fuse_qkv", type=int, default=int(d.fuse_qkv),
                   help="the six QKV projections of each attention inside "
                        "the two-block kernel (K2); needs --fused_attention 1")
    p.add_argument("--fuse_layer", type=int, default=int(d.fuse_layer),
                   help="each whole encoder-layer stream in one kernel "
                        "(K4) on the 'ours' path; supersedes "
                        "--fused_attention / --fuse_qkv there and turns "
                        "whole-layer remat off")
    p.add_argument("--table_quant", type=str, default=d.table_quant,
                   choices=["none", "int8"],
                   help="store the device feature table int8 + per-row scale "
                        "(half the bf16 footprint; the L1 normalization "
                        "cancels the scale — rounding error only)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the CUDA card (raises "
                        "without one — pass 'cpu' to run on the CPU)")
    p.add_argument("--distributed", type=int, default=0,
                   help="multi-GPU training (not ported yet: raises)")
    return p


def config_from_args(args: argparse.Namespace) -> InterestConfig:
    cfg = InterestConfig(
        path=args.path, sep=args.sep, history_max=args.history_max,
        sample_csv=args.sample_csv,
        train_batch_size=args.train_batch_size,
        valid_batch_size=args.valid_batch_size,
        test_batch_size=args.test_batch_size,
        d_model=args.d_model, nhead=args.nhead,
        num_layers_enc=args.num_layers_enc, dropout=args.dropout,
        user_input_type=args.user_input_type,
        photo_input_type=args.photo_input_type,
        fusion_heads=args.fusion_heads,
        learnable_bias=bool(args.learnable_bias), use_pe=bool(args.use_pe),
        ablation_type=args.ablation_type,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        epochs=args.epochs, seed=args.seed, loss_type=args.loss_type,
        mask_loss=bool(args.mask_loss),
        exposure_prob_type=args.exposure_prob_type,
        valid_step=args.valid_step, logging_step=args.logging_step,
        early_stop=args.early_stop, main_metrics=args.main_metrics,
        eval_type_list=args.eval_type_list,
        top_k_permutation=bool(args.TOP_K_permutation),
        top_k_mask=bool(args.TOP_K_mask), eval_cold=args.eval_cold,
        test_model=bool(args.test_model), save_logits=bool(args.save_logits),
        ckpt_dir=args.ckpt_dir, debug=bool(args.debug),
        load=bool(args.load), profile=bool(args.profile),
        record_train_detail=bool(args.record_train_detail),
        count_view_completion=bool(args.count_view_completion),
        plot_curves=bool(args.plot_curves),
        draw_case=args.draw_case,
        compute_dtype=args.compute_dtype, remat=bool(args.remat),
        remat_scope=args.remat_scope,
        fused_attention=bool(args.fused_attention),
        fuse_projections=bool(args.fuse_projections),
        fuse_qkv=bool(args.fuse_qkv), fuse_layer=bool(args.fuse_layer),
        table_quant=args.table_quant)
    cfg.loss_weight["surviveCE"] = args.loss_weight_surviveCE
    cfg.loss_weight["interestBPR"] = args.loss_weight_interestBPR
    cfg.loss_weight["interestCE"] = args.loss_weight_interestCE
    if args.exposure_prob_type == "statistics":
        with open(args.exposure_prob_path) as f:
            probs = json.load(f)
        cfg.exposure_prob = [probs[k] for k in probs]
    else:
        cfg.exposure_prob = [1.0] * 40
    if cfg.debug:
        cfg = cfg.replace(epochs=2, logging_step=1, valid_step=1,
                          train_batch_size=128, valid_batch_size=128,
                          test_batch_size=128)
    return cfg


def main(argv=None):
    """Read the data, train, test; print the JSON summary
    (skip_train.py:177-212)."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "--distributed (multi-GPU training) is not ported yet")
    cfg = config_from_args(args)
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
    if store is None and (cfg.user_input_type != "id"
                          or cfg.photo_input_type != "id"):
        raise SystemExit(
            f"--user_input_type={cfg.user_input_type} / "
            f"--photo_input_type={cfg.photo_input_type} need segment CLIP "
            "features: pass --memmap and --lineid_map, or use id/id.")
    result = run_training(cfg, reader, feature_store=store,
                          device=args.device)
    print(json.dumps({k: v for k, v in result.items()
                      if k in ("test_metrics", "cold_test_metrics",
                               "hot_test_metrics", "interactions_per_sec",
                               "steps", "work_dir", "kernel_launches")},
                     indent=2, default=str))
    return result


if __name__ == "__main__":
    main()
