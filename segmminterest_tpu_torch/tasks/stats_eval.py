"""Statistics-baselines evaluation CLI (port of
``segmminterest_tpu/tasks/stats_eval.py``; host only, as in the JAX
package).

Behavioral spec: reference MMinterest/evaluate_statistics_result_SegMM.py
(:341-459): compute corpus statistics over train+dev, then evaluate each
non-learned predictor through the SAME metric path as the model (a built-in
oracle for the metric implementation), with cold/hot item splits.

  python -m segmminterest_tpu_torch.tasks.stats_eval \
      --sample_csv inter.csv \
      --min_interactions 30 --num_warmup 10 \
      --test_types total_random,prob_view_pos_static
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np

from ..data.dataset import BatchIterator
from ..data.reader import SeqReader
from ..engine.evaluation import compute_final_result, main_eval_batch, \
    make_results_list
from ..engine.statistics import TEST_TYPES, compute_statistics, \
    synthesize_scores

logger = logging.getLogger(__name__)


def evaluate_test_type(test_type, stats, reader, args, exposure_prob,
                       rng: np.random.Generator,
                       eval_rng: np.random.Generator):
    eval_types = [s.strip() for s in args.eval_type_list.split(",")]
    results = make_results_list(eval_types)
    cold_results = make_results_list(eval_types) if args.eval_cold else None
    hot_results = make_results_list(eval_types) if args.eval_cold else None
    seen_items = set(stats["num_item_view_duration_pos"].keys())

    it = BatchIterator(reader, reader.tables["test"], args.batch_size,
                       shuffle=False, seed=args.seed)
    for step, batch in enumerate(it):
        if args.debug and step > 2:
            break
        rm = batch["row_mask"]
        gt = batch["label"][rm]
        uids = batch["user_raw"][rm]
        pids = batch["video_raw"][rm]
        durations = (gt != -2).sum(axis=1)
        scores = synthesize_scores(test_type, stats, uids, pids, durations,
                                   rng)
        # scores are already probabilities; the reference multiplies exposure
        # and feeds them as "interests" (reference :283-285,299)
        interests = scores * exposure_prob[None, :]
        if args.draw_case and step == 0:
            from ..engine.evaluation import draw_hotmap
            for r in range(min(args.draw_case, len(gt))):
                draw_hotmap(interests[r], np.clip(gt[r], 0, 1),
                            f"{test_type}-{uids[r]}-{pids[r]}", "figure")
        main_eval_batch(interests, gt, results,
                        top_k_mask=args.TOP_K_mask,
                        top_k_permutation=args.TOP_K_permutation,
                        rng=eval_rng)
        if args.eval_cold:
            cold = ~np.isin(pids, list(seen_items))
            if cold.any():
                main_eval_batch(interests[cold], gt[cold], cold_results,
                                top_k_mask=args.TOP_K_mask,
                                top_k_permutation=args.TOP_K_permutation,
                                rng=eval_rng)
            if (~cold).any():
                main_eval_batch(interests[~cold], gt[~cold], hot_results,
                                top_k_mask=args.TOP_K_mask,
                                top_k_permutation=args.TOP_K_permutation,
                                rng=eval_rng)
    out = {"all": compute_final_result(results)}
    if args.eval_cold:
        out["cold"] = compute_final_result(cold_results)
        out["hot"] = compute_final_result(hot_results)
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser()
    p.add_argument("--path", type=str, default="SegMM/")
    p.add_argument("--sep", type=str, default="\t")
    p.add_argument("--sample_csv", type=str, default=None)
    p.add_argument("--min_interactions", type=int, default=100)
    p.add_argument("--num_warmup", type=int, default=80)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--seed", type=int, default=22)  # reference :19
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--eval_type_list", type=str,
                   default="JaccardSim,ProbAUC,LeaveMSE,LeaveCTR,"
                           "LeaveCTR_view,TOP_K")
    p.add_argument("--TOP_K_permutation", type=int, default=1)
    p.add_argument("--TOP_K_mask", type=int, default=0)
    p.add_argument("--eval_cold", type=str, default="", choices=["", "test"])
    p.add_argument("--draw_case", type=int, default=0,
                   help="save N case-study heatmaps for each test type")
    p.add_argument("--exposure_prob_type", type=str, default="ones")
    p.add_argument("--exposure_prob_path", type=str,
                   default="SegMM_ExposureProb.json")
    p.add_argument("--test_types", type=str, default=",".join(TEST_TYPES))
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)

    if args.sample_csv:
        reader = SeqReader.from_single_csv(
            args.sample_csv, min_interactions=args.min_interactions,
            num_warmup=args.num_warmup)
    else:
        reader = SeqReader.from_dir(args.path, sep=args.sep)

    if args.exposure_prob_type == "statistics":
        with open(args.exposure_prob_path) as f:
            probs = json.load(f)
        exposure_prob = np.asarray([probs[k] for k in probs])
    else:
        exposure_prob = np.ones(40)

    stats = compute_statistics([reader.tables["train"], reader.tables["dev"]])
    rng = np.random.default_rng(args.seed)
    eval_rng = np.random.default_rng(args.seed)

    all_results = {}
    for test_type in [t.strip() for t in args.test_types.split(",")]:
        logger.info("evaluating %s", test_type)
        all_results[test_type] = evaluate_test_type(
            test_type, stats, reader, args, exposure_prob, rng, eval_rng)
        logger.info("%s: %s", test_type, all_results[test_type]["all"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(all_results, f, indent=2)
    print(json.dumps(all_results, indent=2))
    return all_results


if __name__ == "__main__":
    main()
