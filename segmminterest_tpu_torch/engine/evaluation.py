"""Leave-position evaluation metrics (the port's own copy of
``segmminterest_tpu/engine/evaluation.py``: numpy only, no scikit-learn).

Behavioral spec: reference MMinterest/models/my_evaluation.py
(TOP_K_leave :180-231, TOP_K_leave_mask :137-178, IoU_Sim :37-56,
ProbAUC_batch :73-80, predict_view_length :82-85, LeaveCTR :87-90,
main_eval_batch :264-357) and compute_final_result
(main_for_seq_leave_earlystop_SegMM.py:188-210).

These run host-side on numpy — ranking a 40-slot vector per row is trivially
cheap next to the device forward pass; keeping them off-device preserves the
reference's tie-breaking semantics (random permutation through a seedable RNG)
bit for bit. Everything is vectorized over the batch (the reference loops in
Python per row for IoU/CTR; we don't).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def _rank_of_leave(interests: np.ndarray, view_lengths: np.ndarray,
                   permutation: bool, rng: Optional[np.random.Generator]):
    """Rank (1-based) of the leave position when segments are sorted by
    ascending interest, with random-permutation tie-breaking
    (my_evaluation.py:193-209)."""
    bsz, seq_len = interests.shape
    if permutation:
        r = rng if rng is not None else np.random
        permuted = np.stack([r.permutation(seq_len) for _ in range(bsz)]) \
            if bsz else np.zeros((0, seq_len), dtype=np.int64)
        predictions = np.take_along_axis(interests, permuted, axis=1)
        sorted_indices = np.argsort(predictions, axis=1)
        target = np.argmax(permuted == view_lengths[:, None], axis=1)
        gt_rank = np.argmax(sorted_indices == target[:, None], axis=1) + 1
    else:
        sorted_indices = np.argsort(interests, axis=1)
        gt_rank = np.argmax(sorted_indices == view_lengths[:, None], axis=1) + 1
    return gt_rank


def _hr_ndcg(gt_rank: np.ndarray) -> Dict[str, float]:
    evaluations = {}
    for k in [1, 3, 5, 10]:
        hit = (gt_rank <= k).astype(np.float32)
        evaluations[f"HR@{k}"] = float(hit.mean()) if len(hit) else float("nan")
        evaluations[f"NDCG@{k}"] = float(
            (hit / np.log2(gt_rank + 1)).mean()) if len(hit) else float("nan")
    return evaluations


def top_k_leave(interests, view_lengths, mask_batch, permutation=1, test=0,
                rng: Optional[np.random.Generator] = None):
    """HR/NDCG@{1,3,5,10} of the leave position among all 40 slots; rows with
    view_length >= 40 (completed max-length views) are excluded
    (my_evaluation.py:180-231)."""
    interests = np.asarray(interests)
    seq_len = interests.shape[1]
    min_indices = np.argmin(interests, axis=1)  # for TOP1MSE (watch-time)
    vl = np.asarray(view_lengths).astype(np.int64).flatten()
    valid = vl < seq_len
    gt_rank = _rank_of_leave(interests[valid], vl[valid], permutation, rng)
    evaluations = _hr_ndcg(gt_rank)
    if test:
        return evaluations, min_indices
    return evaluations


def top_k_leave_mask(interests, view_lengths, mask_batch, permutation=1,
                     rng: Optional[np.random.Generator] = None):
    """Mask-aware variant: padded slots get interest 1.1 (ranked last) and
    completed views (view_length == duration) are excluded
    (my_evaluation.py:137-178)."""
    interests = np.asarray(interests)
    mask_batch = np.asarray(mask_batch)
    vl = np.asarray(view_lengths).astype(np.int64).flatten()
    valid = vl != mask_batch.sum(axis=1)
    interests = np.where(mask_batch[valid], interests[valid], 1.1)
    gt_rank = _rank_of_leave(interests, vl[valid], permutation, rng)
    return _hr_ndcg(gt_rank)


def iou_sim_batch(survival_probs, labels, view_lengths, durations):
    """Length-aware Jaccard similarity of the survival curve vs labels,
    vectorized over rows (my_evaluation.py:37-56).

    Per row: I_t = 1 - |label_t - S_t| over the first view_length segments,
    then (sum(I) + (duration - view_length)) / duration.
    """
    s = np.asarray(survival_probs, dtype=np.float64)
    lab = np.asarray(labels, dtype=np.float64)
    vl = np.asarray(view_lengths).astype(np.int64).flatten()
    dur = np.asarray(durations).astype(np.int64).flatten()
    seq = np.arange(s.shape[1])[None, :]
    watched = seq < vl[:, None]
    inter = np.where(watched, 1.0 - np.abs(lab - s), 0.0).sum(axis=1)
    return (inter + (dur - vl)) / np.maximum(dur, 1)


def _auc_score(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC-AUC via the rank-sum (Mann-Whitney) formula with average ranks for
    ties — identical to sklearn.roc_auc_score on binary labels."""
    labels = np.asarray(labels).astype(np.float64)
    scores = np.asarray(scores).astype(np.float64)
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC undefined with a single class")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(len(scores), dtype=np.float64)
    # average ranks over tie groups
    i = 0
    idx = np.arange(1, len(scores) + 1, dtype=np.float64)
    boundaries = np.flatnonzero(np.diff(sorted_scores) != 0)
    starts = np.concatenate([[0], boundaries + 1])
    ends = np.concatenate([boundaries + 1, [len(scores)]])
    for s_, e_ in zip(starts, ends):
        ranks[order[s_:e_]] = idx[s_:e_].mean()
    rank_pos = ranks[labels == 1].sum()
    return float((rank_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def prob_auc_batch(probs, labels, masks):
    """Flat AUC over all valid (row, segment) slots; labels -1 -> 0
    (my_evaluation.py:73-80)."""
    probs = np.asarray(probs)
    labels = np.asarray(labels)
    masks = np.asarray(masks).astype(bool)
    valid_probs = probs[masks].flatten()
    valid_labels = np.where(labels[masks] == -1, 0, labels[masks]).flatten()
    return _auc_score(valid_labels, valid_probs)


def draw_hotmap(interest_row, gt_row, uid_pid: str, out_dir: str):
    """Case-study heatmap of one interaction's interest vs leave labels
    (my_evaluation.py:233-262). Saves <out_dir>/<uid_pid>.png; without
    matplotlib it warns and skips."""
    import os
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.colors as mcolors
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning("matplotlib unavailable; skipping heatmap %s", uid_pid)
        return None
    cmap = mcolors.LinearSegmentedColormap.from_list(
        "custom_hot", [(0.0, mcolors.to_rgba("white")),
                       (0.5, mcolors.to_rgba("red")),
                       (1.0, mcolors.to_rgba("red"))])
    data = np.stack((np.asarray(interest_row, np.float64),
                     np.asarray(gt_row, np.float64)), axis=0)
    plt.figure(figsize=(8, 4))
    for j, title in enumerate(("interest", "leavegt")):
        plt.subplot(2, 1, j + 1)
        plt.imshow(data[j].reshape(1, -1), cmap=cmap,
                   vmin=0, vmax=1, aspect="auto")
        plt.title(title)
        for k2, v in enumerate(data[j]):
            plt.text(k2, 0, f"{v:.3f}", ha="center", va="center",
                     color="black", fontsize=5)
    plt.suptitle(uid_pid)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{uid_pid}.png")
    plt.savefig(path)
    plt.close()
    return path


def make_results_list(eval_types: List[str]) -> Dict[str, list]:
    results: Dict[str, list] = {}
    for et in eval_types:
        results[et] = []
    results["view_lengths"] = []
    return results


def main_eval_batch(interests, ground_truths, results_list: Dict[str, list],
                    top_k_mask: bool = False, top_k_permutation: bool = True,
                    logits=None,
                    rng: Optional[np.random.Generator] = None):
    """Per-batch metric accumulation (my_evaluation.py:264-357).

    interests: (B, 40) numpy — sigmoid(logits) * exposure_prob.
    ground_truths: (B, 40) numpy int labels in {1, 0, -1, -2}.
    Appends one entry per metric per batch (the reference averages the
    per-batch metric values, unweighted — replicated in compute_final_result).
    """
    interests = np.asarray(interests, dtype=np.float64)
    gts = np.asarray(ground_truths)
    mask_batch = gts != -2
    # survival via cumsum-log, the same transform as the device path
    with np.errstate(divide="ignore"):
        h_t = np.cumsum(np.log(interests), axis=1)
    survival_probs = np.exp(h_t)
    view_lengths = (gts == 1).sum(axis=1)
    durations = mask_batch.sum(axis=1)

    if "ProbAUC" in results_list:
        results_list["ProbAUC"].append(
            float(prob_auc_batch(survival_probs, gts, mask_batch)))

    if "TOP_K" in results_list:
        if top_k_mask:
            evaluations = top_k_leave_mask(interests, view_lengths, mask_batch,
                                           permutation=top_k_permutation, rng=rng)
        elif "TOP1MSE" in results_list:
            evaluations, top1pos = top_k_leave(
                interests, view_lengths, mask_batch,
                permutation=top_k_permutation, test=1, rng=rng)
            results_list["TOP1MSE"].append(top1pos)
        else:
            evaluations = top_k_leave(interests, view_lengths, mask_batch,
                                      permutation=top_k_permutation, rng=rng)
        for metric, value in evaluations.items():
            results_list.setdefault(metric, []).append(float(value))

    if "JaccardSim" in results_list:
        ious = iou_sim_batch(survival_probs, gts, view_lengths, durations)
        results_list["JaccardSim"].extend(float(x) for x in ious)

    if "LeaveMSE" in results_list:
        pred_vl = np.where(mask_batch, survival_probs, 0.0).sum(axis=1)
        results_list["LeaveMSE"].extend(float(x) for x in pred_vl)
        results_list["view_lengths"].extend(float(x) for x in view_lengths)
        if "duration_lengths" in results_list:
            results_list["duration_lengths"].extend(float(x) for x in durations)

    if "LeaveCTR" in results_list or "LeaveCTR_view" in results_list:
        # CTR = 1 - interest[vl-1]; vl==0 wraps to the last slot, exactly like
        # the reference's python indexing (my_evaluation.py:87-90).
        idx = (view_lengths - 1) % interests.shape[1]
        rows = np.arange(interests.shape[0])
        if "LeaveCTR" in results_list:
            results_list["LeaveCTR"].extend(
                float(x) for x in 1.0 - interests[rows, idx])
        if "LeaveCTR_view" in results_list:
            results_list["LeaveCTR_view"].extend(
                float(x) for x in 1.0 - survival_probs[rows, idx])

    if logits is not None and "MAES" in results_list:
        lg = np.asarray(logits, dtype=np.float64)
        e = np.exp(lg - lg.max(axis=1, keepdims=True))
        softmax_logits = e / e.sum(axis=1, keepdims=True)
        inv = 1.0 / softmax_logits
        leave_p = inv / inv.sum(axis=1, keepdims=True)
        pos = np.arange(lg.shape[1], dtype=np.float64)
        pred_leave = (leave_p * pos).sum(axis=1).astype(np.int64)
        results_list.setdefault("pred_leave", []).extend(
            int(x) for x in pred_leave)
        mae = np.abs(view_lengths - pred_leave).mean()
        # reference accumulates mae * batch_size into a scalar (:314-317)
        if not results_list["MAES"]:
            results_list["MAES"].append(0.0)
        results_list["MAES"][0] += float(mae * lg.shape[0])

    return results_list


def compute_final_result_watchtime(results_list: Dict[str, list],
                                   sample_count: Optional[int] = None
                                   ) -> Dict[str, object]:
    """Watch-time aggregation (main_for_WatchTime_Ours_SegMM.py:181-226):
    LeaveMSE -> (MSE, MAE) of the survival-sum view length, TOP1MSE ->
    (MSE, MAE) of the argmin-interest position, MAES normalized by sample
    count, pred_leave -> (MSE, MAE)."""
    final: Dict[str, object] = {}
    vl = np.asarray(results_list.get("view_lengths", []), dtype=np.float64)
    if "LeaveMSE" in results_list and len(vl):
        pred = np.asarray(results_list["LeaveMSE"], dtype=np.float64)
        final["LeaveMSE"] = (float(((vl - pred) ** 2).mean()),
                             float(np.abs(vl - pred).mean()))
    if "TOP1MSE" in results_list and results_list["TOP1MSE"]:
        pred = np.concatenate(results_list["TOP1MSE"]).astype(np.float64)
        final["TOP1MSE"] = (float(((vl - pred) ** 2).mean()),
                            float(np.abs(vl - pred).mean()))
    if "MAES" in results_list and results_list["MAES"] and sample_count:
        final["MAES"] = [m / sample_count for m in results_list["MAES"]]
    if "pred_leave" in results_list and results_list["pred_leave"]:
        pred = np.asarray(results_list["pred_leave"], dtype=np.float64)
        final["pred_leave"] = (float(((vl - pred) ** 2).mean()),
                               float(np.abs(vl - pred).mean()))
    for key, vals in results_list.items():
        if key in ("TOP_K", "LeaveMSE", "view_lengths", "duration_lengths",
                   "pred_leave", "TOP1MSE", "MAES"):
            continue
        if isinstance(vals, list) and vals:
            final[key] = float(sum(vals) / len(vals))
    return final


def compute_final_result(results_list: Dict[str, list]) -> Dict[str, float]:
    """Aggregate per-batch/per-row accumulators into final scalars
    (main_for_seq_leave_earlystop_SegMM.py:188-210)."""
    final: Dict[str, float] = {}
    if "LeaveMSE" in results_list:
        vl = np.asarray(results_list["view_lengths"], dtype=np.float64)
        pred = np.asarray(results_list["LeaveMSE"], dtype=np.float64)
        final["LeaveMSE"] = float(((vl - pred) ** 2).mean()) if len(vl) else float("nan")
    for key, vals in results_list.items():
        if key in ("TOP_K", "LeaveMSE", "view_lengths", "duration_lengths",
                   "pred_leave", "TOP1MSE"):
            continue
        if not isinstance(vals, list) or not vals:
            continue
        final[key] = float(sum(vals) / len(vals))
    return final
