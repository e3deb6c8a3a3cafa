"""Statistics-based null predictors for leave-position evaluation (port of
``segmminterest_tpu/engine/statistics.py``, numpy only: with the same
``np.random.Generator`` the scores are bit for bit the JAX package's).

Behavioral spec: reference MMinterest/evaluate_statistics_result_SegMM.py
(statistics_dataset :28-119 — corpus view/leave probability tables over
train+dev; main :150-330 — score synthesis per test_type). These double as
metric-implementation oracles (SURVEY.md §4): they feed the exact same
main_eval_batch path as the learned model.

Counting quirks replicated exactly:
 * a view of length vl < 40 increments every position EXCEPT vl itself
   (the leave slot joins neither numerator nor denominator, :69-73);
 * per-user/item positional denominators count every interaction at all 40
   positions regardless of duration (:85,94);
 * positional view probability divides by the number of cases, not by
   positional exposure (:98).

The reference accumulates these with a per-row python loop over the full
train+dev pass; here they are numpy bincounts over the pre-tensorized tables.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..data.labels import MAX_SEGMENTS

L = MAX_SEGMENTS


def _viewed_pos_counts(vl: np.ndarray) -> np.ndarray:
    """sum over rows of [1]*L minus the one-hot of the leave slot (vl < L)."""
    n = len(vl)
    counts = np.full(L, n, dtype=np.float64)
    leave = vl[vl < L]
    counts -= np.bincount(leave, minlength=L)[:L]
    return counts


def compute_statistics(tables) -> Dict[str, object]:
    """Probability tables over the concatenated train+dev split
    (statistics_dataset, reference :28-119)."""
    vl = np.concatenate([(t.labels == 1).sum(axis=1) for t in tables])
    dur = np.concatenate([(t.labels != -2).sum(axis=1) for t in tables])
    uids = np.concatenate([t.user_raw for t in tables])
    pids = np.concatenate([t.video_raw for t in tables])
    n = len(vl)

    prob_view_all = float(vl.sum() / dur.sum())
    prob_view_pos = _viewed_pos_counts(vl) / n

    num_view_duration_pos = np.zeros((L, L), np.float64)
    num_leave_duration_pos = np.zeros((L, L + 1), np.float64)
    for d in range(1, L + 1):
        sel = dur == d
        if sel.any():
            num_view_duration_pos[d - 1] = _viewed_pos_counts(vl[sel])
            num_leave_duration_pos[d - 1] = np.bincount(vl[sel],
                                                        minlength=L + 1)
    row_sums = num_view_duration_pos.sum(axis=1, keepdims=True)
    row_sums[row_sums == 0] = 1
    prob_view_duration_pos = num_view_duration_pos / row_sums
    num_leave_pos = np.bincount(vl, minlength=L + 1).astype(np.float64)
    prob_leave_pos = num_leave_pos / num_leave_pos.sum()
    row_sums = num_leave_duration_pos.sum(axis=1, keepdims=True)
    row_sums[row_sums == 0] = 1
    prob_leave_duration_pos = num_leave_duration_pos / row_sums

    def per_id_tables(ids):
        uniq, inv = np.unique(ids, return_inverse=True)
        k = len(uniq)
        view_sum = np.bincount(inv, weights=vl, minlength=k)
        dur_sum = np.bincount(inv, weights=dur, minlength=k)
        case_count = np.bincount(inv, minlength=k).astype(np.float64)
        viewed_pos = np.tile(case_count[:, None], (1, L))
        leave_rows = vl < L
        np.subtract.at(viewed_pos, (inv[leave_rows], vl[leave_rows]), 1.0)
        return uniq, view_sum, dur_sum, case_count, viewed_pos

    u_uniq, u_view, u_dur, u_cases, u_viewpos = per_id_tables(uids)
    p_uniq, p_view, p_dur, p_cases, p_viewpos = per_id_tables(pids)

    prob_user_view_all = {int(u): (0.0 if d == 0 else v / d)
                          for u, v, d in zip(u_uniq, u_view, u_dur)}
    prob_user_view_pos = {int(u): u_viewpos[i] / u_cases[i]
                          for i, u in enumerate(u_uniq)}
    item_view_duration_all = {int(p): (v, d)
                              for p, v, d in zip(p_uniq, p_view, p_dur)}
    item_view_duration_pos = {int(p): (p_viewpos[i], p_cases[i])
                              for i, p in enumerate(p_uniq)}

    return {
        "prob_view_all": prob_view_all,
        "prob_view_pos": prob_view_pos,
        "prob_view_duration_pos": prob_view_duration_pos,
        "prob_leave_pos": prob_leave_pos,
        "prob_leave_duration_pos": prob_leave_duration_pos,
        "prob_user_view_all": prob_user_view_all,
        "prob_user_view_pos": prob_user_view_pos,
        "num_item_view_duration_all": item_view_duration_all,
        "num_item_view_duration_pos": item_view_duration_pos,
    }


TEST_TYPES = [
    "total_random", "all_same", "prob_view_all", "prob_view_pos",
    "prob_view_pos_static", "prob_view_duration_pos", "prob_user_view_all",
    "prob_user_view_pos", "prob_user_view_pos_static",
    "num_item_view_duration_all", "num_item_view_duration_pos",
    "num_item_view_duration_pos_static",
]


def synthesize_scores(test_type: str, stats: Dict[str, object],
                      user_ids: np.ndarray, photo_ids: np.ndarray,
                      durations: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
    """Per-row (B, 40) score synthesis for a null predictor
    (reference main :186-283)."""
    B = len(user_ids)
    if test_type == "total_random":
        return rng.random((B, L))
    if test_type == "all_same":
        return np.ones((B, L))
    if test_type == "prob_view_all":
        return rng.binomial(1, stats["prob_view_all"],
                            size=(B, L)).astype(np.float64)
    if test_type == "prob_view_pos":
        return rng.binomial(1, np.tile(stats["prob_view_pos"], (B, 1))
                            ).astype(np.float64)
    if test_type == "prob_view_pos_static":
        return np.tile(stats["prob_view_pos"], (B, 1))
    if test_type == "prob_view_duration_pos":
        probs = stats["prob_view_duration_pos"][
            np.clip(durations - 1, 0, L - 1)]
        return rng.binomial(1, probs).astype(np.float64)
    if test_type == "prob_user_view_all":
        table = stats["prob_user_view_all"]
        probs = np.array([table.get(int(u), stats["prob_view_all"])
                          for u in user_ids])[:, None] * np.ones((1, L))
        return rng.binomial(1, probs).astype(np.float64)
    if test_type in ("prob_user_view_pos", "prob_user_view_pos_static"):
        table = stats["prob_user_view_pos"]
        probs = np.stack([np.asarray(table.get(int(u),
                                               stats["prob_view_pos"]))
                          for u in user_ids])
        if test_type.endswith("static"):
            return probs
        return rng.binomial(1, probs).astype(np.float64)
    if test_type == "num_item_view_duration_all":
        table = stats["num_item_view_duration_all"]
        probs = np.zeros((B, L))
        for i, p in enumerate(photo_ids):
            entry = table.get(int(p))
            if entry is None:
                probs[i, :] = stats["prob_view_all"]
            elif entry[1] == 0:
                probs[i, :] = 0.0
            else:
                probs[i, :] = entry[0] / entry[1]
        return rng.binomial(1, probs).astype(np.float64)
    if test_type in ("num_item_view_duration_pos",
                     "num_item_view_duration_pos_static"):
        table = stats["num_item_view_duration_pos"]
        probs = np.zeros((B, L))
        for i, p in enumerate(photo_ids):
            entry = table.get(int(p))
            if entry is None:
                probs[i, :] = stats["prob_view_pos"]
            else:
                viewed, cases = entry
                probs[i, :] = viewed / max(cases, 1)
        if test_type.endswith("static"):
            return probs
        return rng.binomial(1, probs).astype(np.float64)
    raise ValueError(f"unknown test_type {test_type}")
