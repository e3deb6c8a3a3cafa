"""The port's copy of the numpy metrics
(segmminterest_tpu_torch/engine/evaluation.py) against the JAX package's
``engine/evaluation.py`` on the same arrays and the same ``default_rng``
seed: ``main_eval_batch`` (TOP_K with and without mask and permutation,
JaccardSim, ProbAUC, LeaveMSE, LeaveCTR, the watch-time accumulators) and
``compute_final_result(_watchtime)``. Both are numpy, so the results must
be equal, not close."""

import numpy as np
import pytest

from segmminterest_tpu.engine import evaluation as J
from segmminterest_tpu_torch.engine import evaluation as P

EVAL_TYPES = ["JaccardSim", "LeaveMSE", "LeaveCTR", "LeaveCTR_view", "TOP_K",
              "ProbAUC"]


def _batches(seed, n=3, B=20, L=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = np.full((B, L), -2, np.int64)
        for i in range(B):
            dur = rng.integers(2, L + 1)
            vl = rng.integers(0, dur)
            gt[i, :dur] = -1
            gt[i, :vl] = 1
            gt[i, vl] = 0
        gt[0, :] = 1  # a complete max-length view
        interests = rng.uniform(0.01, 0.99, size=(B, L))
        interests[1, :5] = 0.5  # ties, broken by the permutation
        logits = rng.normal(size=(B, L))
        out.append((interests, gt, logits))
    return out


def _run(mod, top_k_mask, permutation, watchtime):
    results = mod.make_results_list(EVAL_TYPES)
    if watchtime:
        for k in ("duration_lengths", "TOP1MSE", "MAES", "pred_leave"):
            results[k] = []
    rng = np.random.default_rng(9)
    for interests, gt, logits in _batches(1):
        mod.main_eval_batch(interests, gt, results, top_k_mask=top_k_mask,
                            top_k_permutation=permutation,
                            logits=logits if watchtime else None, rng=rng)
    if watchtime:
        return results, mod.compute_final_result_watchtime(
            results, len(results["view_lengths"]))
    return results, mod.compute_final_result(results)


# (top_k_mask, permutation, watchtime); the watch-time task ranks without
# the mask (its TOP1MSE comes from top_k_leave)
CASES = [(False, True, False), (False, False, False), (True, True, False),
         (True, False, False), (False, True, True), (False, False, True)]


@pytest.mark.parametrize("top_k_mask,permutation,watchtime", CASES)
def test_metrics_equal_jax(top_k_mask, permutation, watchtime):
    want_acc, want = _run(J, top_k_mask, permutation, watchtime)
    got_acc, got = _run(P, top_k_mask, permutation, watchtime)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert got_acc.keys() == want_acc.keys()
    assert "HR@5" in got and "ProbAUC" in got


def test_auc_matches_rank_formula_with_ties():
    labels = np.array([0, 1, 1, 0, 1, 0, 0, 1])
    scores = np.array([0.1, 0.4, 0.4, 0.4, 0.9, 0.2, 0.7, 0.3])
    assert P._auc_score(labels, scores) == J._auc_score(labels, scores)
    # pairs (pos > neg) + half the ties over n_pos * n_neg
    pos, neg = scores[labels == 1], scores[labels == 0]
    want = ((pos[:, None] > neg[None]).sum()
            + 0.5 * (pos[:, None] == neg[None]).sum()) / (len(pos) * len(neg))
    assert P._auc_score(labels, scores) == pytest.approx(want)


def test_draw_hotmap_writes_a_figure(tmp_path):
    path = P.draw_hotmap(np.linspace(0, 1, 40), np.ones(40), "u-v",
                         str(tmp_path))
    assert path is None or (tmp_path / "u-v.png").exists()
